"""The port's cgenerate CLI end to end on the CPU, and against the JAX CLI.

Synthetic h5 data -> regennet_torch.sample.cgenerate.main(args,
device="cpu") -> results.npy, mirroring tests/test_e2e_sample.py. The
comparison runs the JAX CLI first, carries its random-init weights to the
port as a reference-layout .pt file, and feeds the port's sampler the JAX
CLI's noise stream. Tolerance 1e-4 (f32, a 5-step sampler through a
2-layer model).
"""

import os
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regennet_tpu.data import synthetic as jsynthetic
from regennet_tpu.sample import cgenerate as jcgenerate
from regennet_tpu.utils.model_util import create_model_and_diffusion as jcreate
from regennet_tpu.utils.rng import sampling_key
from regennet_torch.convert.from_flax import cmdm_state_dict_from_flax
from regennet_torch.data import synthetic
from regennet_torch.sample import cgenerate

ATOL = 1e-4


def _args(tmp_path, data_path, **overrides):
    base = dict(
        seed=10, batch_size=4, use_ddim=False, timestep_respacing="ddim5",
        noise_schedule="cosine", diffusion_steps=1000, sigma_small=True,
        setting="cmdm", arch="online", emb_trans_dec=False, wo_pos_emb=False,
        cm_mode="concat", layers=2, latent_dim=32, cond_mask_prob=0.1,
        lambda_rcxyz=0.0, lambda_vel=0.0, lambda_fc=0.0, lambda_orient=1.0,
        lambda_body=1.0, lambda_transl=1.0, unconstrained=False,
        dataset="chi3d", data_dir="", num_person=2, data_path=data_path,
        pose_rep="rot6d", body_model="smplx", vel_threshold=0.01,
        shuffle=False, model_path="random",
        output_dir=str(tmp_path / "out"), num_samples=4, num_repetitions=2,
        guidance_param=1.0, motion_length=60, input_text="", action_file="",
        text_prompt="", action_name="", num_frames=24, activation="gelu",
    )
    base.update(overrides)
    return Namespace(**base)


@pytest.fixture(scope="module")
def data_path(tmp_path_factory):
    return synthetic.make_dataset_pair(
        str(tmp_path_factory.mktemp("cgen")), "chi3d", num_clips=10
    )


def _load(npy_path):
    return np.load(npy_path, allow_pickle=True).item()


def test_cgenerate_end_to_end_on_cpu(tmp_path, data_path):
    times = []
    npy_path = cgenerate.main(_args(tmp_path, data_path), device="cpu",
                              generate_ms=times)
    results = _load(npy_path)
    assert set(results) == {"motion", "output", "cmotion", "text", "lengths",
                            "num_samples", "num_repetitions"}
    assert results["output"].shape == (8, 56, 6, 24)
    assert results["cmotion"].shape == (8, 56, 6, 24)
    assert results["motion"].shape == (8, 55, 3, 24)  # decoded joints
    assert results["lengths"].shape == (8,)
    assert len(results["text"]) == 8 and len(times) == 2
    assert np.isfinite(results["output"]).all()
    assert np.isfinite(results["motion"]).all()
    assert os.path.exists(npy_path.replace(".npy", "_len.txt"))


def test_cgenerate_action_names_and_cfg_ddim(tmp_path, data_path):
    args = _args(tmp_path, data_path, action_name="Hug,Kick,Hug",
                 num_repetitions=1, use_ddim=True, guidance_param=2.5)
    results = _load(cgenerate.main(args, device="cpu"))
    assert results["output"].shape == (3, 56, 6, 24)
    assert results["text"] == ["Hug", "Kick", "Hug"]
    with pytest.raises(ValueError, match="unknown action"):
        cgenerate.main(_args(tmp_path, data_path, action_name="Moonwalk",
                             num_repetitions=1), device="cpu")


def test_cgenerate_reads_in_memory_clips(tmp_path):
    """A Feeder over a dict of clips (no h5 file) drives the same CLI."""
    from regennet_torch.data.feeder import Feeder

    data = Feeder(clips=synthetic.make_clips("chi3d", "test", num_clips=8,
                                             min_len=30, max_len=60),
                  dataname="chi3d", split="test", num_frames=24, num_person=2)
    args = _args(tmp_path, "", num_repetitions=1, timestep_respacing="3")
    results = _load(cgenerate.main(args, device="cpu", data=data))
    assert results["output"].shape == (4, 56, 6, 24)
    assert np.isfinite(results["motion"]).all()


def test_cli_arguments_load_from_args_json(tmp_path):
    """`cgenerate_args`: the model and diffusion groups come from the
    args.json beside --model_path, overriding the command line."""
    import json

    from regennet_torch.utils import parser_util

    (tmp_path / "args.json").write_text(json.dumps(
        {"arch": "online", "layers": 3, "latent_dim": 48, "cm_mode": "concat",
         "setting": "cmdm", "cond_mask_prob": 0.0, "diffusion_steps": 100}))
    args = parser_util.cgenerate_args([
        "--model_path", str(tmp_path / "model000000001.pt"), "--dataset", "ntu",
        "--layers", "8", "--guidance_param", "2.5", "--compute_dtype", "bfloat16",
    ])
    assert (args.arch, args.layers, args.latent_dim) == ("online", 3, 48)
    assert args.diffusion_steps == 100 and args.dataset == "ntu"
    assert args.guidance_param == 1  # no condition dropout: no CFG
    assert args.compute_dtype == "bfloat16"
    with pytest.raises(FileNotFoundError, match="args.json"):
        parser_util.cgenerate_args(["--model_path", str(tmp_path / "x" / "m.pt")])


def _replicate_cli_noise(seed, shape, num_steps, reps):
    """The JAX CLI's stream: a per-repetition key split from
    sampling_key(seed), then the loop's init noise and one z per step."""
    rng = sampling_key(seed)
    streams = []
    for _ in range(reps):
        rng, step_rng = jax.random.split(rng)
        loop_rng, init_rng = jax.random.split(step_rng)
        x0 = np.asarray(jax.random.normal(init_rng, shape, dtype=jnp.float32))
        zs = []
        for _ in range(num_steps):
            loop_rng, z_rng = jax.random.split(loop_rng)
            zs.append(np.asarray(jax.random.normal(z_rng, shape, dtype=jnp.float32)))
        streams.append((x0, zs))
    return streams


@pytest.mark.parametrize("use_ddim,guidance", [(False, 1.0), (True, 2.5)])
def test_cgenerate_matches_jax_cli(tmp_path, data_path, monkeypatch,
                                   use_ddim, guidance):
    monkeypatch.setenv("REGENNET_PALLAS_ATTN", "1")
    jargs = _args(tmp_path / "jax", data_path, use_ddim=use_ddim,
                  guidance_param=guidance)
    ref = _load(jcgenerate.main(jargs))

    # the JAX CLI's random-init weights, as a reference-layout .pt file
    data = jcgenerate.load_dataset(jargs)
    model, _, _ = jcreate(jargs, data)
    shape = (jargs.num_samples, 56, 6, jargs.num_frames)
    example = (np.zeros(shape, np.float32),
               {"y": {"cmotion": np.zeros(shape, np.float32),
                      "action": np.zeros((shape[0], 1), np.int64)}})
    params = jcgenerate.init_or_load_params(jargs, model, example)
    sd = cmdm_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params))
    ckpt = tmp_path / "model000000000.pt"
    torch.save({k: torch.tensor(v) for k, v in sd.items()}, ckpt)

    streams = iter(_replicate_cli_noise(jargs.seed, shape, 5, 2))
    loop_name = "ddim_sample_loop" if use_ddim else "p_sample_loop"
    loop = getattr(cgenerate.sampling, loop_name)

    def fed_loop(*a, generator=None, **kw):
        x0, zs = next(streams)
        return loop(*a, noise=torch.tensor(x0),
                    step_noise=[torch.tensor(z) for z in zs], **kw)

    monkeypatch.setattr(cgenerate.sampling, loop_name, fed_loop)
    args = _args(tmp_path / "torch", data_path, use_ddim=use_ddim,
                 guidance_param=guidance, model_path=str(ckpt))
    ours = _load(cgenerate.main(args, device="cpu"))

    np.testing.assert_array_equal(ours["cmotion"], ref["cmotion"])
    assert ours["text"] == ref["text"]
    np.testing.assert_array_equal(ours["lengths"], ref["lengths"])
    np.testing.assert_allclose(ours["output"], ref["output"], rtol=0, atol=ATOL)
    np.testing.assert_allclose(ours["motion"], ref["motion"], rtol=0, atol=ATOL)


def test_synthetic_clips_match_jax_generator(tmp_path):
    import h5py

    path = jsynthetic.write_dataset(str(tmp_path / "ntu_x.h5"), "ntu", "test",
                                    num_clips=5)
    ours = synthetic.make_clips("ntu", "test", num_clips=5)
    with h5py.File(path, "r") as f:
        assert sorted(f.keys()) == sorted(ours)
        for k in ours:
            np.testing.assert_array_equal(f[k][:], ours[k])
