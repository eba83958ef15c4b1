"""Motion editing and the Predictor of regennet_torch against the JAX
package, on the CPU.

- The inpainting hook of diffusion.gaussian.p_mean_variance in the DDPM
  and DDIM loops against regennet_tpu.diffusion.sampling, on an analytic
  denoiser, the JAX loops' noise fed in; the kept entries come out as the
  inpainted motion.
- build_inpainting_cond in both modes for the rot6d, xyz and hml_vec reps.
- edit.main end to end against the JAX edit CLI: a tiny online CMDM on
  synthetic Chi3D (in_between DDPM, upper_body DDIM) and a tiny text CMDM
  on synthetic HumanML3D (upper_body on hml_vec features, CFG 2.5; and
  with no text, guidance 0). The JAX CLI's random-init weights go to the
  port as a reference-layout .pt; the port's sampler takes the JAX CLI's
  noise stream. No CLIP weights: both sides take the hashed stand-in.
- Predictor against the JAX Predictor on one .pt and the JAX stream; two
  predict calls with one seed are bit-identical.
f32, within 1e-5 x max(1, max|jax|).
"""

import json
import os
from argparse import Namespace
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regennet_tpu.diffusion import DiffusionConfig as JConfig
from regennet_tpu.diffusion import make_schedule as jmake_schedule
from regennet_tpu.diffusion import sampling as jsampling
from regennet_tpu.models import clip_text as jclip_text
from regennet_tpu.sample import cgenerate as jcgenerate
from regennet_tpu.sample import edit as jedit
from regennet_tpu.sample import predict as jpredict
from regennet_tpu.utils.model_util import create_model_and_diffusion as jcreate
from regennet_tpu.utils.rng import sampling_key
from regennet_torch.convert.from_flax import cmdm_state_dict_from_flax
from regennet_torch.data import synthetic
from regennet_torch.data.humanml.dataset import write_synthetic_humanml
from regennet_torch.diffusion import DiffusionConfig, make_schedule, sampling
from regennet_torch.models import clip_text
from regennet_torch.sample import edit, predict
from regennet_torch.utils import parser_util

SHAPE = (2, 5, 3, 8)


def close(ours, ref, what=""):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    tol = 1e-5 * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(ours - ref).max())
    assert err <= tol, (what, err, tol)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _no_clip(*args, **kwargs):
    raise RuntimeError("CLIP text weights are not available locally")


@pytest.fixture(scope="module", autouse=True)
def without_clip():
    """Both packages' CLIP probes fail as they do without local weights."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(clip_text, "ClipTextEncoder", _no_clip)
        mp.setattr(jclip_text, "ClipTextEncoder", _no_clip)
        yield


def _loop_noise(key, shape, num_steps):
    """The JAX loops' stream: the initial x, then one z per step."""
    rng, init_rng = jax.random.split(key)
    x0 = torch.tensor(np.asarray(jax.random.normal(init_rng, shape, dtype=jnp.float32)))
    zs = []
    for _ in range(num_steps):
        rng, step_rng = jax.random.split(rng)
        zs.append(torch.tensor(np.asarray(jax.random.normal(step_rng, shape,
                                                            dtype=jnp.float32))))
    return x0, zs


def _inpainting(seed=0):
    rng = np.random.default_rng(seed)
    motion = rng.normal(size=SHAPE).astype(np.float32)
    mask = rng.random(SHAPE) < 0.4
    return motion, mask


@pytest.mark.parametrize("loop,respacing", [("p_sample_loop", "10"),
                                            ("ddim_sample_loop", "ddim10")])
def test_inpainting_hook_matches_jax(loop, respacing):
    motion, mask = _inpainting()
    c = np.random.default_rng(1).normal(size=SHAPE).astype(np.float32)

    def jfn(x, t, cond):
        return jnp.tanh(0.5 * x + 1e-3 * t[:, None, None, None]) + 0.1 * cond["c"]

    def fn(x, t, cond):
        return torch.tanh(0.5 * x + 1e-3 * t[:, None, None, None]) + 0.1 * cond["c"]

    jcond = {"c": jnp.asarray(c), "inpainted_motion": jnp.asarray(motion),
             "inpainting_mask": jnp.asarray(mask)}
    cond = {"c": torch.tensor(c), "inpainted_motion": torch.tensor(motion),
            "inpainting_mask": torch.tensor(mask)}
    key = jax.random.PRNGKey(4)
    ref = np.asarray(getattr(jsampling, loop)(
        jmake_schedule("cosine", 1000, timestep_respacing=respacing), JConfig(), jfn, SHAPE,
        key, jcond, clip_denoised=True))
    sched = make_schedule("cosine", 1000, timestep_respacing=respacing)
    x0, zs = _loop_noise(key, SHAPE, sched.num_timesteps)
    ours = getattr(sampling, loop)(sched, DiffusionConfig(), fn, SHAPE, cond,
                                   clip_denoised=True, noise=x0, step_noise=zs).numpy()
    close(ours, ref, loop)
    # the last step's x_0 prediction is the inpainted motion where kept,
    # and the sample is that prediction (clamped to [-1, 1] here)
    np.testing.assert_allclose(ours[mask], np.clip(motion, -1, 1)[mask], rtol=0, atol=1e-6)
    assert np.abs(ours[~mask] - np.clip(motion, -1, 1)[~mask]).max() > 0.1


@pytest.mark.parametrize("mode", ["in_between", "upper_body"])
@pytest.mark.parametrize("data_rep,J,F", [("rot6d", 56, 6), ("xyz", 25, 3),
                                          ("hml_vec", 263, 1)])
def test_build_inpainting_cond_matches_jax(mode, data_rep, J, F):
    motion = np.random.default_rng(2).normal(size=(3, J, F, 20)).astype(np.float32)
    lengths = np.asarray([20, 13, 7])
    for lens in (None, lengths):
        ref = jedit.build_inpainting_cond(motion, mode, 0.25, 0.75, data_rep, lens)
        ours = edit.build_inpainting_cond(motion, mode, 0.25, 0.75, data_rep, lens)
        np.testing.assert_array_equal(ours["inpainting_mask"],
                                      np.asarray(ref["inpainting_mask"]))
        np.testing.assert_array_equal(ours["inpainted_motion"],
                                      np.asarray(ref["inpainted_motion"]))
        assert 0 < ours["inpainting_mask"].mean() < 1
    with pytest.raises(ValueError, match="unknown edit mode"):
        edit.build_inpainting_cond(motion, "lower_body", 0.25, 0.75)


def test_edit_options_parse_as_jax():
    argv = ["--model_path", "m.pt", "--edit_mode", "upper_body", "--text_condition", "hi",
            "--prefix_end", "0.1", "--suffix_start", "0.9"]
    p = parser_util.ArgumentParser()
    parser_util.add_edit_options(p)
    ours = vars(p.parse_known_args(argv)[0])
    from regennet_tpu.utils import parser_util as jparser_util

    jp = jparser_util.ArgumentParser()
    jparser_util.add_edit_options(jp)
    assert ours == vars(jp.parse_known_args(argv)[0])
    assert parser_util.generate_args(["--model_path", "m", "--data_path", "d"]).render


def _args(tmp_path, **overrides):
    base = dict(
        seed=3, batch_size=4, use_ddim=False, timestep_respacing="", noise_schedule="cosine",
        diffusion_steps=8, sigma_small=True, setting="cmdm", arch="online",
        emb_trans_dec=False, wo_pos_emb=False, cm_mode="concat", layers=2, latent_dim=32,
        cond_mask_prob=0.1, lambda_rcxyz=0.0, lambda_vel=0.0, lambda_fc=0.0,
        lambda_orient=1.0, lambda_body=1.0, lambda_transl=1.0, unconstrained=False,
        dataset="chi3d", data_dir="", num_person=2, pose_rep="rot6d", body_model="smplx",
        vel_threshold=0.01, shuffle=False, model_path="random", output_dir=str(tmp_path),
        num_samples=3, num_repetitions=1, guidance_param=1.0, num_frames=16,
        activation="gelu", edit_mode="in_between", text_condition="", prefix_end=0.25,
        suffix_start=0.75,
    )
    base.update(overrides)
    return Namespace(**base)


@pytest.fixture(scope="module")
def chi3d_path(tmp_path_factory):
    return synthetic.make_dataset_pair(str(tmp_path_factory.mktemp("edit")), "chi3d",
                                       num_clips=6)


@pytest.fixture(scope="module")
def humanml_path(tmp_path_factory):
    return write_synthetic_humanml(str(tmp_path_factory.mktemp("hml")), num_clips=6,
                                   min_len=40, max_len=100)


def _jax_weights_as_pt(jargs, motion, cond_y, path):
    """The JAX CLI's random-init weights (init_or_load_params on the same
    shapes and seed) as a reference-layout .pt file."""
    data = jcgenerate.load_dataset(jargs)
    model, _, _ = jcreate(jargs, data)
    params = jcgenerate.init_or_load_params(jargs, model, (motion, {"y": cond_y}))
    sd = cmdm_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params))
    torch.save({k: torch.tensor(v) for k, v in sd.items()}, path)
    return str(path)


def _run_both(tmp_path, monkeypatch, **overrides):
    monkeypatch.setenv("REGENNET_PALLAS_ATTN", "0")
    jargs = _args(tmp_path / "jax", **overrides)
    ref = np.load(jedit.main(jargs), allow_pickle=True).item()
    motion = ref["input_motion"]
    cond_y = {"cmotion": ref["cmotion"], "action": np.zeros((motion.shape[0], 1), np.int64)}
    if jargs.dataset == "humanml":
        cond_y["text_emb"] = clip_text.hashed_text_embeddings(ref["text"])
    pt = _jax_weights_as_pt(_args(tmp_path / "w", **overrides), motion, cond_y,
                            tmp_path / "model000000000.pt")
    steps = make_schedule("cosine", jargs.diffusion_steps,
                          timestep_respacing=jargs.timestep_respacing).num_timesteps
    x0, zs = _loop_noise(sampling_key(jargs.seed), motion.shape, steps)
    loop = "ddim_sample_loop" if jargs.use_ddim else "p_sample_loop"
    monkeypatch.setattr(sampling, loop, partial(getattr(sampling, loop), noise=x0,
                                                step_noise=zs))
    args = _args(tmp_path / "torch", **{**overrides, "model_path": pt})
    ours = np.load(edit.main(args, device="cpu"), allow_pickle=True).item()
    assert set(ours) == set(ref) == {"motion", "output", "cmotion", "input_motion",
                                     "inpainting_mask", "text", "lengths", "edit_mode"}
    for key in ("cmotion", "input_motion", "inpainting_mask", "lengths"):
        np.testing.assert_array_equal(ours[key], np.asarray(ref[key]), err_msg=key)
    assert ours["text"] == ref["text"] and ours["edit_mode"] == ref["edit_mode"]
    close(ours["output"], ref["output"], "output")
    mask = ours["inpainting_mask"]
    # the kept entries are the input motion's (the last posterior mean is
    # the x_0 prediction there)
    close(ours["output"][mask], ours["input_motion"][mask], "kept entries")
    return ours, args


@pytest.mark.parametrize("mode,ddim", [("in_between", False), ("upper_body", True)])
def test_edit_cli_matches_jax_on_an_online_cmdm(tmp_path, monkeypatch, chi3d_path, mode,
                                                ddim):
    ours, args = _run_both(tmp_path, monkeypatch, data_path=chi3d_path, edit_mode=mode,
                           use_ddim=ddim, timestep_respacing="ddim4" if ddim else "")
    assert ours["output"].shape == (3, 56, 6, 16)
    assert os.path.basename(os.path.dirname(edit.main(_args(
        tmp_path / "x", data_path=chi3d_path, edit_mode=mode, output_dir="",
        model_path=args.model_path), device="cpu"))) == f"edit_{mode}_seed3"


@pytest.mark.parametrize("text", ["a person jumps", ""])
def test_edit_cli_matches_jax_on_a_text_cmdm(tmp_path, monkeypatch, humanml_path, text):
    ours, args = _run_both(tmp_path, monkeypatch, data_path=humanml_path, dataset="humanml",
                           setting="mdm", arch="trans_enc", num_person=1, body_model="smpl",
                           edit_mode="upper_body", text_condition=text, guidance_param=2.5)
    assert ours["output"].shape == (3, 263, 1, 196)
    assert ours["text"] == [text] * 3
    assert args.guidance_param == (0.0 if text == "" else 2.5)


def test_predictor_matches_jax_and_repeats(tmp_path, monkeypatch, chi3d_path):
    monkeypatch.setenv("REGENNET_PALLAS_ATTN", "0")
    jargs = _args(tmp_path / "w", data_path=chi3d_path, timestep_respacing="ddim4")
    shape = (2, 56, 6, 150)  # chi3d's window
    example = (np.zeros(shape, np.float32), {"y": {"cmotion": np.zeros(shape, np.float32),
                                                   "action": np.zeros((2, 1), np.int64)}})
    run = tmp_path / "run"
    run.mkdir()
    pt = _jax_weights_as_pt(jargs, *example[0:1], example[1]["y"], run / "model000000000.pt")
    (run / "args.json").write_text(json.dumps(
        {k: v for k, v in vars(jargs).items() if k != "model_path"}))
    cmotion = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    action = np.asarray([[1], [6]])

    jp = jpredict.Predictor()
    jp.setup(pt, guidance_param=2.5, use_ddim=True)
    ref = jp.predict(cmotion, action, seed=7)

    ours = predict.Predictor()
    ours.setup(pt, guidance_param=2.5, use_ddim=True, device="cpu")
    assert ours.num_frames == 150 and ours.sched.num_timesteps == 4
    noise = _loop_noise(sampling_key(7), shape, 4)
    close(ours.predict(cmotion, action, noise=noise), ref, "predict")
    a, b = ours.predict(cmotion[:1], seed=1), ours.predict(cmotion[:1], seed=1)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, ours.predict(cmotion[:1], seed=2))
