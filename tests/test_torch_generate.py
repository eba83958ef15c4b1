"""regennet_torch.sample.generate (the diffusion route) against the JAX
package's generate CLI, end to end on one checkpoint.

The checkpoint comes from the port's own trainer: `train_mdm --dataset
humanml --device cpu` on synthetic HumanML (the default --arch trans_enc
at 2 layers and latent 64, 10 diffusion steps), whose .pt and args.json
the JAX CLI reads too (it converts the reference-layout state dict). No
CLIP weights are present, so both sides condition on the hashed text
embeddings (the CLIP probe is stubbed to fail at once, as it fails without
weights, so the HF route's transformers import is not paid here). The
port's sampler is fed the JAX loop's noise stream (the initial x and one
z per step, replicated as tests/test_torch_sampling.py does). results.npy holds the same keys, shapes, prompts and lengths;
`feature` and `motion` agree within 1e-5 x max(1, max|jax|). The comp_v6
route is held against the JAX CLI in tests/test_torch_eval_humanml.py.
"""

import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regennet_tpu.models import clip_text as jclip_text
from regennet_tpu.sample import generate as jgenerate
from regennet_torch.data.humanml.dataset import write_synthetic_humanml
from regennet_torch.diffusion import sampling
from regennet_torch.models import clip_text
from regennet_torch.sample import generate
from regennet_torch.train import train_mdm
from regennet_torch.utils import model_util, parser_util

STEPS = 10


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


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(checkpoint path, data root) of a 2-step humanml run of the port's CLI,
    from the CMDM's torch-default initialisation (model_util's random_init_
    left out). From the wider Flax initialisation that the CLI draws, the
    features agree within 0.2x their bound, but recover_from_ric's
    cumulative root rotation over 90 frames amplifies that difference about
    50 times in the JAX package's own recovery (3.7e-4 between its recovery
    of either package's features), 2.5x the motion bound."""
    root = write_synthetic_humanml(str(tmp_path_factory.mktemp("humanml")), num_clips=8,
                                   min_len=40, max_len=200)
    save_dir = tmp_path_factory.mktemp("run") / "humanml"
    args = parser_util.train_args([
        "--save_dir", str(save_dir), "--data_path", root, "--device", "cpu",
        "--layers", "2", "--latent_dim", "64", "--batch_size", "4", "--num_steps", "2",
        "--save_interval", "2", "--log_interval", "1", "--steps_per_call", "1",
        "--diffusion_steps", str(STEPS)])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(model_util, "random_init_", lambda model, generator: model)
        loop = train_mdm.main(args)
    assert loop.device == torch.device("cpu") and loop.state_step == 2
    assert loop.model.cond_mode == "text" and loop.model.arch == "trans_enc"
    saved = json.loads((save_dir / "args.json").read_text())
    assert (saved["dataset"], saved["setting"], saved["activation"]) == ("humanml", "mdm",
                                                                         "gelu")
    return str(save_dir / "model000000002.pt"), root


def _replicate_loop_noise(key, shape, num_steps):
    """The JAX loop's PRNG stream: the initial x, then one z per step."""
    rng, init_rng = jax.random.split(key)
    x0 = np.asarray(jax.random.normal(init_rng, shape, dtype=jnp.float32))
    zs = []
    for _ in range(num_steps):
        rng, step_rng = jax.random.split(rng)
        zs.append(torch.tensor(np.asarray(
            jax.random.normal(step_rng, shape, dtype=jnp.float32))))
    return torch.tensor(x0), zs


def test_diffusion_route_matches_jax(trained, tmp_path, monkeypatch):
    model_path, root = trained
    argv = ["--model_path", model_path, "--data_path", root,
            "--text_prompt", "a person walks forward", "--num_samples", "2",
            "--motion_length", "4.5", "--seed", "3"]
    ref = jgenerate.main(jgenerate.parse_args(
        argv + ["--output_dir", str(tmp_path / "jax"), "--no-render"]))

    x0, zs = _replicate_loop_noise(jax.random.PRNGKey(3), (2, 263, 1, 196), STEPS)
    monkeypatch.setattr(sampling, "p_sample_loop",
                        partial(sampling.p_sample_loop, noise=x0, step_noise=zs))
    out = str(tmp_path / "torch")
    ours = generate.main(parser_util.generate_args(argv + ["--output_dir", out,
                                                           "--no-render"]), device="cpu")
    saved = np.load(os.path.join(out, "results.npy"), allow_pickle=True).item()
    assert set(saved) == set(ours) == set(ref) == {"motion", "feature", "text", "lengths",
                                                    "num_samples"}
    assert saved["motion"].shape == ref["motion"].shape == (2, 90, 22, 3)
    assert saved["feature"].shape == ref["feature"].shape == (2, 90, 263)
    assert saved["text"] == ref["text"] == ["a person walks forward"] * 2
    np.testing.assert_array_equal(saved["lengths"], ref["lengths"])
    assert saved["lengths"].dtype == ref["lengths"].dtype
    assert saved["num_samples"] == ref["num_samples"] == 2
    for key in ("feature", "motion"):
        assert saved[key].dtype == np.float32
        np.testing.assert_allclose(saved[key], ref[key], rtol=0,
                                   atol=1e-5 * max(1.0, float(np.abs(ref[key]).max())))
    with open(os.path.join(out, "results.txt")) as f:
        assert f.read() == "\n".join(ref["text"])


def test_prompts_come_from_a_file_or_the_prompt(tmp_path):
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("a person walks\n\n  a person jumps  \n")
    for argv in (["--input_text", str(prompts)], ["--text_prompt", "hi", "--num_samples", "3"]):
        args = parser_util.generate_args(["--model_path", "m.pt", "--data_path", "d", *argv])
        jargs = jgenerate.parse_args(["--model_path", "m.pt", "--data_path", "d", *argv])
        assert generate._prompts(args) == jgenerate._prompts(jargs)
    with pytest.raises(ValueError, match="--text_prompt or --input_text"):
        generate._prompts(parser_util.generate_args(["--model_path", "m", "--data_path", "d"]))


@pytest.mark.parametrize("extra,what", [
    (["--length_estimator", "est.tar"], "length_estimator"),
    (["--render"], "render")])
def test_unported_routes_raise(trained, tmp_path, monkeypatch, extra, what):
    """Both routes, once unported, are ported. A missing length estimator
    fails before anything runs. --render (the default, as in the JAX CLI)
    draws each motion as a stick figure: its frames equal the JAX
    plot_3d_motion's of the same joints along the T2M chain."""
    if what == "length_estimator":
        args = parser_util.generate_args(["--model_path", str(tmp_path / "model.pt"),
                                          "--data_path", str(tmp_path), "--text_prompt",
                                          "hi", *extra])
        with pytest.raises(FileNotFoundError, match="est.tar"):
            generate.main(args, device="cpu")
        assert not os.listdir(tmp_path)  # nothing written
        return
    from regennet_tpu.data.humanml.motion_process import T2M_KINEMATIC_CHAIN
    from regennet_tpu.render import plot_script as jplot
    from regennet_torch.render import plot_script

    model_path, root = trained
    written = {}

    def keep(frames, path, fps=20):
        written[path] = (list(frames), fps)
        return path

    monkeypatch.setattr(plot_script, "write_video", keep)
    out = str(tmp_path / "out")
    args = parser_util.generate_args([
        "--model_path", model_path, "--data_path", root, "--text_prompt", "a person waves",
        "--num_samples", "2", "--motion_length", "0.2", "--output_dir", out, *extra])
    assert args.render and parser_util.generate_args(
        ["--model_path", "m", "--data_path", "d", "--no-render"]).render is False
    result = generate.main(args, device="cpu")
    assert sorted(written) == [os.path.join(out, f"sample{i:02d}.mp4") for i in range(2)]
    monkeypatch.setattr(jplot, "write_video", keep)
    for i in range(2):
        frames, fps = written.pop(os.path.join(out, f"sample{i:02d}.mp4"))
        jplot.plot_3d_motion(str(tmp_path / "jax.mp4"), T2M_KINEMATIC_CHAIN,
                             result["motion"][i], title="a person waves", dataset="humanml",
                             fps=20)
        ref, ref_fps = written.pop(str(tmp_path / "jax.mp4"))
        assert fps == ref_fps == 20 and len(frames) == len(ref) == 4
        for a, b in zip(frames, ref):
            np.testing.assert_array_equal(a, b)
