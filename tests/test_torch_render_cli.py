"""render/{rendermotion,crendermotion}.py of regennet_torch against the
JAX package's, on the CPU with the synthetic SMPL-X model: the clips each
CLI hands the renderer (stick figures and, for crendermotion
--jointstype vertices, meshes with the body model's faces), f32 within
1e-5 x max(1, max|jax|), and the videos they write.
"""

import os
from argparse import Namespace

import numpy as np
import pytest
import torch

from regennet_tpu.ops import body_model as jbm
from regennet_tpu.render import crendermotion as jcrender
from regennet_tpu.render import rendermotion as jrender
from regennet_torch.ops import body_model as bm
from regennet_torch.render import crendermotion, rendermotion
from tests.test_torch_actor_cvae import close


def _recorder(store):
    def render_video(joints, path, fps=20, title="", faces=None):
        store.append((os.path.basename(path), np.asarray(torch.as_tensor(joints).cpu()),
                      title, faces is not None))
        return path
    return render_video


def _grid(path):
    rng = np.random.default_rng(0)
    np.save(path, {"generation": (0.3 * rng.normal(size=(2, 3, 56, 12, 6))).astype(np.float32),
                   "durations": np.asarray([6, 4], np.int32),
                   "classes": np.arange(3, dtype=np.int32)}, allow_pickle=True)
    return path


@pytest.mark.parametrize("sigma,num_videos", [(0.0, -1), (1.5, 4)])
def test_rendermotion_matches_jax(tmp_path, monkeypatch, sigma, num_videos):
    npy = _grid(str(tmp_path / "generation.npy"))
    ours, ref = [], []
    monkeypatch.setattr(rendermotion, "render_video", _recorder(ours))
    monkeypatch.setattr(jrender, "render_video", _recorder(ref))
    kw = dict(data_path=npy, output_dir=str(tmp_path / "vids"), body_model="smplx",
              pose_rep="rot6d", num_person=2, jointstype=None, sigma=sigma, fps=10,
              num_videos=num_videos)
    paths = rendermotion.main(Namespace(**kw, device="cpu"))
    jrender.main(Namespace(**kw))
    assert len(paths) == len(ours) == len(ref) == (6 if num_videos < 0 else 4)
    for (name, joints, title, _), (jname, jjoints, jtitle, _) in zip(ours, ref):
        assert (name, title) == (jname, jtitle)
        close(joints, jjoints, what=name)
    assert ours[-1][1].shape[-1] == (4 if num_videos < 0 else 4)  # row 1's duration


def _results(path, n=2, T=6):
    rng = np.random.default_rng(1)
    np.save(path, {"output": (0.3 * rng.normal(size=(n, 56, 6, T))).astype(np.float32),
                   "cmotion": (0.3 * rng.normal(size=(n, 56, 6, T))).astype(np.float32),
                   "text": ["Hug", "Kick"], "lengths": np.asarray([T] * n)},
            allow_pickle=True)
    return path


@pytest.mark.parametrize("jointstype", [None, "vertices"])
def test_crendermotion_matches_jax(tmp_path, monkeypatch, jointstype):
    npy = _results(str(tmp_path / "results.npy"))
    results = np.load(npy, allow_pickle=True).item()
    kind = jointstype or "smplx"
    sample = crendermotion.get_sample(results, 1, bm.synthetic("smplx"), kind)
    close(sample, jcrender.get_sample(results, 1, jbm.synthetic("smplx"), kind), what="sample")
    ours, ref = [], []
    monkeypatch.setattr(crendermotion, "render_video", _recorder(ours))
    monkeypatch.setattr(jcrender, "render_video", _recorder(ref))
    kw = dict(data_path=npy, output_dir=str(tmp_path / "videos"), body_model="smplx",
              jointstype=jointstype, fps=5, num_videos=-1)
    crendermotion.main(Namespace(**kw, device="cpu"))
    jcrender.main(Namespace(**kw))
    assert len(ours) == len(ref) == 2
    for (name, joints, title, meshed), (jname, jjoints, jtitle, jmeshed) in zip(ours, ref):
        assert (name, title, meshed) == (jname, jtitle, jmeshed)
        assert meshed == (jointstype == "vertices")
        close(joints, jjoints, what=name)


def test_clis_write_videos(tmp_path):
    pytest.importorskip("matplotlib")
    pytest.importorskip("imageio")
    npy = _results(str(tmp_path / "results.npy"), n=1, T=3)
    for jointstype in (None, "vertices"):
        paths = crendermotion.main(Namespace(
            data_path=npy, output_dir=str(tmp_path / f"v_{jointstype}"), body_model="smplx",
            jointstype=jointstype, fps=5, num_videos=1, device="cpu"))
        assert len(paths) == 1 and os.path.getsize(paths[0]) > 0
    grid = _grid(str(tmp_path / "generation.npy"))
    paths = rendermotion.main(rendermotion.parse_args(
        ["--data_path", grid, "--num_videos", "1", "--fps", "5", "--device", "cpu"]))
    assert len(paths) == 1 and os.path.getsize(paths[0]) > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            rendermotion.main(rendermotion.parse_args(["--data_path", grid]))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            crendermotion.main(crendermotion.parse_args(["--data_path", npy]))
