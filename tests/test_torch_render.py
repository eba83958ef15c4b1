"""Rendering in regennet_torch against the JAX package's, on the CPU.

- render_frames and plot_3d_motion: the same matplotlib frames as
  regennet_tpu.render's (the frames taken where the video is written).
- The PyTorch rasterizer against regennet_tpu.render.rasterizer at 32x32
  and 64x64 on tests/test_rasterizer_oracle.py's cases (a single triangle,
  overlapping depths, both windings with a degenerate face, a random soup
  in chunks of 16, an off-centre camera on black): the same uint8 frame
  except at most 0.5% of the pixels, each of them on an edge of the JAX
  frame (its colour differs from a 4-neighbour's); and a two-person mesh
  sequence of the synthetic SMPL-X model through render_mesh_sequence.
- write_video writes its gif fallback where no FFmpeg writer is present.
"""

import os

import numpy as np
import pytest
import torch

from regennet_tpu.ops import body_model as jbm
from regennet_tpu.render import plot_script as jplot
from regennet_tpu.render import rasterizer as jraster
from regennet_tpu.render import renderer as jrenderer
from regennet_torch.data.humanml.motion_process import T2M_KINEMATIC_CHAIN
from regennet_torch.ops import body_model as bm
from regennet_torch.render import plot_script, rasterizer, renderer


def _edge_pixels(img):
    """Pixels whose colour differs from one of their 4-neighbours'."""
    edge = np.zeros(img.shape[:2], bool)
    for axis in (0, 1):
        step = np.any(np.diff(img.astype(int), axis=axis) != 0, axis=-1)
        lo = [slice(None)] * 2
        hi = [slice(None)] * 2
        lo[axis], hi[axis] = slice(0, -1), slice(1, None)
        edge[tuple(lo)] |= step
        edge[tuple(hi)] |= step
    return edge


def hold_frame(ours, ref, max_share=0.005):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype == np.uint8
    differ = np.any(ours != ref, axis=-1)
    assert differ.mean() <= max_share, f"{differ.mean():.3%} of the pixels differ"
    assert not (differ & ~_edge_pixels(ref)).any(), "a pixel off the edges differs"


ORACLE_CASES = {
    "single triangle": ([[-0.5, -0.5, 0.0], [0.6, -0.4, 0.0], [0.0, 0.7, 0.0]], [[0, 1, 2]],
                        [[1.0, 0.2, 0.2]], {}),
    "overlapping depth": ([[-0.8, -0.8, 0.5], [0.8, -0.8, 0.5], [0.0, 0.8, 0.5],
                           [-0.8, -0.6, -0.5], [0.8, -0.6, -0.5], [0.0, 0.9, -0.5]],
                          [[3, 4, 5], [0, 1, 2]], [[0.2, 0.2, 1.0], [1.0, 0.2, 0.2]], {}),
    "tetrahedron": ([[0.0, 0.6, 0.1], [-0.6, -0.4, 0.3], [0.6, -0.4, 0.3], [0.0, 0.0, -0.6]],
                    [[0, 1, 2], [0, 3, 1], [0, 2, 3], [1, 3, 2], [1, 1, 2]],
                    [[0.3, 0.8, 0.4]] * 5, {}),
    "tetrahedron, flipped": ([[0.0, 0.6, 0.1], [-0.6, -0.4, 0.3], [0.6, -0.4, 0.3],
                              [0.0, 0.0, -0.6]],
                             [[2, 1, 0], [1, 3, 0], [3, 2, 0], [2, 3, 1], [2, 1, 1]],
                             [[0.3, 0.8, 0.4]] * 5, {}),
    "random soup": (np.random.default_rng(7).uniform(-0.9, 0.9, size=(30, 3)),
                    np.random.default_rng(8).integers(0, 30, size=(40, 3)),
                    np.random.default_rng(9).uniform(0.1, 1.0, size=(40, 3)), {"chunk": 16}),
    "off-centre camera": ([[-0.2, -0.2, 0.0], [0.9, -0.1, 0.0], [0.3, 0.8, 0.0]], [[0, 1, 2]],
                          [[0.9, 0.9, 0.1]], {"cam": (1.4, 1.4, -0.2, 0.15),
                                              "bg_color": (0.0, 0.0, 0.0)}),
}


@pytest.mark.parametrize("size", [32, 64])
@pytest.mark.parametrize("case", list(ORACLE_CASES))
def test_rasterizer_matches_jax(case, size):
    verts, faces, colors, kw = ORACLE_CASES[case]
    verts = np.asarray(verts, np.float32)
    faces, colors = np.asarray(faces, np.int32), np.asarray(colors, np.float32)
    ref = jraster.rasterize_mesh(verts, faces, colors, resolution=(size, size), **kw)
    ours = rasterizer.rasterize_mesh(torch.tensor(verts), faces, colors,
                                     resolution=(size, size), **kw)
    assert ours.device.type == "cpu"
    hold_frame(ours.numpy(), ref)
    assert (ref != ref[0, 0]).any()  # something was drawn


def test_mesh_sequence_matches_jax():
    """Two persons of the synthetic SMPL-X mesh, 3 frames at 64x64: the
    fitted camera and every frame."""
    model = bm.synthetic("smplx")
    rng = np.random.default_rng(3)
    V = model.num_vertices
    base = model.v_template.numpy()
    verts = np.stack([base + [0.6 * p, 0.0, 0.1 * p] for p in range(2)])[..., None]
    verts = (verts + rng.normal(scale=0.02, size=(2, V, 3, 3))).astype(np.float32)
    flipped = np.stack([verts[:, :, 0], -verts[:, :, 1], -verts[:, :, 2]], axis=2)
    assert rasterizer.fit_weak_perspective(np.transpose(flipped, (0, 1, 3, 2))) == \
        jraster.fit_weak_perspective(np.transpose(flipped, (0, 1, 3, 2)))
    faces = np.asarray(jbm.synthetic("smplx").faces)
    np.testing.assert_array_equal(model.faces, faces)
    ref = jraster.render_mesh_sequence(verts, faces, resolution=(64, 64))
    ours = renderer.render_mesh_frames(torch.tensor(verts), model.faces, resolution=(64, 64))
    assert len(ours) == len(ref) == 3
    for o, r in zip(ours, ref):
        hold_frame(o, r)


def _capture(monkeypatch, module):
    frames = []

    def keep(f, path, fps=20):
        frames.extend(f)
        return path

    monkeypatch.setattr(module, "write_video", keep)
    return frames


def test_plot_3d_motion_frames_match_jax(monkeypatch, tmp_path):
    joints = np.cumsum(np.random.default_rng(4).normal(scale=0.05, size=(4, 22, 3)), 0)
    ours, ref = _capture(monkeypatch, plot_script), _capture(monkeypatch, jplot)
    for module, frames in ((plot_script, ours), (jplot, ref)):
        path = module.plot_3d_motion(str(tmp_path / "a.mp4"), T2M_KINEMATIC_CHAIN, joints,
                                     title="a person walks forward and waves",
                                     vis_mode="upper_body", gt_frames=[1])
        assert path.endswith("a.mp4")
    assert len(ours) == len(ref) == 4
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o, r)
    assert plot_script.list_cut_average([1.0, 2.0, 3.0, 5.0, 9.0], 2) == \
        jplot.list_cut_average([1.0, 2.0, 3.0, 5.0, 9.0], 2)


@pytest.mark.parametrize("K", [24, 55])
def test_render_frames_match_jax(K):
    joints = np.random.default_rng(5).normal(size=(2, K, 3, 3)).astype(np.float32)
    ours = renderer.render_frames(joints, title="pair")
    ref = jrenderer.render_frames(joints, title="pair")
    assert len(ours) == 3
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o, r)


def test_write_video_falls_back_to_gif(tmp_path):
    import imageio

    frames = [np.full((16, 16, 3), 40 * i, np.uint8) for i in range(3)]
    path = renderer.write_video(frames, str(tmp_path / "clip.mp4"), fps=10)
    try:
        import imageio_ffmpeg  # noqa: F401
        assert path.endswith(".mp4")
    except ImportError:
        assert path == str(tmp_path / "clip.gif")
    assert os.path.exists(path) and len(imageio.mimread(path)) == 3
    gif = renderer.write_video(frames, str(tmp_path / "b.gif"))
    assert gif.endswith("b.gif") and len(imageio.mimread(gif)) == 3
