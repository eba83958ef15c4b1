"""Offline motion rendering to video (counterpart of
regennet_tpu/render/renderer.py).

Skeletons (or vertex point clouds) are drawn with matplotlib's 3-D
projection (per-person colours, a fixed camera, equal-aspect framing) on
the host; meshes go through the PyTorch rasterizer (render/rasterizer.py)
on the device of the vertices. Videos are written by imageio, as mp4, or
as a gif where no FFmpeg writer is present. matplotlib and imageio are
imported where they are used, so the module imports without them.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

PERSON_COLORS = ["#1f77b4", "#d62728", "#2ca02c", "#9467bd"]


def _bones(num_joints: int):
    from regennet_torch.ops.body_model import SMPL_PARENTS, SMPLX_PARENTS

    parents = SMPLX_PARENTS if num_joints >= 55 else SMPL_PARENTS
    return [(j, int(parents[j])) for j in range(1, min(num_joints, len(parents)))]


def render_frames(
    joints: np.ndarray,  # [P, K, 3, T] persons x joints x xyz x time
    fps: int = 20,
    title: str = "",
    elev: float = 15.0,
    azim: float = -70.0,
) -> List[np.ndarray]:
    """Rasterise each frame to an RGB array."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    P, K, _, T = joints.shape
    bones = _bones(K)
    lo = joints.min(axis=(0, 1, 3))
    hi = joints.max(axis=(0, 1, 3))
    center, radius = (lo + hi) / 2, max((hi - lo).max() / 2, 1e-3)

    frames = []
    fig = plt.figure(figsize=(5, 5), dpi=100)
    ax = fig.add_subplot(111, projection="3d")
    for t in range(T):
        ax.cla()
        ax.set_xlim(center[0] - radius, center[0] + radius)
        ax.set_ylim(center[1] - radius, center[1] + radius)
        ax.set_zlim(center[2] - radius, center[2] + radius)
        ax.view_init(elev=elev, azim=azim)
        ax.axis("off")
        if title:
            ax.set_title(f"{title} [{t}]", fontsize=9)
        for p in range(P):
            c = PERSON_COLORS[p % len(PERSON_COLORS)]
            pts = joints[p, :, :, t]
            ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=4, c=c)
            for j, par in bones:
                ax.plot(
                    [pts[j, 0], pts[par, 0]],
                    [pts[j, 1], pts[par, 1]],
                    [pts[j, 2], pts[par, 2]],
                    c=c, linewidth=1.0,
                )
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[:, :, :3]
        frames.append(buf.copy())
    plt.close(fig)
    return frames


def write_video(frames: List[np.ndarray], path: str, fps: int = 20):
    import imageio

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # the gif writer deprecated fps= in favour of per-frame duration (ms)
    gif_kw = dict(duration=1000.0 / fps, loop=0)
    if path.endswith(".gif"):
        imageio.mimsave(path, frames, **gif_kw)
    else:
        try:
            imageio.mimsave(path, frames, fps=fps, macro_block_size=None)
        except Exception:
            gif = os.path.splitext(path)[0] + ".gif"
            imageio.mimsave(gif, frames, **gif_kw)
            return gif
    return path


def render_mesh_frames(
    vertices,              # [P, V, 3, T] persons x vertices x xyz x time
    faces: np.ndarray,     # [NF, 3]
    fps: int = 20,
    title: str = "",
    resolution=(448, 448),
) -> List[np.ndarray]:
    """Z-buffered, flat-shaded mesh frames from the PyTorch rasterizer
    (render/rasterizer.py: a weak-perspective camera, ambient 0.4, person 0
    ivory and person 1 gray, the meshes rotated 180 degrees about x), on
    the device of `vertices` when it is a tensor. `title` and `fps` are
    taken for the signature's sake: the frames carry no text, and the pace
    is set when the video is written."""
    from regennet_torch.render.rasterizer import render_mesh_sequence

    return render_mesh_sequence(vertices, np.asarray(faces), resolution=resolution)


def render_video(
    joints: np.ndarray, path: str, fps: int = 20, title: str = "",
    faces: np.ndarray = None,
) -> str:
    """joints [P, K, 3, T] -> video; with `faces` and K == num mesh
    vertices, renders shaded meshes instead of skeleton/point cloud."""
    if faces is not None:
        frames = render_mesh_frames(joints, faces, fps=fps, title=title)
    else:
        frames = render_frames(joints, fps=fps, title=title)
    return write_video(frames, path, fps)
