"""HumanML3D-style stick-figure motion plotting (counterpart of
regennet_tpu/render/plot_script.py).

The legacy text-to-motion plot helper (`plot_3d_motion`): render a
[T, J, 3] joint sequence along kinematic chains with a moving ground plane
under the root trajectory, per-chain colors, generation (orange) vs ground
truth (blue) palettes, `vis_mode` in {default, gt, upper_body}, and
`gt_frames` recolouring for in-betweening edits. Frames are rasterised with
matplotlib Agg and written through the renderer's imageio video writer
(FFMpeg may be absent; gif fallback applies).
"""

from __future__ import annotations

import math
from textwrap import wrap
from typing import List, Sequence

import numpy as np

from regennet_torch.render.renderer import write_video

COLORS_BLUE = ["#4D84AA", "#5B9965", "#61CEB9", "#34C1E2", "#80B79A"]
COLORS_ORANGE = ["#DD5A37", "#D69E00", "#B75A39", "#FF6D00", "#DDB50E"]

# per-dataset display scaling
DATASET_SCALE = {"kit": 0.003, "humanml": 1.3, "humanact12": -1.5,
                 "uestc": -1.5}


def list_cut_average(ll: Sequence[float], intervals: int) -> List[float]:
    """Downsample a list by averaging over fixed-size bins."""
    if intervals == 1:
        return list(ll)
    bins = math.ceil(len(ll) / intervals)
    return [
        float(np.mean(ll[i * intervals: min((i + 1) * intervals, len(ll))]))
        for i in range(bins)
    ]


def plot_3d_motion(save_path: str, kinematic_tree: Sequence[Sequence[int]],
                   joints: np.ndarray, title: str = "",
                   dataset: str = "humanml", figsize=(3, 3), fps: int = 20,
                   radius: float = 3.0, vis_mode: str = "default",
                   gt_frames: Sequence[int] = ()) -> str:
    """Render a [T, J, 3] joint sequence to video; returns the written path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    title = "\n".join(wrap(title, 20))
    data = np.asarray(joints, np.float64).reshape(len(joints), -1, 3).copy()
    data *= DATASET_SCALE.get(dataset, 1.0)

    colors = list(COLORS_ORANGE)
    if vis_mode == "upper_body":  # lower body fixed to the input motion
        colors[0] = COLORS_BLUE[0]
        colors[1] = COLORS_BLUE[1]
    elif vis_mode == "gt":
        colors = list(COLORS_BLUE)

    mins = data.min(axis=(0, 1))
    maxs = data.max(axis=(0, 1))
    data[:, :, 1] -= mins[1]  # floor at y=0
    trajec = data[:, 0, [0, 2]].copy()
    # root-centred x/z per frame (the ground plane moves instead)
    data[..., 0] -= data[:, 0:1, 0]
    data[..., 2] -= data[:, 0:1, 2]

    fig = plt.figure(figsize=figsize, dpi=96)
    ax = fig.add_subplot(111, projection="3d")
    gt_set = set(int(g) for g in gt_frames)

    frames = []
    for index in range(data.shape[0]):
        ax.cla()
        ax.set_xlim3d([-radius / 2, radius / 2])
        ax.set_ylim3d([0, radius])
        ax.set_zlim3d([-radius / 3.0, radius * 2 / 3.0])
        if title:
            fig.suptitle(title, fontsize=10)
        ax.grid(False)
        ax.view_init(elev=120, azim=-90)
        # moving ground plane under the current root position
        verts = [
            [mins[0] - trajec[index, 0], 0, mins[2] - trajec[index, 1]],
            [mins[0] - trajec[index, 0], 0, maxs[2] - trajec[index, 1]],
            [maxs[0] - trajec[index, 0], 0, maxs[2] - trajec[index, 1]],
            [maxs[0] - trajec[index, 0], 0, mins[2] - trajec[index, 1]],
        ]
        plane = Poly3DCollection([verts])
        plane.set_facecolor((0.5, 0.5, 0.5, 0.5))
        ax.add_collection3d(plane)

        used_colors = COLORS_BLUE if index in gt_set else colors
        for i, chain in enumerate(kinematic_tree):
            color = used_colors[i % len(used_colors)]
            linewidth = 4.0 if i < 5 else 2.0
            ax.plot3D(data[index, chain, 0], data[index, chain, 1],
                      data[index, chain, 2], linewidth=linewidth, color=color)
        ax.set_axis_off()
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[:, :, :3]
        frames.append(buf.copy())
    plt.close(fig)
    return write_video(frames, save_path, fps=fps)
