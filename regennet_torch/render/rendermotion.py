"""Render ACTOR baseline sample grids: `python -m regennet_torch.render.rendermotion`
(counterpart of regennet_tpu/render/rendermotion.py).

Reads the `generation.npy` grid that `sample.generate_sequences` writes,
decodes each (row, class) clip with the body model (on the card unless
`--device cpu`; or takes the grid's `generation_xyz`), clips it to its
row's duration, optionally smooths it in time, and writes one video per
clip through render/renderer (stick figures, drawn on the host) into a
folder named after the input file.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from scipy.ndimage import gaussian_filter1d

from regennet_torch.device import resolve_device
from regennet_torch.ops import body_model as bm
from regennet_torch.ops.pose_decode import rot2xyz
from regennet_torch.render.renderer import render_video
from regennet_torch.utils.parser_util import device_arg


def _split_persons(xyz: np.ndarray) -> np.ndarray:
    """[K, 3 P, T] -> [P, K, 3, T]."""
    P = xyz.shape[1] // 3
    return np.stack([xyz[:, 3 * p:3 * p + 3, :] for p in range(P)], axis=0)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", required=True,
                   help="generation.npy from sample.generate_sequences")
    p.add_argument("--output_dir", default="", help="default: <data_path stem>/")
    p.add_argument("--body_model", default="smplx", choices=["smpl", "smplx"])
    p.add_argument("--pose_rep", default="rot6d")
    p.add_argument("--num_person", default=2, type=int)
    p.add_argument("--jointstype", default=None,
                   help="defaults to the body model's joint set")
    p.add_argument("--sigma", default=0.0, type=float, help="temporal gaussian smoothing")
    p.add_argument("--fps", default=20, type=int)
    p.add_argument("--num_videos", default=-1, type=int)
    p.add_argument("--device", default=0, type=device_arg,
                   help="CUDA device id (the run is on cuda:<id>), or 'cpu'.")
    return p.parse_args(argv)


def decode_clips(result: dict, n_clips: int, body_model: str, pose_rep: str,
                 jointstype: str, num_person: int, device) -> np.ndarray:
    """The first n_clips clips of the grid as xyz [n, K, 3 P, T]: the
    grid's generation_xyz, else its poses decoded on `device`."""
    R, C = np.asarray(result["generation"]).shape[:2]
    if "generation_xyz" in result:
        xyz_grid = np.asarray(result["generation_xyz"])  # [R, C, K, 3P, T]
        return xyz_grid.reshape((R * C,) + xyz_grid.shape[2:])[:n_clips]
    body = bm.get_body_model(body_model).to(device)
    grid = np.asarray(result["generation"], np.float32)
    # only the clips that will render: the decode is the costly step
    flat = torch.as_tensor(grid.reshape((R * C,) + grid.shape[2:])[:n_clips], device=device)
    with torch.no_grad():
        xyz = rot2xyz(flat, None, body, pose_rep=pose_rep, translation=True, glob=True,
                      jointstype=jointstype, vertstrans=True, num_person=num_person)
    return xyz.cpu().numpy()


def main(args=None, device=None):
    """Render and return the video paths. device: "cpu", "cuda:N" or a
    torch.device; None means cuda:{args.device} (or the CPU for --device
    cpu) and raises without CUDA."""
    if args is None:
        args = parse_args()
    device = resolve_device(device, getattr(args, "device", 0))
    result = np.load(args.data_path, allow_pickle=True).item()
    out_dir = args.output_dir or os.path.splitext(args.data_path)[0]
    durations = np.asarray(result.get("durations", []), np.int64)
    R, C = np.asarray(result["generation"]).shape[:2]
    n_clips = R * C if args.num_videos <= 0 else min(R * C, args.num_videos)
    flat_xyz = decode_clips(result, n_clips, args.body_model, args.pose_rep,
                            args.jointstype or args.body_model, args.num_person, device)

    paths = []
    for r in range(R):
        dur = int(durations[r]) if r < len(durations) else flat_xyz.shape[-1]
        for c in range(C):
            if len(paths) >= n_clips:
                return paths
            clip = flat_xyz[r * C + c][..., :dur]  # [K, 3P, T]
            if args.sigma > 0:
                clip = gaussian_filter1d(clip, sigma=args.sigma, axis=-1)
            path = render_video(_split_persons(clip),
                                os.path.join(out_dir, f"generation_{r}_class{c:03d}.mp4"),
                                fps=args.fps, title=f"row {r} action {c}")
            print(f"rendered {path}", flush=True)
            paths.append(path)
    return paths


if __name__ == "__main__":
    main()
