"""Render generated reactions: `python -m regennet_torch.render.crendermotion`
(counterpart of regennet_tpu/render/crendermotion.py).

Reads a `results.npy` of `sample.cgenerate`, joins each actor condition
with its generated reactor, smooths them in time (a Gaussian, sigma 3),
decodes both persons with the body model on the card (unless `--device
cpu`) and writes one video per sample through render/renderer: stick
figures by default, and with `--jointstype vertices` meshes from the
vertices of `make_rot2xyz` through the PyTorch rasterizer, on the device.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from scipy.ndimage import gaussian_filter1d

from regennet_torch.device import resolve_device
from regennet_torch.ops import body_model as bm
from regennet_torch.ops.pose_decode import make_rot2xyz
from regennet_torch.render.renderer import render_video
from regennet_torch.utils.parser_util import device_arg


def get_sample(results: dict, idx: int, body, jointstype: str, sigma: float = 3.0,
               device="cpu") -> torch.Tensor:
    """actor and reactor -> smoothed two-person xyz [2, K, 3, T] on `device`
    (body on that device)."""
    packed = np.concatenate([results["cmotion"][idx], results["output"][idx]], axis=1)[None]
    packed = gaussian_filter1d(packed, sigma=sigma, axis=-1)  # [1, J, 12, T]
    rot2xyz = make_rot2xyz(body, pose_rep="rot6d", translation=True, glob=True,
                           jointstype=jointstype, vertstrans=True, num_person=2)
    with torch.no_grad():
        xyz = rot2xyz(torch.as_tensor(packed, dtype=torch.float32, device=device))[0]
    return torch.stack([xyz[:, :3, :], xyz[:, 3:, :]], dim=0)  # [2, K, 3, T]


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", required=True, help="path to results.npy from sample.cgenerate")
    p.add_argument("--output_dir", default="")
    p.add_argument("--body_model", default="smplx", choices=["smpl", "smplx"])
    p.add_argument("--jointstype", default=None,
                   help="defaults to the body model's joint set; 'vertices' renders meshes")
    p.add_argument("--fps", default=20, type=int)
    p.add_argument("--num_videos", default=-1, type=int)
    p.add_argument("--device", default=0, type=device_arg,
                   help="CUDA device id (the run is on cuda:<id>), or 'cpu'.")
    return p.parse_args(argv)


def main(args=None, device=None):
    """Render and return the video paths. device: "cpu", "cuda:N" or a
    torch.device; None means cuda:{args.device} (or the CPU for --device
    cpu) and raises without CUDA."""
    if args is None:
        args = parse_args()
    device = resolve_device(device, getattr(args, "device", 0))
    results = np.load(args.data_path, allow_pickle=True).item()
    out_dir = args.output_dir or os.path.join(os.path.dirname(args.data_path), "videos")
    body = bm.get_body_model(args.body_model).to(device)
    jointstype = args.jointstype or args.body_model

    n = results["output"].shape[0]
    if args.num_videos > 0:
        n = min(n, args.num_videos)
    # meshes when decoding vertices (the body model's faces)
    faces = body.faces if jointstype == "vertices" else None
    paths = []
    for i in range(n):
        joints = get_sample(results, i, body, jointstype, device=device)
        text = results["text"][i] if i < len(results.get("text", [])) else ""
        path = render_video(joints if faces is not None else joints.cpu().numpy(),
                            os.path.join(out_dir, f"sample{i:03d}.mp4"), fps=args.fps,
                            title=str(text), faces=faces)
        print(f"rendered {path}")
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()
