"""Batch SMPLify fitting of joint-trajectory files: `python -m
regennet_torch.visualize.fit_seq` (counterpart of
regennet_tpu/visualize/fit_seq.py).

For each `.npy` joints file ([T, K, 3]) in `--data_folder` (or a `--files`
subset), fit body-model parameters to the trajectory with the
whole-sequence fit (`joints2smpl.fit_sequence`, on the card unless
`--device cpu`) and write `fit_params.npz` (pose6d, transl, losses) and,
with `--save_objs`, one OBJ per frame into `--save_folder/<file stem>/`.
"""

from __future__ import annotations

import argparse
import os
from os.path import join as pjoin

import numpy as np
import torch

from regennet_torch.device import resolve_device
from regennet_torch.ops import body_model as bm
from regennet_torch.ops import lbs
from regennet_torch.ops import rotations as geo
from regennet_torch.utils.parser_util import device_arg
from regennet_torch.visualize.joints2smpl import export_obj, fit_sequence


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_folder", default="", type=str,
                   help="folder of [T, K, 3] .npy joint files")
    p.add_argument("--files", default="", type=str,
                   help="comma-separated subset of files (default: all .npy)")
    p.add_argument("--save_folder", required=True, type=str)
    p.add_argument("--body_model", default="smpl", choices=["smpl", "smplx"])
    p.add_argument("--num_smplify_iters", default=300, type=int)
    p.add_argument("--lr", default=0.05, type=float)
    p.add_argument("--save_objs", default=True, action=argparse.BooleanOptionalAction,
                   help="write one OBJ per frame (meshes when the body model carries faces)")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--pose_prior", default="gmm", choices=["gmm", "l2", "none"],
                   help="GMM max-mixture + angle priors (SMPLify), plain L2, or none")
    p.add_argument("--gmm_path", default="", type=str,
                   help="the licensed gmm_08.pkl; a synthetic rest-centred mixture when empty")
    p.add_argument("--device", default=0, type=device_arg,
                   help="CUDA device id (the run is on cuda:<id>), or 'cpu'.")
    return p.parse_args(argv)


def fit_file(path: str, save_dir: str, model, args) -> dict:
    joints = np.load(path)
    if joints.ndim != 3 or joints.shape[-1] != 3:
        raise ValueError(f"{path}: expected [T, K, 3] joints, got {joints.shape}")
    fit = fit_sequence(model, joints[:, :model.num_joints], num_steps=args.num_smplify_iters,
                       lr=args.lr, seed=args.seed, pose_prior=args.pose_prior,
                       gmm_path=args.gmm_path or None)
    os.makedirs(save_dir, exist_ok=True)
    np.savez(pjoin(save_dir, "fit_params.npz"), pose6d=fit["pose6d"], transl=fit["transl"],
             losses=fit["losses"])
    if args.save_objs:
        device = model.v_template.device
        with torch.no_grad():
            rotmats = geo.rotation_6d_to_matrix(torch.as_tensor(fit["pose6d"], device=device))
            verts = lbs.vertices(model, rotmats).cpu().numpy()  # [T, V, 3]
        verts = verts + fit["transl"][:, None, :]
        for t in range(verts.shape[0]):
            export_obj(verts[t], model.faces, pjoin(save_dir, f"frame{t:04d}.obj"))
    return fit


def main(args=None, device=None):
    """Fit every file; returns {name: fit}. device: "cpu", "cuda:N" or a
    torch.device; None means cuda:{args.device} (or the CPU for --device
    cpu) and raises without CUDA."""
    if args is None:
        args = parse_args()
    device = resolve_device(device, getattr(args, "device", 0))
    model = bm.get_body_model(args.body_model).to(device)
    if args.files:
        files = [f.strip() for f in args.files.split(",") if f.strip()]
    else:
        files = sorted(f for f in os.listdir(args.data_folder) if f.endswith(".npy"))
    if not files:
        raise ValueError("no .npy joint files to fit")
    results = {}
    for name in files:
        path = pjoin(args.data_folder, name) if args.data_folder else name
        save_dir = pjoin(args.save_folder, os.path.splitext(os.path.basename(name))[0])
        fit = fit_file(path, save_dir, model, args)
        print(f"fit {name}: final loss {fit['losses'][-1]:.6f} -> {save_dir}", flush=True)
        results[name] = fit
    return results


if __name__ == "__main__":
    main()
