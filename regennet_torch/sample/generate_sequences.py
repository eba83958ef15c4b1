"""ACTOR baseline sample grid: `python -m regennet_torch.sample.generate_sequences`
(counterpart of regennet_tpu/sample/generate_sequences.py).

Loads a CVAE/CAE checkpoint of `train.train_cvae` (the model rebuilt from
the args.json beside it), draws one latent per (row, action class), decodes
each row at its duration (the transformer decoder's self-attention through
B1 `fused_attention_btd`), optionally decodes the poses to xyz joints or
mesh vertices through the body model (--jointstype), and saves the grid to
generation.npy beside the checkpoint (or --output_path): `generation` [R,
C, J, F, Tmax], `durations`, `classes`, and with --jointstype
`generation_xyz`.

Rows: --nspa rows at --num_frames, or with --duration_exp four rows at
durations 40, 60, 80 and 100. The latents come from a torch.Generator
seeded by --seed, or are handed to generate_grid.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from regennet_torch.device import pin_f32_contract, resolve_device
from regennet_torch.models.actor_cvae import ActorCVAE
from regennet_torch.ops import body_model as bm
from regennet_torch.ops.pose_decode import make_rot2xyz
from regennet_torch.train import checkpoint
from regennet_torch.utils.fixseed import fixseed
from regennet_torch.utils.parser_util import device_arg

DURATION_EXP = [40, 60, 80, 100]


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", required=True, type=str,
                   help="a model<N>.pt of train_cvae, with args.json beside it")
    p.add_argument("--output_path", default="", type=str)
    p.add_argument("--num_classes", default=0, type=int,
                   help="the first N classes; by default all, args.json's num_actions")
    p.add_argument("--num_frames", default=60, type=int)
    p.add_argument("--nspa", default=10, type=int, help="samples per action class")
    p.add_argument("--duration_exp", action="store_true")
    p.add_argument("--fact_latent", default=1.0, type=float, help="latent scale factor")
    p.add_argument("--jointstype", default="", type=str,
                   help="if set (smplx, smpl, vertices, ...), also decode the poses")
    p.add_argument("--vertstrans", action="store_true")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default=0, type=device_arg,
                   help="CUDA device id (the run is on cuda:<id>), or 'cpu'.")
    return p.parse_args(argv)


def _load_train_args(model_path: str) -> dict:
    args_path = os.path.join(os.path.dirname(model_path.rstrip("/")), "args.json")
    if os.path.exists(args_path):
        with open(args_path) as f:
            return json.load(f)
    return {}


@torch.no_grad()
def generate_grid(model: ActorCVAE, classes: torch.Tensor, durations: Sequence[int],
                  generator: Optional[torch.Generator] = None, fact: float = 1.0,
                  latents: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """[R, C, J, F, Tmax]: row r decodes one latent per class (latents[r]
    [C, D], else drawn from generator) at durations[r], zero-padded to the
    longest duration."""
    T_max = max(int(d) for d in durations)
    rows = []
    for r, dur in enumerate(durations):
        z = (torch.randn((classes.shape[0], model.latent_dim), generator=generator,
                         device=classes.device)
             if latents is None else latents[r].to(classes.device))
        out = model.generate(classes, int(dur), z=fact * z)
        rows.append(torch.nn.functional.pad(out, (0, T_max - out.shape[-1])))
    return torch.stack(rows, 0)


def main(args=None, device=None) -> dict:
    """Write generation.npy and return its dict. device: "cpu", "cuda:N" or
    a torch.device; None means cuda:{args.device} (or the CPU for --device
    cpu) and raises without CUDA."""
    if args is None:
        args = parse_args()
    device = resolve_device(device, getattr(args, "device", 0))
    pin_f32_contract()
    fixseed(args.seed)
    train_args = _load_train_args(args.model_path)
    state = checkpoint.load_state_dict(args.model_path)

    # the data-derived layout the trainer records
    num_person = int(train_args.get("num_person", 2))
    njoints = int(train_args.get("njoints", {"smpl": 25, "smplx": 56}.get(
        train_args.get("body_model", "smplx"), 56)))
    nfeats = int(train_args.get("nfeats", 6 * num_person))
    # the model is built for the classes it was trained on; the grid takes
    # the first --num_classes of them
    num_actions = int(train_args.get("num_actions", 0))
    if not num_actions and "decoder.actionBiases" in state:
        num_actions = state["decoder.actionBiases"].shape[0]
    num_classes = args.num_classes or num_actions
    if not num_classes:
        raise ValueError("num_actions unknown: pass --num_classes or train with "
                         "regennet_torch.train.train_cvae (which records it in args.json)")
    model = ActorCVAE(njoints=njoints, nfeats=nfeats, num_actions=num_actions or num_classes,
                      latent_dim=int(train_args.get("latent_dim", 256)),
                      num_layers=int(train_args.get("num_layers", 4)),
                      arch=train_args.get("arch", "transformer"),
                      num_frames=int(train_args.get("num_frames", args.num_frames)),
                      vae=train_args.get("modeltype", "cvae") == "cvae")
    model.load_state_dict(state, strict=True)
    model = model.to(device).eval()

    classes = torch.arange(num_classes, device=device)
    durations = DURATION_EXP if args.duration_exp else [args.num_frames] * args.nspa
    generator = torch.Generator(device=device).manual_seed(int(args.seed))
    grid = generate_grid(model, classes, durations, generator, fact=args.fact_latent)
    result = {"generation": grid.cpu().numpy(),
              "durations": np.asarray(durations, np.int32),
              "classes": classes.cpu().numpy().astype(np.int32)}
    if args.jointstype:
        rot2xyz_fn = make_rot2xyz(bm.get_body_model(train_args.get("body_model", "smplx")),
                                  pose_rep=train_args.get("pose_rep", "rot6d"),
                                  translation=True, glob=True, jointstype=args.jointstype,
                                  vertstrans=args.vertstrans, num_person=num_person)
        R, C = grid.shape[:2]
        with torch.no_grad():
            xyz = rot2xyz_fn(grid.reshape(R * C, *grid.shape[2:]))
        result["generation_xyz"] = xyz.reshape(R, C, *xyz.shape[1:]).cpu().numpy()

    out_path = args.output_path or os.path.join(
        os.path.dirname(args.model_path.rstrip("/")), "generation.npy")
    np.save(out_path, result, allow_pickle=True)
    print(f"wrote {out_path}", flush=True)
    return result


if __name__ == "__main__":
    main()
