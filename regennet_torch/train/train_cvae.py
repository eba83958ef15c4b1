"""ACTOR CVAE/CAE baseline trainer: `python -m regennet_torch.train.train_cvae`
(counterpart of regennet_tpu/train/train_cvae.py).

An epoch loop over the action-labelled dataset: each step computes the
weighted ACTOR loss mix (rc, rcxyz, vel, velxyz, kl, mmd, hp:
models/actor_losses.py; rcxyz and velxyz on joints decoded by rot2xyz)
and takes an AdamW step (optax.adamw's defaults: weight decay 1e-4). The
per-epoch loss means are printed and reported to the train platform, and
snapshots are written in the port's checkpoint format (model{N}.pt, the
reference ACTOR state dict, and opt{N}.pt, the AdamW state), N the epoch,
with args.json beside them.

The model trains as the JAX trainer applies it (`train=False`): no
dropout anywhere (`build_model` sets every rate to 0). The forward still
takes the model's train route, so that each transformer self-attention
runs B2 `fused_attention_btd_train`, here at rate 0: it is the attention
kernel with a backward. The VAE's reparameterisation noise and the mmd
and hp samples come from one torch.Generator seeded by --seed.

`--duration_finetune PATH` restores a checkpoint and adds epochs, saving
under `retraincheckpoint_orig_{orig:04d}_added_{epoch:04d}.pt`.
`--modeltype cae` trains the deterministic CAE (z is the encoder's mean);
pair it with --lambda_mmd or --lambda_hp.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from regennet_torch.data.collate import collate
from regennet_torch.data.get_data import BatchLoader, get_dataset
from regennet_torch.device import pin_f32_contract, resolve_device
from regennet_torch.models import actor_losses
from regennet_torch.models.actor_cvae import ARCH_FAMILIES, ActorCVAE
from regennet_torch.ops import body_model as bm
from regennet_torch.ops.pose_decode import make_rot2xyz
from regennet_torch.train import checkpoint
from regennet_torch.train.train_platforms import get_platform
from regennet_torch.train.training_loop import make_optimizer
from regennet_torch.utils.fixseed import fixseed
from regennet_torch.utils.parser_util import device_arg, save_args

WEIGHT_DECAY = 1e-4  # optax.adamw's default, which the JAX trainer takes


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="chi3d", type=str)
    p.add_argument("--data_path", required=True, type=str)
    p.add_argument("--save_dir", required=True, type=str)
    p.add_argument("--num_frames", default=60, type=int)
    p.add_argument("--pose_rep", default="rot6d", type=str)
    p.add_argument("--body_model", default="smplx", type=str)
    p.add_argument("--num_person", default=2, type=int)
    p.add_argument("--arch", default="transformer", type=str, choices=list(ARCH_FAMILIES))
    p.add_argument("--modeltype", default="cvae", type=str, choices=["cvae", "cae"])
    p.add_argument("--latent_dim", default=256, type=int)
    p.add_argument("--num_layers", default=4, type=int)
    p.add_argument("--batch_size", default=20, type=int)
    p.add_argument("--num_epochs", default=100, type=int)
    p.add_argument("--snapshot", default=50, type=int)
    p.add_argument("--lr", default=1e-4, type=float)
    # ACTOR's default loss mix
    p.add_argument("--lambda_rc", default=1.0, type=float)
    p.add_argument("--lambda_rcxyz", default=1.0, type=float)
    p.add_argument("--lambda_vel", default=1.0, type=float)
    p.add_argument("--lambda_velxyz", default=0.0, type=float)
    p.add_argument("--lambda_kl", default=1e-5, type=float)
    p.add_argument("--lambda_mmd", default=0.0, type=float)
    p.add_argument("--lambda_hp", default=0.0, type=float)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--train_platform_type", default="NoPlatform", type=str)
    p.add_argument("--duration_finetune", default="", type=str,
                   help="a checkpoint to restore before adding epochs")
    p.add_argument("--device", default=0, type=device_arg,
                   help="CUDA device id (the run is on cuda:<id>), or 'cpu'.")
    return p.parse_args(argv)


def active_lambdas(args) -> Dict[str, float]:
    pairs = {
        "rc": args.lambda_rc, "rcxyz": args.lambda_rcxyz,
        "vel": args.lambda_vel, "velxyz": args.lambda_velxyz,
        "kl": args.lambda_kl, "mmd": args.lambda_mmd, "hp": args.lambda_hp,
    }
    if args.modeltype == "cae":
        pairs["kl"] = 0.0  # no KL on the deterministic autoencoder
    return {k: v for k, v in pairs.items() if v > 0.0}


def build_model(args, njoints: int, nfeats: int, num_actions: int) -> ActorCVAE:
    """The model train_cvae trains: args' architecture with every dropout
    rate 0, as the JAX trainer's train=False apply leaves it."""
    return ActorCVAE(njoints=njoints, nfeats=nfeats, num_actions=num_actions,
                     latent_dim=args.latent_dim, num_layers=args.num_layers, arch=args.arch,
                     num_frames=args.num_frames, vae=args.modeltype == "cvae", dropout=0.0)


def make_train_step(model: ActorCVAE, optimizer: torch.optim.Optimizer,
                    lambdas: Dict[str, float], rot2xyz_fn: Optional[Callable],
                    generator: torch.Generator):
    """step(x, action, mask, eps=None, loss_noise=None) -> the losses: one
    forward on the model's train route (the self-attention through B2;
    the draws from `generator`; eps, the VAE's reparameterisation noise,
    and loss_noise, the mmd and hp draws by loss name, in place of the
    generator's when given), the loss mix, backward and the AdamW step.
    `model` has every dropout rate 0 (build_model), so the forward is
    deterministic but for eps."""
    needs_xyz = "rcxyz" in lambdas or "velxyz" in lambdas

    def step(x, action, mask, eps=None, loss_noise=None):
        out = model(x, action, eps=eps, generator=generator)
        batch = {"x": x, "mask": mask, **out}
        if needs_xyz:
            batch["x_xyz"] = rot2xyz_fn(x)
            batch["output_xyz"] = rot2xyz_fn(out["output"])

        def latent_fn(xin):  # the encoder's mean, on the differentiable route
            return model.encode(xin, action, generator)[0]

        mixed, losses = actor_losses.compute_losses(batch, lambdas, generator, latent_fn,
                                                    loss_noise)
        optimizer.zero_grad(set_to_none=True)
        mixed.backward()
        optimizer.step()
        return {k: v.detach() for k, v in losses.items()}

    return step


def main(args=None, device=None, data=None):
    """Train and return (model, the last checkpoint's path). device: "cpu",
    "cuda:N" or a torch.device; None means cuda:{args.device} (or the CPU
    for --device cpu) and raises without CUDA. data: a dataset (e.g.
    Feeder(clips=...)) in place of the one at args.data_path."""
    if args is None:
        args = parse_args()
    device = resolve_device(device, getattr(args, "device", 0))
    pin_f32_contract()
    fixseed(args.seed)
    os.makedirs(args.save_dir, exist_ok=True)
    platform = get_platform(args.train_platform_type)(args.save_dir)
    lambdas = active_lambdas(args)

    if data is None:
        data = get_dataset(name=args.dataset, num_frames=args.num_frames,
                           num_person=args.num_person, data_path=args.data_path,
                           split="train", setting="mdm", pose_rep=args.pose_rep,
                           body_model=args.body_model)
    loader = BatchLoader(data, args.batch_size, collate, seed=args.seed)
    motion0, _ = next(iter(loader))
    _, V, C, _ = motion0.shape
    # the layout the data gives, recorded for the sampling CLIs (the
    # single-person datasets ignore the SMPL-X two-person defaults)
    args.njoints, args.nfeats = int(V), int(C)
    if args.dataset in ("humanact12", "uestc"):
        args.body_model, args.num_person = "smpl", 1
    args.num_actions = data.num_actions
    save_args(args, args.save_dir)

    model = build_model(args, V, C, data.num_actions)
    orig_epoch = 0
    if args.duration_finetune:
        checkpoint.load_model(model, args.duration_finetune)
        orig_epoch = checkpoint.parse_step_from_path(args.duration_finetune)
        print(f"Restored weights from {args.duration_finetune}", flush=True)
    model = model.to(device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Total params: {n_params / 1e6:.2f}M", flush=True)

    rot2xyz_fn = None
    if "rcxyz" in lambdas or "velxyz" in lambdas:
        rot2xyz_fn = make_rot2xyz(bm.get_body_model(args.body_model).to(device),
                                  pose_rep=args.pose_rep, translation=True, glob=True,
                                  jointstype=args.body_model, vertstrans=False,
                                  num_person=args.num_person)
    optimizer = make_optimizer(model.parameters(), args.lr, WEIGHT_DECAY)
    generator = torch.Generator(device=device).manual_seed(int(args.seed))
    step = make_train_step(model, optimizer, lambdas, rot2xyz_fn, generator)

    path = None
    for epoch in range(1, args.num_epochs + 1):
        sums: Dict[str, torch.Tensor] = {}
        count = 0
        for motion, cond in loader:
            y = cond["y"]
            losses = step(torch.as_tensor(motion, device=device),
                          torch.as_tensor(y["action"][:, 0], device=device),
                          torch.as_tensor(np.asarray(y["mask"])[:, 0, 0, :], device=device))
            count += 1
            for k, v in losses.items():
                sums[k] = sums.get(k, 0.0) + v
        means = {k: float(v) / max(count, 1) for k, v in sums.items()}
        print(f"Epoch {epoch}, train losses: "
              + " ".join(f"{k}={v:.6f}" for k, v in sorted(means.items())), flush=True)
        for k, v in means.items():
            platform.report_scalar(name=k, value=v, iteration=epoch, group_name="Loss")
        if epoch % args.snapshot == 0 or epoch == args.num_epochs:
            if args.duration_finetune:
                path = os.path.join(args.save_dir, f"retraincheckpoint_orig_{orig_epoch:04d}"
                                                   f"_added_{epoch:04d}.pt")
                torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)
            else:
                path = checkpoint.save_checkpoint(args.save_dir, epoch, model, optimizer, {})
            print(f"Saving checkpoint {path}", flush=True)
    platform.close()
    return model, path


if __name__ == "__main__":
    main()
