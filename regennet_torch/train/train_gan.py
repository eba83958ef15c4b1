"""Conditional motion GAN trainer: `python -m regennet_torch.train.train_gan`
(counterpart of regennet_tpu/train/train_gan.py).

An epoch loop over the action-labelled dataset with alternating D and G
updates (models/actor_gan.py): hinge losses, or a Wasserstein critic with
a gradient penalty (`--loss_mode wgan-gp`), G stepping once every
`--repeat_D` D steps. The per-epoch loss means are printed and reported to
the train platform; `--snapshot` writes model{N}.pt (the state dicts of
G and D under "G." and "D.") and opt{N}.pt (both AdamW states), N the
epoch, with args.json beside them; `--gen_per_class N` writes N samples
per class to gen_per_class.h5 at the end.

The numpy stream (default_rng(--seed)) is drawn in the JAX trainer's
order: one noise batch at set-up, then per batch the noise, the fake
labels (hinge only; wgan-gp conditions the fakes on the batch's labels),
and on each G step fresh noise and fake labels. The penalty's alpha and
the attention seeds come from a torch.Generator seeded by --seed.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np
import torch
from torch import nn

from regennet_torch.data.collate import collate
from regennet_torch.data.get_data import BatchLoader, get_dataset
from regennet_torch.device import pin_f32_contract, resolve_device
from regennet_torch.models.actor_gan import (
    Discriminator,
    Generator,
    gen_noise,
    gen_samples_per_class,
    make_gan_steps,
    make_optimizers,
    noise_dim,
    write_samples_h5,
)
from regennet_torch.train import checkpoint
from regennet_torch.train.train_platforms import get_platform
from regennet_torch.utils.fixseed import fixseed
from regennet_torch.utils.parser_util import device_arg, save_args


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="chi3d", type=str)
    p.add_argument("--data_path", required=True, type=str)
    p.add_argument("--save_dir", required=True, type=str)
    p.add_argument("--num_frames", default=60, type=int)
    p.add_argument("--pose_rep", default="rot6d", type=str)
    p.add_argument("--body_model", default="smplx", type=str)
    p.add_argument("--num_person", default=2, type=int)
    p.add_argument("--batch_size", default=32, type=int)
    p.add_argument("--num_epochs", default=100, type=int)
    p.add_argument("--snapshot", default=50, type=int)
    p.add_argument("--base_lr", default=2e-4, type=float)
    p.add_argument("--D_lr_mult", default=4.0, type=float)
    p.add_argument("--beta1", default=0.5, type=float)
    p.add_argument("--weight_decay", default=0.0, type=float)
    p.add_argument("--repeat_D", default=1, type=int,
                   help="G updates once per this many D updates (KGAN's n_critic)")
    p.add_argument("--loss_mode", default="hinge", type=str, choices=["hinge", "wgan-gp"],
                   help="hinge = GAN model type; wgan-gp = KGAN")
    p.add_argument("--lambda_gp", default=10.0, type=float)
    p.add_argument("--latent_dim", default=256, type=int)
    p.add_argument("--nnoise", default=16, type=int, help="number of noise tokens (NN)")
    p.add_argument("--noise_channel", default=32, type=int, help="Z")
    p.add_argument("--noise_mode", default="gp", type=str)
    p.add_argument("--lambda_noise", default=1.0, type=float)
    p.add_argument("--length_scale", default=10.0, type=float)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--train_platform_type", default="NoPlatform", type=str)
    p.add_argument("--gen_per_class", default=0, type=int,
                   help="if >0, dump this many samples per class at the end")
    p.add_argument("--device", default=0, type=device_arg,
                   help="CUDA device id (the run is on cuda:<id>), or 'cpu'.")
    return p.parse_args(argv)


def save_gan_checkpoint(save_dir: str, epoch: int, G: Generator, D: Discriminator,
                        opt_g, opt_d) -> str:
    """model{epoch}.pt ("G.*" and "D.*") and opt{epoch}.pt; returns the
    model file's path."""
    path = os.path.abspath(os.path.join(save_dir, checkpoint.ckpt_name(epoch)))
    torch.save(checkpoint._cpu(nn.ModuleDict({"G": G, "D": D}).state_dict()), path)
    torch.save({"opt_g": checkpoint._cpu(opt_g.state_dict()),
                "opt_d": checkpoint._cpu(opt_d.state_dict()), "step": int(epoch)},
               os.path.join(save_dir, checkpoint.opt_name(epoch)))
    return path


def main(args=None, device=None, data=None):
    """Train and return (G, D). device: "cpu", "cuda:N" or a torch.device;
    None means cuda:{args.device} (or the CPU for --device cpu) and raises
    without CUDA. data: a dataset (e.g. Feeder(clips=...)) in place of the
    one at args.data_path."""
    if args is None:
        args = parse_args()
    device = resolve_device(device, getattr(args, "device", 0))
    pin_f32_contract()
    fixseed(args.seed)
    os.makedirs(args.save_dir, exist_ok=True)
    platform = get_platform(args.train_platform_type)(args.save_dir)

    if data is None:
        data = get_dataset(name=args.dataset, num_frames=args.num_frames,
                           num_person=args.num_person, data_path=args.data_path,
                           split="train", setting="mdm", pose_rep=args.pose_rep,
                           body_model=args.body_model)
    loader = BatchLoader(data, args.batch_size, collate, seed=args.seed)
    motion0, _ = next(iter(loader))
    _, V, C, _ = np.asarray(motion0).shape
    args.njoints, args.nfeats, args.num_actions = int(V), int(C), int(data.num_actions)
    save_args(args, args.save_dir)

    nrng = np.random.default_rng(args.seed)
    noise_cfg = dict(NN=args.nnoise, Z=args.noise_channel, lambda_noise=args.lambda_noise,
                     mode=args.noise_mode, length_scale=args.length_scale)
    noise0 = gen_noise(nrng, args.batch_size, **noise_cfg)
    G = Generator(V, C, data.num_actions, args.num_frames, noise_dim=noise_dim(noise0.shape),
                  latent_dim=args.latent_dim).to(device)
    D = Discriminator(V, C, data.num_actions, latent_dim=args.latent_dim).to(device)
    n_params = sum(p.numel() for m in (G, D) for p in m.parameters())
    print(f"Total params: {n_params / 1e6:.2f}M", flush=True)

    opt_d, opt_g = make_optimizers(D, G, args.base_lr, args.D_lr_mult, args.beta1,
                                   args.weight_decay)
    generator = torch.Generator(device=device).manual_seed(int(args.seed))
    d_step, g_step = make_gan_steps(G, D, opt_d, opt_g, loss_mode=args.loss_mode,
                                    lambda_gp=args.lambda_gp, generator=generator)

    def on_device(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def fake_labels():
        return on_device(nrng.integers(0, data.num_actions, args.batch_size), torch.long)

    idx = 0
    for epoch in range(1, args.num_epochs + 1):
        sums: Dict[str, torch.Tensor] = {}
        count = 0
        for motion, cond in loader:
            if motion.shape[0] != args.batch_size:
                continue
            y = on_device(cond["y"]["action"][:, 0], torch.long)
            noise = on_device(gen_noise(nrng, args.batch_size, **noise_cfg))
            # KGAN conditions the fakes on the batch labels
            y_fake = y if args.loss_mode == "wgan-gp" else fake_labels()
            metrics = d_step(on_device(motion), y, noise, y_fake)
            if idx % args.repeat_D == 0:
                noise = on_device(gen_noise(nrng, args.batch_size, **noise_cfg))
                metrics.update(g_step(noise, fake_labels()))
            idx += 1
            count += 1
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + v
        means = {k: float(v) / max(count, 1) for k, v in sums.items()}
        print(f"Epoch {epoch}, train losses: "
              + " ".join(f"{k}={v:.4f}" for k, v in sorted(means.items())), flush=True)
        for k, v in means.items():
            platform.report_scalar(name=k, value=v, iteration=epoch, group_name="Loss")
        if epoch % args.snapshot == 0 or epoch == args.num_epochs:
            path = save_gan_checkpoint(args.save_dir, epoch, G, D, opt_g, opt_d)
            print(f"Saving checkpoint {path}", flush=True)

    if args.gen_per_class > 0:
        samples = gen_samples_per_class(G, data.num_actions, noise_cfg,
                                        per_class=args.gen_per_class, seed=args.seed)
        out = write_samples_h5(os.path.join(args.save_dir, "gen_per_class.h5"), samples)
        print(f"wrote {out}", flush=True)
    platform.close()
    return G, D


if __name__ == "__main__":
    main()
