"""Train the comp_v6 text-to-motion generator:
`python -m regennet_torch.train.train_t2m_gen` (counterpart of
regennet_tpu/train/train_t2m_gen.py; reference:
data_loaders/humanml/networks/trainers.py CompTrainerV6).

Snippet-autoregressive training of the text-to-motion VAE
(models/t2m_gen.py) over the frozen movement encoder of
`train_t2m_eval --stage decomp` (`{save_dir}/../decomp`, or
--decomp_checkpoint), whose movement decoder warm-starts the generator's:
SmoothL1 motion and movement reconstruction plus the prior/posterior KL,
the global gradient norm clipped at 0.5 as optax.clip_by_global_norm
clips it, then Adam at --lr.

The host's draws follow the JAX trainer's: fixseed(seed), batches in the
order of np.random.default_rng(seed + start_epoch), and one
`random() < tf_ratio` teacher-forcing draw per batch after it is drawn.
The reparameterisation noise comes from torch.Generator(seed)
(t2m_gen.training_noise), where the JAX trainer splits PRNGKey(seed):
the two streams cannot agree.

Each save writes `<save_dir>/model{epoch:09d}.pt` in the released
CompTrainerV6.save layout (the seven networks' state dicts) with "opt"
(Adam's step and moments by network and parameter name) and "epoch", and
args.json beside it, so eval_humanml and generate read it as they read a
released latest.tar. --resume restores the networks, Adam and the epoch.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Mapping

import numpy as np
import torch

from regennet_torch.data.humanml.dataset import Text2MotionDataset
from regennet_torch.device import resolve_device
from regennet_torch.models import t2m_eval, t2m_gen
from regennet_torch.train import checkpoint
from regennet_torch.train.train_t2m_eval import _batches, _tensor
from regennet_torch.train.training_loop import global_norm
from regennet_torch.utils.fixseed import fixseed
from regennet_torch.utils.parser_util import device_arg

MAX_NORM = 0.5  # optax.clip_by_global_norm(0.5)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", required=True, type=str)
    p.add_argument("--save_dir", required=True, type=str)
    p.add_argument("--decomp_checkpoint", default="", type=str,
                   help="decomp-stage checkpoint (default: the latest in "
                   "{save_dir}/../decomp)")
    p.add_argument("--dataset", default="humanml", type=str)
    p.add_argument("--batch_size", default=32, type=int)
    p.add_argument("--num_epochs", default=10, type=int)
    p.add_argument("--lr", default=2e-4, type=float)
    p.add_argument("--tf_ratio", default=0.4, type=float,
                   help="teacher forcing probability per step batch")
    p.add_argument("--lambda_rec_mov", default=1.0, type=float)
    p.add_argument("--lambda_rec_mot", default=1.0, type=float)
    p.add_argument("--lambda_kld", default=0.005, type=float)
    p.add_argument("--unit_length", default=4, type=int)
    p.add_argument("--save_every", default=0, type=int,
                   help="checkpoint every N epochs (default: only at end)")
    p.add_argument("--resume", action="store_true",
                   help="resume the networks, Adam and the epoch from the latest "
                   "checkpoint in save_dir")
    # network sizes (the published comp_v6 ones; shrink for smoke tests)
    p.add_argument("--dim_z", default=128, type=int)
    p.add_argument("--pri_hidden", default=1024, type=int)
    p.add_argument("--dec_hidden", default=1024, type=int)
    p.add_argument("--text_hidden", default=512, type=int)
    p.add_argument("--att_vec", default=512, type=int)
    p.add_argument("--n_layers", default=1, type=int)
    p.add_argument("--max_motion_length", default=196, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default=0, type=device_arg,
                   help="CUDA device id (the run is on cuda:<id>), or 'cpu'.")
    return p.parse_args(argv)


def _decomp_path(args) -> str:
    if args.decomp_checkpoint:
        return args.decomp_checkpoint
    path = checkpoint.latest_checkpoint(
        os.path.join(os.path.dirname(args.save_dir.rstrip("/")), "decomp")
    ) or checkpoint.latest_checkpoint(os.path.join(args.save_dir, "..", "decomp"))
    if not path:
        raise ValueError("no decomp checkpoint found: run train_t2m_eval --stage decomp "
                         "or pass --decomp_checkpoint")
    return path


def build_networks(args, nfeats: int):
    """(generator, movement encoder) at args' sizes on the CPU, the
    generator drawn from torch.Generator(args.seed) (t2m_eval.random_init_);
    the movement encoder at T2M_OPT's widths."""
    opt = t2m_eval.T2M_OPT
    gen = t2m_gen.CompV6Generator(
        dim_pose=nfeats, dim_word=opt["dim_word"], dim_pos_ohot=opt["dim_pos_ohot"],
        text_hidden=args.text_hidden, att_vec=args.att_vec, dim_z=args.dim_z,
        pri_hidden=args.pri_hidden, dec_hidden=args.dec_hidden, n_layers=args.n_layers,
        mov_latent=opt["dim_movement_latent"])
    t2m_eval.random_init_(gen, torch.Generator().manual_seed(int(args.seed)))
    (mov_enc,) = t2m_eval.networks(nfeats, "movement_enc")
    return gen, mov_enc


def opt_state(gen: t2m_gen.CompV6Generator, optimizer: torch.optim.Optimizer) -> Dict:
    """Adam's state by network and parameter name: {"step", "exp_avg",
    "exp_avg_sq"} (the released layout's names), on the CPU."""
    out = {"step": 0, "exp_avg": {}, "exp_avg_sq": {}}
    for name, net in t2m_gen.networks(gen, None).items():
        for key in ("exp_avg", "exp_avg_sq"):
            out[key][name] = {}
        for pname, p in net.named_parameters():
            state = optimizer.state.get(p)
            if not state:
                continue
            out["step"] = int(state["step"])
            for key in ("exp_avg", "exp_avg_sq"):
                out[key][name][pname] = state[key].detach().cpu()
    return out


def load_opt_state(gen: t2m_gen.CompV6Generator, optimizer: torch.optim.Optimizer,
                   state: Mapping) -> None:
    """Put an opt_state (or comp_v6_train_state_from_flax's "opt") into Adam."""
    for name, net in t2m_gen.networks(gen, None).items():
        for pname, p in net.named_parameters():
            optimizer.state[p] = {
                "step": torch.tensor(float(state["step"])),
                **{key: torch.as_tensor(np.asarray(state[key][name][pname]), dtype=p.dtype,
                                        device=p.device).clone()
                   for key in ("exp_avg", "exp_avg_sq")}}


def clip_by_global_norm_(params, max_norm: float = MAX_NORM) -> torch.Tensor:
    """optax.clip_by_global_norm: every gradient times max_norm / norm once
    the global norm reaches max_norm (no epsilon, unlike
    torch.nn.utils.clip_grad_norm_). Returns the norm before clipping."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = global_norm(grads)
    if norm >= max_norm:
        torch._foreach_mul_(grads, max_norm / norm)
    return norm


def make_step(gen, mov_enc, optimizer, args, device):
    """step(batch, teacher_force, eps_pri, eps_post) -> losses: one update
    of the generator over the frozen movement encoder (train mode,
    gradients clipped, then Adam), losses as floats."""
    params = list(gen.parameters())
    unit = args.unit_length

    def step(batch, teacher_force: bool, eps_pri, eps_post) -> Dict[str, float]:
        word_embs, pos_ohot, _, cap_lens, motions, m_lens, _ = batch
        motions = _tensor(motions, device)
        with torch.no_grad():
            movements = mov_enc(motions[..., :-t2m_eval.FOOT_FEATS])
            mov_in0 = mov_enc(torch.zeros(motions.shape[0], unit,
                                          motions.shape[-1] - t2m_eval.FOOT_FEATS,
                                          device=device))[:, 0]
        out = gen(_tensor(word_embs, device), _tensor(pos_ohot, device), cap_lens, movements,
                  m_lens, mov_in0, teacher_force, eps_pri, eps_post, unit_length=unit)
        losses = t2m_gen.comp_v6_losses(out, motions, movements, args.lambda_rec_mov,
                                        args.lambda_rec_mot, args.lambda_kld)
        optimizer.zero_grad(set_to_none=False)
        losses["loss_gen"].backward()
        for p in params:
            # past the first layer the prior and posterior cells' lower
            # layers reach no loss: a zero gradient, as JAX gives them
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        clip_by_global_norm_(params)
        optimizer.step()
        return {k: v.item() for k, v in losses.items()}

    return step


def main(args=None, device=None) -> Dict:
    """Train; returns {"generator", "mov_enc" (eval mode), "path" (the last
    checkpoint), "step_ms" (each update's wall, the host waiting for it)}.

    device: "cpu", "cuda:N" or a torch.device; None means cuda:{args.device}
    (or the CPU for --device cpu) and raises without CUDA."""
    if args is None:
        args = parse_args()
    device = resolve_device(device, getattr(args, "device", 0))
    # f32 means f32 on the GPU: no TF32 in matmuls, convolutions or cuDNN's GRU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fixseed(args.seed)
    os.makedirs(args.save_dir, exist_ok=True)
    with open(os.path.join(args.save_dir, "args.json"), "w") as f:
        # the movement latent too, which eval_humanml and generate rebuild with
        json.dump({**{k: v for k, v in vars(args).items() if k != "device"},
                   "mov_latent": t2m_eval.T2M_OPT["dim_movement_latent"]}, f, indent=2,
                  sort_keys=True)
    dataset = Text2MotionDataset(args.data_path, split="train", dataset_name=args.dataset,
                                 max_motion_length=args.max_motion_length)
    sample = dataset[0]
    nfeats = sample[4].shape[-1]

    decomp = t2m_eval.load_torch_file(_decomp_path(args))
    gen, mov_enc = build_networks(args, nfeats)
    t2m_eval.load_state(mov_enc, decomp["movement_enc"])
    t2m_eval.load_state(gen.mov_dec, decomp["movement_dec"])  # the warm start
    gen.to(device).train()
    mov_enc.to(device).eval().requires_grad_(False)
    print(f"Total params: {sum(p.numel() for p in gen.parameters()) / 1e6:.2f}M", flush=True)
    optimizer = torch.optim.Adam(gen.parameters(), lr=args.lr)

    start_epoch = 0
    if args.resume:
        latest = checkpoint.latest_checkpoint(args.save_dir)
        if latest:
            state = t2m_eval.load_torch_file(latest)
            t2m_gen.load_comp_v6(gen, None, state)  # the decomp's encoder stays
            if "opt" in state:
                load_opt_state(gen, optimizer, state["opt"])
            start_epoch = checkpoint.parse_step_from_path(latest)
            print(f"Resumed from {latest} (epoch {start_epoch})", flush=True)

    step = make_step(gen, mov_enc, optimizer, args, device)
    generator = torch.Generator(device=device).manual_seed(int(args.seed))
    nrng = np.random.default_rng(args.seed + start_epoch)
    path, step_ms = None, []
    for epoch in range(start_epoch + 1, args.num_epochs + 1):
        sums, count = {}, 0
        for batch in _batches(dataset, args.batch_size, nrng):
            teacher_force = bool(nrng.random() < args.tf_ratio)  # one draw per batch
            B, mov_len = batch[4].shape[0], batch[4].shape[1] // args.unit_length
            eps_pri, eps_post = t2m_gen.training_noise(generator, mov_len, B, args.dim_z,
                                                       device)
            t0 = time.perf_counter()
            losses = step(batch, teacher_force, eps_pri, eps_post)  # .item() waits
            step_ms.append((time.perf_counter() - t0) * 1e3)
            count += 1
            for k, v in losses.items():
                sums[k] = sums.get(k, 0.0) + v
        print(f"[comp_v6] epoch {epoch}: " + " ".join(
            f"{k}={v / max(count, 1):.6f}" for k, v in sorted(sums.items())), flush=True)
        if (args.save_every and epoch % args.save_every == 0) or epoch == args.num_epochs:
            path = os.path.join(args.save_dir, checkpoint.ckpt_name(epoch))
            torch.save({**t2m_gen.generator_state(gen, mov_enc),
                        "opt": opt_state(gen, optimizer), "epoch": epoch}, path)
            print(f"Saving checkpoint {path}", flush=True)
    return {"generator": gen.eval(), "mov_enc": mov_enc, "path": path, "step_ms": step_ms}


if __name__ == "__main__":
    main()
