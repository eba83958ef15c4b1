"""Train the text-to-motion evaluator networks:
`python -m regennet_torch.train.train_t2m_eval` (counterpart of
regennet_tpu/train/train_t2m_eval.py; reference:
data_loaders/humanml/networks/trainers.py, DecompTrainerV3,
TextMotionMatchTrainer and LengthEstTrainer).

Stages (--stage, or `all` to run them in order):
- `decomp`: the movement autoencoder, Adam on the L1 reconstruction plus
  the latents' sparsity and smoothness;
- `matching`: the text and motion towers over the frozen movement
  encoder, the global gradient norm clipped at 0.5, then Adam; positive
  pairs pulled together, batch-shifted negatives pushed past the margin
  (contrastive_loss, margin 10), the shift drawn from
  np.random.default_rng(seed + 1);
- `length`: the length estimator, cross-entropy on m_lens // unit_length.

Each stage starts from torch.Generator(seed), (seed + 1) and (seed + 2)
draws of the networks, and orders its batches with
np.random.default_rng of the same seeds, as the JAX stages do; items
draw from `random` and numpy's ambient stream as the dataset does. Each
writes `<save_dir>/<stage>/model{num_epochs:09d}.pt` in the released
layouts: decomp {"movement_enc", "movement_dec"}, matching the
finest.tar layout {"movement_encoder", "text_encoder",
"motion_encoder"} (eval_humanml's --rec_model_path), length
{"estimator"} (generate's --length_estimator).
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from regennet_torch.data.humanml.dataset import Text2MotionDataset
from regennet_torch.device import resolve_device
from regennet_torch.eval.eval_humanml import _stack_items
from regennet_torch.models import t2m_eval as t2m
from regennet_torch.train import checkpoint
from regennet_torch.train.training_loop import global_norm
from regennet_torch.utils.fixseed import fixseed
from regennet_torch.utils.parser_util import device_arg

def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", required=True, type=str,
                   help="HumanML3D-layout dataset root")
    p.add_argument("--save_dir", required=True, type=str)
    p.add_argument("--stage", default="all", type=str,
                   choices=["decomp", "matching", "length", "all"])
    p.add_argument("--dataset", default="humanml", type=str)
    p.add_argument("--batch_size", default=32, type=int)
    p.add_argument("--num_epochs", default=10, type=int)
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--lambda_sparsity", default=0.001, type=float)
    p.add_argument("--lambda_smooth", default=0.001, type=float)
    p.add_argument("--negative_margin", default=10.0, type=float)
    p.add_argument("--unit_length", default=4, type=int)
    p.add_argument("--max_motion_length", default=196, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default=0, type=device_arg,
                   help="CUDA device id (the run is on cuda:<id>), or 'cpu'.")
    return p.parse_args(argv)


def _batches(dataset, batch_size: int, rng: np.random.Generator):
    order = rng.permutation(len(dataset))
    bs = min(batch_size, len(dataset))
    for start in range(0, len(order) - bs + 1, bs):
        yield _stack_items([dataset[i] for i in order[start:start + bs]])


def _networks(init: Optional[Mapping], seed: int, device, nfeats: int, *names, **kw):
    """The named networks (t2m_eval.networks) drawn from
    torch.Generator(seed) in the order given, or loaded from `init` (state
    dicts by the same names)."""
    generator = torch.Generator().manual_seed(int(seed))
    nets = t2m.networks(nfeats, *names, **kw)
    for name, net in zip(names, nets):
        if init is None:
            t2m.random_init_(net, generator)
        else:
            t2m.load_state(net, init[name])
        net.to(device).train()
    return nets


def _run(stage: str, args, dataset, rng, step) -> None:
    """num_epochs passes over `dataset` in batches of `rng`'s order, each
    epoch's logs averaged and printed as the JAX stage prints them."""
    for epoch in range(1, args.num_epochs + 1):
        logs_sum: Dict[str, float] = {}
        count = 0
        for batch in _batches(dataset, args.batch_size, rng):
            logs = step(batch)
            count += 1
            for k, v in logs.items():
                logs_sum[k] = logs_sum.get(k, 0.0) + float(v)
        print(f"[{stage}] epoch {epoch}: " + " ".join(
            f"{k}={v / max(count, 1):.6f}" for k, v in sorted(logs_sum.items())), flush=True)


def _save(args, stage: str, state: Dict) -> str:
    path = os.path.join(args.save_dir, stage, checkpoint.ckpt_name(args.num_epochs))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(state, path)
    print(f"Saving checkpoint {path}", flush=True)
    return path


def _cpu_state(net) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in net.state_dict().items()}


def _tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def train_decomp(args, dataset, nfeats: int, device, init=None):
    """The movement autoencoder; returns (encoder, decoder)."""
    enc, dec = _networks(init, args.seed, device, nfeats, "movement_enc", "movement_dec")
    optimizer = torch.optim.Adam([*enc.parameters(), *dec.parameters()], lr=args.lr)

    def step(batch):
        motions = _tensor(batch[4], device)
        latents = enc(motions[..., :-t2m.FOOT_FEATS])
        loss_rec = torch.mean(t2m.jax_abs(dec(latents) - motions))
        loss_sparsity = torch.mean(t2m.jax_abs(latents))
        loss_smooth = torch.mean(t2m.jax_abs(latents[:, 1:] - latents[:, :-1]))
        loss = (loss_rec + args.lambda_sparsity * loss_sparsity
                + args.lambda_smooth * loss_smooth)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return {"loss_rec": loss_rec.item(), "loss_sparsity": loss_sparsity.item(),
                "loss_smooth": loss_smooth.item()}

    _run("decomp", args, dataset, np.random.default_rng(args.seed), step)
    _save(args, "decomp", {"movement_enc": _cpu_state(enc), "movement_dec": _cpu_state(dec),
                           "ep": args.num_epochs})
    return enc.eval(), dec.eval()


def train_matching(args, dataset, nfeats: int, movement_enc, device, init=None):
    """The text and motion towers over the frozen movement encoder; returns
    the finest.tar-layout state."""
    text_enc, motion_enc = _networks(init, args.seed + 1, device, nfeats, "text_encoder",
                                     "motion_encoder")
    movement_enc = movement_enc.to(device).eval()
    params = [*text_enc.parameters(), *motion_enc.parameters()]
    optimizer = torch.optim.Adam(params, lr=args.lr)
    rng = np.random.default_rng(args.seed + 1)

    def step(batch):
        word_embs, pos_ohot, _, cap_lens, motions, m_lens, _ = batch
        shift = int(rng.integers(1, max(motions.shape[0], 2)))
        with torch.no_grad():
            movements = movement_enc(_tensor(motions, device)[..., :-t2m.FOOT_FEATS])
        motion_emb = motion_enc(movements, np.asarray(m_lens) // args.unit_length)
        text_emb = text_enc(_tensor(word_embs, device), _tensor(pos_ohot, device), cap_lens)
        B = text_emb.shape[0]
        zeros = torch.zeros(B, device=device)
        loss_pos = t2m.contrastive_loss(text_emb, motion_emb, zeros, args.negative_margin)
        loss_neg = t2m.contrastive_loss(text_emb, torch.roll(motion_emb, shift, 0),
                                        zeros + 1, args.negative_margin)
        loss = loss_pos + loss_neg
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        # optax.clip_by_global_norm(0.5): scaled by 0.5 / norm from the norm up
        grads = [p.grad for p in params if p.grad is not None]
        norm = global_norm(grads)
        if norm >= 0.5:
            torch._foreach_mul_(grads, 0.5 / norm)
        optimizer.step()
        return {"loss_pos": loss_pos.item(), "loss_neg": loss_neg.item(),
                "loss": loss.item()}

    _run("matching", args, dataset, rng, step)
    state = {"movement_encoder": _cpu_state(movement_enc),
             "text_encoder": _cpu_state(text_enc), "motion_encoder": _cpu_state(motion_enc)}
    _save(args, "matching", {**state, "epoch": args.num_epochs})
    return state


def train_length(args, dataset, device, init=None):
    """The length estimator over m_lens // unit_length bins; returns it."""
    num_classes = args.max_motion_length // args.unit_length + 1
    (est,) = _networks(init, args.seed + 2, device, 0, "estimator", length_bins=num_classes)
    optimizer = torch.optim.Adam(est.parameters(), lr=args.lr)

    def step(batch):
        word_embs, pos_ohot, _, cap_lens, _, m_lens, _ = batch
        labels = np.clip(np.asarray(m_lens) // args.unit_length, 0, num_classes - 1)
        logits = est(_tensor(word_embs, device), _tensor(pos_ohot, device), cap_lens)
        loss = F.cross_entropy(logits, _tensor(labels, device, torch.int64))
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return {"loss": loss.item()}

    _run("length", args, dataset, np.random.default_rng(args.seed + 2), step)
    _save(args, "length", {"estimator": _cpu_state(est), "epoch": args.num_epochs})
    return est.eval()


def main(args=None, device=None):
    """Run the stages of args.stage; returns {stage: its networks or state}.

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
    dataset = Text2MotionDataset(args.data_path, split="train", dataset_name=args.dataset)
    sample = dataset[0]
    nfeats = sample[4].shape[-1]
    args.max_motion_length = sample[4].shape[0]

    out = {}
    movement_enc = None
    if args.stage in ("decomp", "all"):
        out["decomp"] = train_decomp(args, dataset, nfeats, device)
        movement_enc = out["decomp"][0]
    if args.stage in ("matching", "all"):
        if movement_enc is None:
            latest = checkpoint.latest_checkpoint(os.path.join(args.save_dir, "decomp"))
            if latest is None:
                raise ValueError("the matching stage needs a decomp checkpoint: run "
                                 "--stage decomp (or all) first")
            (movement_enc,) = t2m.networks(nfeats, "movement_enc")
            t2m.load_state(movement_enc, t2m.load_torch_file(latest)["movement_enc"])
        out["matching"] = train_matching(args, dataset, nfeats, movement_enc, device)
    if args.stage in ("length", "all"):
        out["length"] = train_length(args, dataset, device)
    return out


if __name__ == "__main__":
    main()
