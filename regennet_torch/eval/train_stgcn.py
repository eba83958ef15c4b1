"""Train the ST-GCN recognition classifier of the evaluation (counterpart
of regennet_tpu/eval/train_stgcn.py).

An epoch loop over the two-person dataset: cross-entropy, Adam (optax
adam's betas 0.9 / 0.999 and eps 1e-8 added to sqrt(nu_hat)), BatchNorm in
train mode (models/stgcn.py), the held-out accuracy after every epoch and
a checkpoint every `save_every` epochs and at the last. The checkpoint is
the classifier's state dict, `model{epoch:09d}.pt`, which
eval_cmdm.load_stgcn_evaluator and checkpoint.load_classifier_state read.

CLI: python -m regennet_torch.eval.train_stgcn --data_path ... --save_dir ...
"""

from __future__ import annotations

import copy
import os
from argparse import ArgumentParser

import numpy as np
import torch

from regennet_torch.data.collate import collate
from regennet_torch.data.get_data import BatchLoader, get_dataset
from regennet_torch.device import pin_f32_contract, resolve_device
from regennet_torch.models.stgcn import CHANNELS, STRIDES, STGCN, cross_entropy_loss, random_init_
from regennet_torch.train import checkpoint
from regennet_torch.utils.fixseed import fixseed

NFEATS = {"rot6d": 6, "rotvec": 3, "rotquat": 4, "xyz": 3}


def graph_layout(args) -> str:
    """The graph of the reference recognition assembly: NTU skeletons for
    xyz joints, the body model's kintree for rotations (the glob-less smpl
    variant without the global orientation)."""
    glob = bool(getattr(args, "glob", True))
    if args.pose_rep == "xyz":
        return "ntu-rgb+d" if glob else "ntu_edge"
    if args.body_model == "smpl":
        return "smpl" if glob else "smpl_noglobal"
    return "smplx"


def build_model(args, num_class: int) -> STGCN:
    """The classifier at its reference size, or at args.stgcn_channels /
    args.stgcn_strides when given (the reduced evaluator of the learning
    guard)."""
    channels = getattr(args, "stgcn_channels", None)
    size = (dict(channels=tuple(channels), strides=tuple(args.stgcn_strides))
            if channels else dict(channels=CHANNELS, strides=STRIDES))
    return STGCN(in_channels=NFEATS[args.pose_rep] * 2, num_class=num_class,
                 num_person=2, layout=graph_layout(args), **size)


def make_optimizer(model: STGCN, lr: float) -> torch.optim.Adam:
    """optax.adam(lr): betas 0.9 / 0.999, eps 1e-8 added to sqrt(nu_hat)."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def train_step(model: STGCN, optimizer: torch.optim.Optimizer, motion: torch.Tensor,
               labels: torch.Tensor):
    """One update in train mode -> (loss, accuracy) as 0-dim tensors."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    logits = model(motion)["yhat"]
    loss = cross_entropy_loss(logits, labels)
    loss.backward()
    optimizer.step()
    return loss.detach(), (logits.argmax(1) == labels).float().mean()


@torch.no_grad()
def held_out_accuracy(model: STGCN, loader, device) -> float:
    """Per-sample accuracy over every batch of `loader` (the last may be
    short), with the running statistics."""
    model.eval()
    hits, count = 0, 0
    for motion, cond in loader:
        labels = torch.as_tensor(cond["y"]["action"][:, 0], device=device)
        logits = model(torch.as_tensor(motion, device=device))["yhat"]
        hits += int((logits.argmax(1) == labels).sum())
        count += int(labels.shape[0])
    return hits / max(count, 1)


def run_training(args, device=None, data=None) -> STGCN:
    """Train and return the classifier (in eval mode): the last epoch's,
    or with args.keep_best the epoch of the best held-out accuracy.

    device: "cpu", "cuda:N" or a torch.device; None means cuda:0 and raises
    without CUDA. data: a dataset with both splits (e.g. Feeder(clips=...,
    test_clips=...)) in place of loading args.data_path."""
    device = resolve_device(device)
    pin_f32_contract()
    fixseed(args.seed)
    glob = bool(getattr(args, "glob", True))
    translation = bool(getattr(args, "translation", True))
    if data is None:
        splits = {split: get_dataset(
            name=args.dataset, num_frames=args.num_frames, num_person=2,
            data_path=args.data_path, split=split, setting="mdm",
            pose_rep=args.pose_rep, body_model=args.body_model, glob=glob,
            translation=translation) for split in ("train", "test")}
    else:
        splits = {split: copy.deepcopy(data) for split in ("train", "test")}
        for split, dataset in splits.items():
            dataset.split = split
    train_loader = BatchLoader(splits["train"], args.batch_size, collate, seed=args.seed)
    test_loader = BatchLoader(splits["test"], args.batch_size, collate, shuffle=False,
                              drop_last=False)

    model = build_model(args, splits["train"].num_actions)
    random_init_(model, torch.Generator().manual_seed(int(args.seed)))
    model = model.to(device)
    optimizer = make_optimizer(model, args.lr)
    os.makedirs(args.save_dir, exist_ok=True)
    # keep_best: the epoch of the best held-out accuracy, as the reference
    # chooses among its per-epoch snapshots; Adam at lr 1e-3 on an easily
    # separable task can spike on a late epoch
    keep_best = bool(getattr(args, "keep_best", False))
    best_acc, best_state = -1.0, None
    for epoch in range(args.num_epochs):
        losses, accs = [], []
        for motion, cond in train_loader:
            labels = torch.as_tensor(cond["y"]["action"][:, 0], device=device)
            loss, acc = train_step(model, optimizer,
                                   torch.as_tensor(motion, device=device), labels)
            losses.append(loss)
            accs.append(acc)
        test_acc = held_out_accuracy(model, test_loader, device)
        print(f"epoch {epoch}: loss {float(torch.stack(losses).mean()):.4f} "
              f"train_acc {float(torch.stack(accs).mean()):.3f} test_acc {test_acc:.3f}",
              flush=True)
        if keep_best and test_acc > best_acc:
            best_acc = test_acc
            best_state = copy.deepcopy(model.state_dict())
        if (epoch + 1) % args.save_every == 0 or epoch == args.num_epochs - 1:
            path = save_stgcn(args.save_dir, epoch + 1, model)
            print(f"saved {path}", flush=True)
    if keep_best and best_state is not None:
        print(f"keep_best: returning epoch snapshot with test_acc {best_acc:.3f}",
              flush=True)
        model.load_state_dict(best_state)
    return model.eval()


def save_stgcn(save_dir: str, epoch: int, model: STGCN) -> str:
    """Write the classifier's state dict as model{epoch:09d}.pt."""
    path = os.path.abspath(os.path.join(save_dir, checkpoint.ckpt_name(epoch)))
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)
    return path


def main(args=None, device=None, data=None) -> STGCN:
    if args is None:
        parser = ArgumentParser()
        parser.add_argument("--dataset", default="chi3d", choices=["ntu", "chi3d", "gta"])
        parser.add_argument("--data_path", required=True, type=str)
        parser.add_argument("--pose_rep", default="rot6d", type=str,
                            choices=["rot6d", "rotvec", "rotquat", "xyz"])
        parser.add_argument("--body_model", default="smplx", choices=["smpl", "smplx"])
        parser.add_argument("--glob", dest="glob", action="store_true")
        parser.add_argument("--no-glob", dest="glob", action="store_false")
        parser.set_defaults(glob=True)
        parser.add_argument("--translation", dest="translation", action="store_true")
        parser.add_argument("--no-translation", dest="translation", action="store_false")
        parser.set_defaults(translation=True)
        parser.add_argument("--num_frames", default=60, type=int)
        parser.add_argument("--batch_size", default=64, type=int)
        parser.add_argument("--lr", default=1e-4, type=float)
        parser.add_argument("--num_epochs", default=100, type=int)
        parser.add_argument("--save_every", default=10, type=int)
        parser.add_argument("--save_dir", required=True, type=str)
        parser.add_argument("--seed", default=0, type=int)
        parser.add_argument("--keep_best", action="store_true",
                            help="return the best held-out-accuracy epoch's "
                                 "classifier instead of the last epoch's")
        parser.add_argument("--device", default=None,
                            help="cpu or cuda:N (default: the first GPU)")
        args = parser.parse_args()
        device = device or args.device
    return run_training(args, device=device, data=data)


if __name__ == "__main__":
    main()
