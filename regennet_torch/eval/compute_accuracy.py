"""Recognition accuracy of a trained ST-GCN classifier:
`python -m regennet_torch.eval.compute_accuracy` (counterpart of
regennet_tpu/eval/compute_accuracy.py).

Runs the frozen classifier over the train and test splits it was fitted
on, fills a confusion matrix per split, and saves the per-split
accuracies to `recognition_accuracies_on_samedata_{epoch}.yaml` beside
the checkpoint (a `model{epoch}.pt` of eval/train_stgcn.py, or a
released `.pth.tar`).
"""

from __future__ import annotations

import os
from argparse import ArgumentParser
from typing import Dict, Mapping

import numpy as np
import torch

from regennet_torch.data.collate import collate
from regennet_torch.data.get_data import BatchLoader, get_dataset
from regennet_torch.device import pin_f32_contract, resolve_device
from regennet_torch.eval.tools import save_metrics
from regennet_torch.models.stgcn import STGCN
from regennet_torch.train import checkpoint
from regennet_torch.utils.fixseed import fixseed

NFEATS = {"rot6d": 6, "rotvec": 3, "rotquat": 4}


@torch.no_grad()
def compute_accuracy(model: STGCN, loaders: Mapping, num_classes: int):
    """Per-split accuracy from an explicit confusion matrix [true, predicted];
    the model runs in eval mode on the device of its parameters. Returns
    ({split: accuracy}, {split: confusion})."""
    model.eval()
    device = next(model.parameters()).device
    accuracies, confusions = {}, {}
    for key, loader in loaders.items():
        confusion = np.zeros((num_classes, num_classes), dtype=np.int64)
        for motion, cond in loader:
            labels = np.asarray(cond["y"]["action"][:, 0])
            logits = model(torch.as_tensor(motion, dtype=torch.float32, device=device))["yhat"]
            pred = logits.argmax(dim=1).cpu().numpy()
            np.add.at(confusion, (labels, pred), 1)
        accuracies[key] = float(np.trace(confusion) / confusion.sum())
        confusions[key] = confusion
    return accuracies, confusions


def parse_args(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--checkpoint", required=True, type=str,
                        help="ST-GCN checkpoint file (from train_stgcn)")
    parser.add_argument("--dataset", default="chi3d", choices=["ntu", "chi3d", "gta"])
    parser.add_argument("--data_path", required=True, type=str)
    parser.add_argument("--pose_rep", default="rot6d", type=str)
    parser.add_argument("--body_model", default="smplx", choices=["smpl", "smplx"])
    parser.add_argument("--num_frames", default=60, type=int)
    parser.add_argument("--batch_size", default=64, type=int)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--device", default=0, type=int, help="CUDA device id.")
    return parser.parse_args(argv)


def main(args=None, device=None, datasets: Dict = None):
    """Score the checkpoint, write the yaml and return the accuracies.

    device: "cpu", "cuda:N" or a torch.device; None means cuda:{args.device}
    and raises without CUDA. datasets: {"train": ..., "test": ...} (e.g.
    two Feeder(clips=...)) in place of loading args.data_path."""
    if args is None:
        args = parse_args()
    device = resolve_device(device, getattr(args, "device", 0))
    pin_f32_contract()
    fixseed(args.seed)

    if datasets is None:
        datasets = {
            split: get_dataset(
                name=args.dataset, num_frames=args.num_frames, num_person=2,
                data_path=args.data_path, split=split, setting="mdm",
                pose_rep=args.pose_rep, body_model=args.body_model,
            )
            for split in ("train", "test")
        }
    loaders = {key: BatchLoader(ds, args.batch_size, collate, shuffle=False, drop_last=False)
               for key, ds in datasets.items()}
    num_classes = datasets["train"].num_actions

    model = STGCN(in_channels=NFEATS[args.pose_rep] * 2, num_class=num_classes,
                  num_person=2, layout=args.body_model)
    checkpoint.load_classifier_state(model, args.checkpoint)
    epoch = checkpoint.parse_step_from_path(args.checkpoint)

    accuracies, _ = compute_accuracy(model.to(device), loaders, num_classes)
    for key, acc in accuracies.items():
        print(f"{key}: accuracy {acc:.4f}", flush=True)

    folder = os.path.dirname(args.checkpoint.rstrip("/"))
    evalpath = os.path.join(folder, f"recognition_accuracies_on_samedata_{epoch}.yaml")
    print(f"Saving score: {evalpath}", flush=True)
    save_metrics(evalpath, accuracies)
    return accuracies


if __name__ == "__main__":
    main()
