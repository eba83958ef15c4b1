"""Output-space metrics for generative baselines (the port's copy of
regennet_tpu/eval/othermetrics.py, on the port's eval/metrics.py).

Metrics computed on motion outputs rather than classifier features: the
mean acceleration magnitude, the reconstruction loss, and diversity and
multimodality over flattened outputs. Host numpy: they run once per
evaluation seed on small batches.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from regennet_torch.eval import metrics as M


def _lengths_to_mask(lengths: np.ndarray, T: int) -> np.ndarray:
    return np.arange(T)[None, :] < np.asarray(lengths)[:, None]


def calculate_acceleration(batches: List[Dict], key: str = "output") -> float:
    """Mean ||frame acceleration|| over valid frames: the second difference
    along time, its norm over the feature axis, masked to lengths - 2."""
    sum_acc = 0.0
    num_acc = 0
    for batch in batches:
        motion = np.moveaxis(np.asarray(batch[key]), -1, 1)  # [B, T, J, F]
        acc = np.diff(motion, n=2, axis=1)  # [B, T-2, J, F]
        acc_norm = np.linalg.norm(acc, axis=3)  # [B, T-2, J]
        mask = _lengths_to_mask(batch["lengths"] - 2, acc.shape[1])
        valid = acc_norm[mask]
        sum_acc += float(valid.sum())
        num_acc += int(np.prod(valid.shape))
    return sum_acc / max(num_acc, 1)


def reconstruction_loss(batches: List[Dict], in_key: str = "x",
                        out_key: str = "output") -> float:
    """Masked mean squared error between input and output motions."""
    sum_loss = 0.0
    num_loss = 0
    for batch in batches:
        x = np.moveaxis(np.asarray(batch[in_key]), -1, 1)
        out = np.moveaxis(np.asarray(batch[out_key]), -1, 1)
        mask = np.asarray(batch["mask"]).astype(bool)
        diff2 = (x[mask] - out[mask]) ** 2
        sum_loss += float(diff2.sum())
        num_loss += int(np.prod(diff2.shape))
    return sum_loss / max(num_loss, 1)


def evaluate_othermetrics(batches: List[Dict], num_classes: int,
                          key: str = "output", seed=None) -> Dict[str, float]:
    """Acceleration, output-space diversity and multimodality, and the
    reconstruction loss when the batches carry their inputs."""
    out = {"acceleration": calculate_acceleration(batches, key)}
    feats = np.concatenate(
        [np.asarray(b[key]).reshape(len(b[key]), -1) for b in batches], 0)
    labels = np.concatenate([np.asarray(b["y"]) for b in batches], 0)
    div, mult = M.calculate_diversity_multimodality(feats, labels, num_classes, seed=seed)
    out["diversity"] = float(div)
    out["multimodality"] = float(mult)
    if batches and "x" in batches[0]:
        out["rc_recons"] = reconstruction_loss(batches)
    return out
