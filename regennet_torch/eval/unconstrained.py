"""Metrics of unconstrained generation: FID, KID, precision and recall,
diversity (the port's copy of regennet_tpu/eval/unconstrained.py).

Every metric reads classifier features. `evaluate_unconstrained_reference_protocol`
is the unconstrained HumanAct12 protocol: features of the generated and
the dataset's motions from the six-block openpose ST-GCN
(models/stgcn.make_unconstrained_stgcn), then FID, KID and diversity
(and precision / recall unless `fast`). `evaluate_unconstrained_metrics`
computes them from features already extracted.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from regennet_torch.eval.metrics import calculate_activation_statistics, calculate_fid
from regennet_torch.models.stgcn import STGCN


def polynomial_mmd(feat1: np.ndarray, feat2: np.ndarray, degree=3, gamma=None,
                   coef0=1.0) -> float:
    """Unbiased polynomial-kernel MMD^2 (the KID statistic)."""
    X, Y = np.asarray(feat1, np.float64), np.asarray(feat2, np.float64)
    if gamma is None:
        gamma = 1.0 / X.shape[1]

    def k(a, b):
        return (gamma * a @ b.T + coef0) ** degree

    m, n = len(X), len(Y)
    Kxx, Kyy, Kxy = k(X, X), k(Y, Y), k(X, Y)
    np.fill_diagonal(Kxx, 0)
    np.fill_diagonal(Kyy, 0)
    return float(
        Kxx.sum() / (m * (m - 1)) + Kyy.sum() / (n * (n - 1))
        - 2 * Kxy.mean()
    )


def calculate_kid(feat_gt: np.ndarray, feat_gen: np.ndarray, n_subsets=100,
                  subset_size=None, seed=0) -> Tuple[float, float]:
    """KID mean and std over random subsets."""
    rng = np.random.default_rng(seed)
    subset_size = subset_size or min(1000, len(feat_gt), len(feat_gen))
    vals = []
    for _ in range(n_subsets):
        i = rng.choice(len(feat_gt), subset_size, replace=False)
        j = rng.choice(len(feat_gen), subset_size, replace=False)
        vals.append(polynomial_mmd(feat_gt[i], feat_gen[j]))
    return float(np.mean(vals)), float(np.std(vals))


def precision_recall(feat_gt: np.ndarray, feat_gen: np.ndarray, k=3
                     ) -> Tuple[float, float]:
    """Improved precision and recall (Kynkäänniemi et al.): membership of
    the other set's manifold by k-NN radii."""

    def pairwise(a, b):
        return np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)

    def knn_radius(feats):
        d = pairwise(feats, feats)
        np.fill_diagonal(d, np.inf)
        return np.sort(d, axis=1)[:, k - 1]

    r_gt = knn_radius(feat_gt)
    r_gen = knn_radius(feat_gen)
    # precision: generated samples inside the GT manifold
    d_gen_gt = pairwise(feat_gen, feat_gt)
    precision = float(np.mean((d_gen_gt <= r_gt[None, :]).any(axis=1)))
    # recall: GT samples inside the generated manifold
    d_gt_gen = pairwise(feat_gt, feat_gen)
    recall = float(np.mean((d_gt_gen <= r_gen[None, :]).any(axis=1)))
    return precision, recall


# SMPL joint indices -> the 15-joint openpose-style evaluator skeleton; the
# SMPL pelvis (joint 0) lands at index 8, the per-frame root subtracted
SMPL_TO_OPENPOSE15 = [15, 12, 16, 18, 20, 17, 19, 21, 0, 1, 4, 7, 2, 5, 8]
OPENPOSE15_ROOT = 8


@torch.no_grad()
def extract_unconstrained_features(model: STGCN, motions: np.ndarray,
                                   batch_size: int = 64):
    """Pooled features and logits of the unconstrained ST-GCN, run in eval
    mode on the device of its parameters, over `motions` [N, 15, 3, T]
    (root-centred xyz) in batches of `batch_size`."""
    model.eval()
    device = next(model.parameters()).device
    motions = np.asarray(motions, np.float32)
    feats, logits = [], []
    for i in range(0, len(motions), batch_size):
        out = model(torch.as_tensor(motions[i:i + batch_size], device=device))
        feats.append(out["features"].cpu().numpy())
        logits.append(out["yhat"].cpu().numpy())
    return np.concatenate(feats), np.concatenate(logits)


def _root_centred_openpose(xyz: np.ndarray) -> np.ndarray:
    xyz = np.asarray(xyz, np.float32)
    if xyz.shape[1] != 15:
        xyz = xyz[:, SMPL_TO_OPENPOSE15]
    return xyz - xyz[:, OPENPOSE15_ROOT:OPENPOSE15_ROOT + 1]


def evaluate_unconstrained_reference_protocol(
    model: STGCN, gen_xyz: np.ndarray, dataset_motions: np.ndarray,
    fast: bool = True, seed: int = 0, batch_size: int = 64,
) -> Dict[str, float]:
    """FID, KID and diversity (and precision / recall unless `fast`) of
    generated against dataset motions, on the unconstrained ST-GCN's
    features.

    `gen_xyz`: [N, 24, 3, T] SMPL joints (the 15 openpose joints are
    selected here) or [N, 15, 3, T]; `dataset_motions`: the HumanAct12
    modi-struct array [Nd, >=15, 3, T] (joints past 15 are dropped)."""
    gen = _root_centred_openpose(gen_xyz)
    data = _root_centred_openpose(np.asarray(dataset_motions, np.float32)[:, :15])

    feat_gen, _ = extract_unconstrained_features(model, gen, batch_size)
    feat_gt, _ = extract_unconstrained_features(model, data, batch_size)

    stats_gen = calculate_activation_statistics(feat_gen)
    stats_gt = calculate_activation_statistics(feat_gt)
    kid_mean, kid_std = calculate_kid(feat_gt, feat_gen, seed=seed)
    rng = np.random.default_rng(seed)

    def _diversity(f):
        first = rng.integers(0, len(f), 200)
        second = rng.integers(0, len(f), 200)
        return float(np.mean(np.linalg.norm(f[first] - f[second], axis=1)))

    metrics = {
        "fid_unconstrained": calculate_fid(stats_gen, stats_gt),
        "kid_unconstrained": kid_mean,
        "kid_std_unconstrained": kid_std,
        "diversity_gen_unconstrained": _diversity(feat_gen),
        "diversity_gt_unconstrained": _diversity(feat_gt),
    }
    if not fast:
        precision, recall = precision_recall(feat_gt, feat_gen)
        metrics["precision_unconstrained"] = precision
        metrics["recall_unconstrained"] = recall
    return metrics


def evaluate_unconstrained_metrics(feat_gt: np.ndarray, feat_gen: np.ndarray,
                                   seed=0) -> Dict[str, float]:
    """FID, KID, precision / recall and diversity from given features."""
    stats_gt = calculate_activation_statistics(feat_gt)
    stats_gen = calculate_activation_statistics(feat_gen)
    kid_mean, kid_std = calculate_kid(feat_gt, feat_gen, seed=seed)
    precision, recall = precision_recall(feat_gt, feat_gen)
    rng = np.random.default_rng(seed)
    first = rng.integers(0, len(feat_gen), 200)
    second = rng.integers(0, len(feat_gen), 200)
    diversity = float(
        np.mean(np.linalg.norm(feat_gen[first] - feat_gen[second], axis=1))
    )
    return {
        "fid_unconstrained": calculate_fid(stats_gt, stats_gen),
        "kid_unconstrained": kid_mean,
        "kid_std_unconstrained": kid_std,
        "precision_unconstrained": precision,
        "recall_unconstrained": recall,
        "diversity_unconstrained": diversity,
    }
