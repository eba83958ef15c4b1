"""Evaluation metrics: accuracy, FID, diversity, multimodality (the port's
numpy/scipy copy of regennet_tpu/eval/metrics.py).

The same Frechet-distance stabilisation, and the same 200-pair diversity
and 20-per-class multimodality sampling loops driven by np.random, so the
same ambient numpy stream gives the same numbers.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import linalg


def calculate_accuracy(logits: np.ndarray, labels: np.ndarray,
                       num_labels: int) -> Tuple[float, np.ndarray]:
    """Classification accuracy + confusion matrix [label, pred]."""
    preds = np.argmax(logits, axis=1)
    confusion = np.zeros((num_labels, num_labels), dtype=np.int64)
    for label, pred in zip(labels, preds):
        confusion[label, pred] += 1
    accuracy = float(np.trace(confusion) / np.sum(confusion))
    return accuracy, confusion


def calculate_activation_statistics(activations: np.ndarray):
    mu = np.mean(activations, axis=0)
    sigma = np.cov(activations, rowvar=False)
    return mu, sigma


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6) -> float:
    """Stable FID (Dougal J. Sutherland's formulation)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    assert mu1.shape == mu2.shape
    assert sigma1.shape == sigma2.shape
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        print(
            "fid calculation produces singular product; "
            f"adding {eps} to diagonal of cov estimates"
        )
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real
    return float(
        diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean)
    )


def calculate_fid(statistics_1, statistics_2) -> float:
    return calculate_frechet_distance(
        statistics_1[0], statistics_1[1], statistics_2[0], statistics_2[1]
    )


def calculate_diversity_multimodality(
    activations: np.ndarray, labels: np.ndarray, num_labels: int, seed=None,
    actor_quirks=False,
) -> Tuple[float, float]:
    """seed=None consumes the ambient numpy stream (the reference's default
    in both eval harnesses).

    actor_quirks selects the vendored ACTOR evaluators' variants:
    - True or "stgcn" (reference: actor-x/src/evaluate/stgcn/diversity.py:
      25-35): every label gets a multimodality quota whether or not it
      appears, and the loop bails out after 1000 iterations returning
      (0.0, 0.0) — both metrics zeroed, discarding the already-computed
      diversity, exactly as the reference does.
    - "a2m" (reference: actor-x/src/evaluate/action2motion/diversity.py:
      22-44): every label gets a quota and there is NO iteration bail — the
      reference loops forever when a label is absent from the stream. That
      hang is a defect we do not reproduce: absent labels return nan
      multimodality with a stderr warning instead (with all labels present
      the loop and its numpy draws match the reference exactly).
    """
    diversity_times = 200
    multimodality_times = 20
    labels = np.asarray(labels, dtype=np.int64)
    num_motions = activations.shape[0]

    if seed is not None:
        np.random.seed(seed)

    first = np.random.randint(0, num_motions, diversity_times)
    second = np.random.randint(0, num_motions, diversity_times)
    diversity = float(
        np.mean(np.linalg.norm(activations[first] - activations[second], axis=1))
    )

    multimodality = 0.0
    if actor_quirks:
        label_quotas = np.full(num_labels, float(multimodality_times))
        if actor_quirks == "a2m" and len(np.unique(labels)) < num_labels:
            import sys

            missing = sorted(set(range(num_labels)) - set(np.unique(labels)))
            print(
                "warning: a2m multimodality undefined — labels "
                f"{missing} absent from the eval stream (the reference "
                "would loop forever here, actor-x/src/evaluate/"
                "action2motion/diversity.py:24-44); returning nan",
                file=sys.stderr, flush=True,
            )
            return diversity, float("nan")
    else:
        label_quotas = np.zeros(num_labels)
        label_quotas[np.unique(labels)] = multimodality_times
    bail = actor_quirks and actor_quirks != "a2m"
    run_iter = 0
    while np.any(label_quotas > 0):
        if bail:
            run_iter += 1
            if run_iter >= 1000:
                return 0.0, 0.0
        first_idx = np.random.randint(0, num_motions)
        first_label = labels[first_idx]
        if not label_quotas[first_label]:
            continue
        second_idx = np.random.randint(0, num_motions)
        while labels[second_idx] != first_label:
            second_idx = np.random.randint(0, num_motions)
        label_quotas[first_label] -= 1
        multimodality += float(
            np.linalg.norm(activations[first_idx] - activations[second_idx])
        )
    multimodality /= multimodality_times * num_labels
    return diversity, multimodality
