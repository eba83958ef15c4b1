"""Metrics of the HumanML3D text-to-motion evaluation (the port's numpy copy
of regennet_tpu/eval/humanml_metrics.py; reference:
data_loaders/humanml/utils/metrics.py).

R-precision and the matching score rank text against motion embeddings
within a batch; diversity and multimodality draw their pairs from
numpy's ambient stream, as the JAX package does, so the same seed gives
the same numbers. The activation statistics and the Frechet distance are
those of eval/metrics.py.
"""

from __future__ import annotations

import numpy as np

from regennet_torch.eval.metrics import (  # noqa: F401 (re-exported)
    calculate_activation_statistics,
    calculate_frechet_distance,
)


def euclidean_distance_matrix(matrix1: np.ndarray, matrix2: np.ndarray):
    """Pairwise distances: d[i, j] = ||m1[i] - m2[j]||."""
    d1 = -2 * matrix1 @ matrix2.T
    d2 = np.sum(np.square(matrix1), axis=1, keepdims=True)
    d3 = np.sum(np.square(matrix2), axis=1)
    return np.sqrt(np.maximum(d1 + d2 + d3, 0.0))


def calculate_top_k(mat: np.ndarray, top_k: int) -> np.ndarray:
    """mat: argsorted distance rows; hit when the true index (the diagonal)
    appears within the first k columns. Returns [size, top_k] booleans."""
    size = mat.shape[0]
    hits = mat[:, :top_k] == np.arange(size)[:, None]
    return np.logical_or.accumulate(hits, axis=1)


def calculate_R_precision(embedding1, embedding2, top_k=3, sum_all=False):
    dist_mat = euclidean_distance_matrix(embedding1, embedding2)
    top_k_mat = calculate_top_k(np.argsort(dist_mat, axis=1), top_k)
    return top_k_mat.sum(axis=0) if sum_all else top_k_mat


def calculate_matching_score(embedding1, embedding2, sum_all=False):
    dist = np.linalg.norm(embedding1 - embedding2, axis=1)
    return dist.sum() if sum_all else dist


def calculate_diversity(activation: np.ndarray, diversity_times: int) -> float:
    num_samples = activation.shape[0]
    first = np.random.choice(num_samples, diversity_times, replace=False)
    second = np.random.choice(num_samples, diversity_times, replace=False)
    return float(np.mean(np.linalg.norm(activation[first] - activation[second], axis=1)))


def calculate_multimodality(activation: np.ndarray, multimodality_times: int) -> float:
    """activation: [num_per_sent, num_repeats, dim]."""
    num_repeats = activation.shape[1]
    first = np.random.choice(num_repeats, multimodality_times, replace=False)
    second = np.random.choice(num_repeats, multimodality_times, replace=False)
    return float(np.mean(np.linalg.norm(activation[:, first] - activation[:, second], axis=2)))
