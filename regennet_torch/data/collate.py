"""Batch collation to fixed-shape numpy dicts (the port's copy of
regennet_tpu/data/collate.py): `collate` packs whole clips (the
evaluation's ground-truth batches); `ccollate` splits the feature axis
into the actor (condition, first half) and reactor (diffusion target,
second half) streams and exposes the actor stream as cond['cmotion'].
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def lengths_to_mask(lengths: np.ndarray, max_len: int) -> np.ndarray:
    return np.arange(max_len)[None, :] < lengths[:, None]


def _pad_stack(clips: List[np.ndarray]) -> np.ndarray:
    """Stack clips, zero-padding every dim to the batch max."""
    shape0, dtype0 = clips[0].shape, clips[0].dtype
    if all(c.shape == shape0 and c.dtype == dtype0 for c in clips):
        return np.stack(clips)
    dims = clips[0].ndim
    max_size = [max(c.shape[d] for c in clips) for d in range(dims)]
    out = np.zeros((len(clips), *max_size), dtype=clips[0].dtype)
    for i, c in enumerate(clips):
        out[i][tuple(slice(0, s) for s in c.shape)] = c
    return out


def _common_cond(batch: List[dict], motion: np.ndarray) -> Dict:
    lengths = np.asarray(
        [b.get("lengths", b["inp"].shape[-1]) for b in batch], dtype=np.int64
    )
    mask = lengths_to_mask(lengths, motion.shape[-1])[:, None, None, :]
    cond = {"mask": mask, "lengths": lengths}
    if "action" in batch[0]:
        cond["action"] = np.asarray([[b["action"]] for b in batch], dtype=np.int64)
    if "action_text" in batch[0]:
        cond["action_text"] = [b["action_text"] for b in batch]
    return cond


def collate(batch: List[dict]) -> Tuple[np.ndarray, Dict]:
    """Single-stream collate (the evaluation's ground-truth batches)."""
    batch = [b for b in batch if b is not None]
    motion = _pad_stack([b["inp"] for b in batch])
    return motion, {"y": _common_cond(batch, motion)}


def ccollate(batch: List[dict]) -> Tuple[np.ndarray, Dict]:
    """Two-person conditional collate: actor half -> cond['cmotion']."""
    batch = [b for b in batch if b is not None]
    nfeats = batch[0]["inp"].shape[1]
    motion = _pad_stack([b["inp"][:, nfeats // 2:] for b in batch])
    cmotion = _pad_stack([b["inp"][:, : nfeats // 2] for b in batch])
    cond = _common_cond(batch, motion)
    cond["cmotion"] = cmotion
    return motion, {"y": cond}
