"""Synthetic motion data (the port's copy of the clip generator of
regennet_tpu/data/synthetic.py).

Clips follow the on-disk contract of the NTU120-AS / Chi3D archives:
[T, V+1, C] with the root translation in the last row and the label in
the key name. `make_clips` returns them in memory (for Feeder(clips=...));
`write_dataset` / `make_dataset_pair` write h5 files (h5py imported only
there). Same seed, same clips as the JAX package's generator.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

NUM_ACTIONS = {"chi3d": 8, "ntu": 26, "gta": 1}


def _smooth_noise(rng, shape, smooth=9):
    x = rng.normal(size=shape).astype(np.float32)
    kernel = np.ones(smooth) / smooth
    return np.apply_along_axis(
        lambda v: np.convolve(v, kernel, mode="same"), 0, x
    ).astype(np.float32)


def make_clip(rng, length: int, njoints: int = 55, num_person: int = 2):
    """[T, njoints+1, 3*num_person]: axis-angle per joint + translation row."""
    C = 3 * num_person
    pose = _smooth_noise(rng, (length, njoints, C)) * 0.4
    transl = np.cumsum(_smooth_noise(rng, (length, 1, C)) * 0.02, axis=0)
    transl += rng.normal(size=(1, 1, C)).astype(np.float32)
    return np.concatenate([pose, transl], axis=1)


def clip_key(dataname: str, split: str, i: int, action: int) -> str:
    """Key name that encodes the label the way the real archives do."""
    if dataname == "ntu":
        return f"S001C001P{i:03d}R001A{action + 1:03d}"
    if dataname == "chi3d":
        return f"s{i:03d}_{split}_{action}"
    return f"clip{i:04d}_{action}"


def make_clips(dataname: str = "chi3d", split: str = "train",
               num_clips: int = 16, min_len: int = 40, max_len: int = 200,
               njoints: int = 55, num_person: int = 2,
               seed: int = 0) -> Dict[str, np.ndarray]:
    """{key: clip} with action i % num_actions for clip i."""
    rng = np.random.default_rng(seed + (0 if split == "train" else 1))
    num_actions = NUM_ACTIONS[dataname]
    clips = {}
    for i in range(num_clips):
        action = i % num_actions
        length = int(rng.integers(min_len, max_len))
        clips[clip_key(dataname, split, i, action)] = make_clip(
            rng, length, njoints, num_person
        )
    return clips


def write_dataset(path: str, dataname: str = "chi3d", split: str = "train",
                  num_clips: int = 16, **kwargs) -> str:
    import h5py

    clips = make_clips(dataname, split, num_clips, **kwargs)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with h5py.File(path, "w") as f:
        for key, clip in clips.items():
            f.create_dataset(key, data=clip)
    return path


def make_dataset_pair(root: str, dataname: str = "chi3d", num_clips: int = 16,
                      **kwargs) -> str:
    """Write {root}/{dataname}_train.h5 + _test.h5; returns the train path."""
    train = write_dataset(
        os.path.join(root, f"{dataname}_train.h5"), dataname, "train",
        num_clips, **kwargs,
    )
    write_dataset(
        os.path.join(root, f"{dataname}_test.h5"), dataname, "test",
        max(num_clips // 2, 4), **kwargs,
    )
    return train
