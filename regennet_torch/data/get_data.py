"""Dataset and loader factory (the port's copy of
regennet_tpu/data/get_data.py): the two-person feeder for NTU, Chi3D and
GTA, the single-person HumanAct12 and UESTC datasets (data/legacy_a2m.py).
HumanML and KIT (the text datasets) are not ported.

`BatchLoader` is the epoch iterator training uses: shuffled, drop-last
minibatches of numpy arrays through a collate. Datasets are small and
held in RAM, so there is no worker-process machinery.
"""

from __future__ import annotations

import random
from typing import Callable, Iterator, Tuple

import numpy as np

from regennet_torch.data.collate import ccollate, collate
from regennet_torch.data.feeder import Feeder


def get_dataset_class(name: str):
    if name in ("ntu", "chi3d", "gta"):
        return Feeder
    if name in ("humanact12", "uestc"):
        from regennet_torch.data import legacy_a2m

        return legacy_a2m.HumanAct12Poses if name == "humanact12" else legacy_a2m.UESTC
    if name in ("humanml", "kit"):
        raise NotImplementedError(f"dataset {name!r} is not ported yet")
    raise ValueError(f"Unsupported dataset name [{name}]")


def get_collate_fn(name: str, setting: str = "cmdm"):
    """ccollate (actor and reactor) for the cmdm setting, else collate."""
    if name in ("humanml", "kit"):
        raise NotImplementedError(f"the collate of dataset {name!r} is not ported")
    return ccollate if setting == "cmdm" else collate


class BatchLoader:
    """Shuffled, drop-last minibatch iterator yielding (motion, cond) numpy."""

    def __init__(self, dataset, batch_size: int, collate_fn: Callable,
                 shuffle: bool = True, drop_last: bool = True, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._epoch = 0
        self._seed = seed

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[np.ndarray, dict]]:
        order = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self._seed + self._epoch).shuffle(order)
        self._epoch += 1
        for start in range(0, len(order), self.batch_size):
            idx = order[start : start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                break
            yield self.collate_fn([self.dataset[i] for i in idx])


def get_dataset(
    name: str,
    num_frames: int,
    num_person: int = 1,
    data_path: str = "",
    split: str = "train",
    setting: str = "cmdm",
    pose_rep: str = "rot6d",
    body_model: str = "smpl",
    shuffle: bool = False,
    shard: int = 0,
    num_shards: int = 1,
    **kwargs,
):
    cls = get_dataset_class(name)
    return cls(
        datapath=data_path,
        split=split,
        num_frames=num_frames,
        num_person=num_person,
        pose_rep=pose_rep,
        dataname=name,
        body_model=body_model,
        ar_shuffle=shuffle,
        shard=shard,
        num_shards=num_shards,
        **kwargs,
    )


def get_dataset_loader(
    name: str,
    batch_size: int,
    num_frames: int,
    num_person: int = 1,
    data_path: str = "",
    split: str = "train",
    setting: str = "cmdm",
    pose_rep: str = "rot6d",
    body_model: str = "smpl",
    shuffle: bool = False,
    shard: int = 0,
    num_shards: int = 1,
    loader_shuffle: bool = True,
    drop_last: bool = True,
) -> BatchLoader:
    dataset = get_dataset(
        name, num_frames, num_person, data_path, split, setting, pose_rep,
        body_model, shuffle, shard, num_shards,
    )
    return BatchLoader(
        dataset,
        batch_size,
        get_collate_fn(name, setting),
        shuffle=loader_shuffle,
        drop_last=drop_last,
    )
