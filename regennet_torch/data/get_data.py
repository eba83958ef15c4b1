"""Dataset factory (the port's copy of the part of
regennet_tpu/data/get_data.py that the sampler uses: the NTU / Chi3D /
GTA feeder). The collate selection and the epoch iterator that training
uses are not ported yet.
"""

from __future__ import annotations

from regennet_torch.data.feeder import Feeder


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
) -> Feeder:
    if name not in ("ntu", "chi3d", "gta"):
        raise NotImplementedError(f"dataset {name!r} is not ported yet")
    return Feeder(
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
