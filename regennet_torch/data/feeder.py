"""Motion dataset feeder: raw clips -> sampled fixed-length pose windows
(the port's copy of regennet_tpu/data/feeder.py, in plain numpy).

* clips [T, V+1, C] with the last row holding the root translation, read
  from an h5 train/test pair (h5py is imported only then) or handed in
  as a dict {key: clip} (`clips=`), which serves both splits;
* labels parsed from key names (NTU `A###`, Chi3D `_<label>` suffix);
* per-process shard striding (`indices[shard:][::num_shards]`);
* frame-window sampling: conseq / random_conseq / random, pad-last-frame;
* axis-angle -> {rot6d, quat, rotmat} conversion per person, once per
  clip (the conversion is per frame, so slicing the converted clip is
  bit-identical to converting the window);
* per-clip translation re-basing and optional actor/reactor swap
  augmentation (`ar_shuffle`);
* the evaluation's index reshuffle (`shuffle`, `reset_shuffle`).
"""

from __future__ import annotations

import random
from typing import Dict, List, Mapping, Optional

import numpy as np

from regennet_torch.data import actions as action_enums
from regennet_torch.data import np_rotations as npr


def sample_frame_indices(
    nframes: int,
    num_frames: int,
    sampling: str = "conseq",
    sampling_step: int = 1,
    max_len: int = -1,
    min_len: int = -1,
    rng: Optional[random.Random] = None,
) -> np.ndarray:
    """Pick a window of frame indices: the full clip if num_frames == -1, a
    strided window with a random shift for conseq modes, pad-last-frame
    when the clip is too short."""
    rng = rng or random
    if num_frames == -1 and (max_len == -1 or nframes <= max_len):
        return np.arange(nframes)

    if num_frames == -2:
        if min_len <= 0:
            raise ValueError("You should put a min_len > 0 for num_frames == -2 mode")
        max_frame = nframes if max_len == -1 else min(nframes, max_len)
        num_frames = rng.randint(min_len, max(max_frame, min_len))
    else:
        num_frames = num_frames if num_frames != -1 else max_len

    if num_frames > nframes:
        ntoadd = max(0, num_frames - nframes)
        padding = (nframes - 1) * np.ones(ntoadd, dtype=int)
        return np.concatenate((np.arange(0, nframes), padding))

    if sampling in ("conseq", "random_conseq"):
        step_max = (nframes - 1) // (num_frames - 1)
        if sampling == "conseq":
            if sampling_step == -1 or sampling_step * (num_frames - 1) >= nframes:
                step = step_max
            else:
                step = sampling_step
        else:
            step = rng.randint(1, step_max)
        lastone = step * (num_frames - 1)
        shift_max = nframes - lastone - 1
        shift = rng.randint(0, max(0, shift_max - 1))
        return shift + np.arange(0, lastone + 1, step)

    if sampling == "random":
        choices = np.random.choice(range(nframes), num_frames, replace=False)
        return np.sort(choices)

    raise ValueError("Sampling not recognized.")


class Feeder:
    """In-memory motion dataset over an h5 train/test pair or a dict of clips."""

    def __init__(
        self,
        datapath: str = "",
        shard: int = 0,
        num_shards: int = 1,
        num_frames: int = 60,
        num_person: int = 2,
        sampling: str = "conseq",
        sampling_step: int = 1,
        split: str = "train",
        pose_rep: str = "rot6d",
        dataname: str = "ntu",
        body_model: str = "smplx",
        ar_shuffle: bool = False,
        translation: bool = True,
        glob: bool = True,
        max_len: int = -1,
        min_len: int = -1,
        num_seq_max: int = -1,
        clips: Optional[Mapping[str, np.ndarray]] = None,
        **kwargs,
    ):
        if split not in ("train", "val", "test"):
            raise ValueError(f"{split} is not a valid split")
        self.data_path = datapath
        self.shard = shard
        self.num_shards = num_shards
        self.num_frames = num_frames
        self.num_person = num_person
        self.sampling = sampling
        self.sampling_step = sampling_step
        self.split = split
        self.pose_rep = pose_rep
        self.dataname = dataname
        self.body_model = body_model
        self.ar_shuffle = ar_shuffle
        self.translation = translation
        self.glob = glob
        self.max_len = max_len
        self.min_len = min_len
        self.num_seq_max = num_seq_max

        self._poses: Dict[str, np.ndarray] = {}
        self._joints3d: Dict[str, np.ndarray] = {}
        self._num_frames_in_video: Dict[str, int] = {}
        self._actions: Dict[str, int] = {}
        self._rep_cache: Dict[str, np.ndarray] = {}

        if clips is not None:
            # one dict of clips serves both splits
            self.keys = self._ingest(clips)
            self._train = np.arange(len(self.keys))
            self._test = self._train
        else:
            self.keys = self._ingest_h5(self.data_path)
            n_train = len(self._poses)
            self._train = np.arange(n_train)
            val_file = self.data_path.replace("train", "test")
            if val_file == self.data_path:
                self._test = self._train
            else:
                self.keys += self._ingest_h5(val_file)
                self._test = np.arange(n_train, len(self._poses))

        if self.dataname == "ntu":
            self.num_actions = 26 if num_person == 2 else 94
            self._action_classes = (
                action_enums.NTU_2P_ACTIONS if num_person == 2
                else action_enums.NTU_1P_ACTIONS
            )
        elif self.dataname == "chi3d":
            self.num_actions = 8
            self._action_classes = action_enums.CHI3D_ACTIONS
        elif self.dataname == "gta":
            self.num_actions = 1
            self._action_classes = action_enums.GTA_ACTIONS
        else:
            raise NotImplementedError(self.dataname)

        # shard striding for data parallelism
        self._train = self._train[self.shard:][:: self.num_shards]
        self._original_train = None
        self._original_test = None

    def _ingest(self, clips: Mapping[str, np.ndarray]) -> List[str]:
        keys = list(clips.keys())
        for k in keys:
            clip = np.asarray(clips[k], dtype=np.float32)  # [T, V+1, C]
            self._poses[k] = clip[:, :-1]
            self._joints3d[k] = clip[:, -1, None]
            self._num_frames_in_video[k] = clip.shape[0]
            self._actions[k] = self._parse_label(k)
        return keys

    def _ingest_h5(self, path: str) -> List[str]:
        import h5py

        with h5py.File(path, "r") as f:
            return self._ingest({k: f[k][:] for k in f.keys()})

    # -- labels ----------------------------------------------------------

    def _parse_label(self, key: str) -> int:
        if "ntu" in self.dataname:
            i = key.rfind("A")
            return int(key[i + 1: i + 4]) - 1
        if self.dataname == "chi3d":
            return int(key.split("_")[-1])
        return 0

    def get_action(self, ind: int) -> int:
        return self._actions[self.keys[ind]]

    def action_to_action_name(self, action: int) -> str:
        return self._action_classes[action]

    def action_name_to_action(self, action_name):
        names = list(self._action_classes.values())
        sorter = np.argsort(names)
        return sorter[np.searchsorted(names, action_name, sorter=sorter)]

    # -- core loading ----------------------------------------------------

    def _convert_clip(self, pose: np.ndarray) -> np.ndarray:
        """Pose-rep conversion of a whole [T, V, C] axis-angle clip."""
        if self.pose_rep == "rotvec":
            return pose
        if self.pose_rep == "rotmat":
            return npr.axis_angle_to_matrix(pose).reshape(*pose.shape[:-1], 9)
        if self.pose_rep == "rotquat":
            return npr.axis_angle_to_quaternion(pose)
        if self.pose_rep == "rot6d":
            return np.concatenate(
                [
                    npr.matrix_to_rotation_6d(
                        npr.axis_angle_to_matrix(pose[:, :, 3 * p: 3 * p + 3])
                    )
                    for p in range(self.num_person)
                ],
                axis=2,
            )
        raise NotImplementedError(self.pose_rep)

    def _converted_window(self, ind: int, frame_ix: np.ndarray) -> np.ndarray:
        key = self.keys[ind]
        full = self._rep_cache.get(key)
        if full is None:
            full = self._convert_clip(self._poses[key])
            self._rep_cache[key] = full
        return full[frame_ix]

    def _load(self, ind: int, frame_ix: np.ndarray) -> np.ndarray:
        """Assemble one clip [V(+1), C, T] in the requested pose rep."""
        shuffle_or_not = self.ar_shuffle and random.random() > 0.5

        joints3d = self._joints3d[self.keys[ind]][frame_ix]  # [T, 1, C]

        def swap(a):
            # swap actor/reactor channel halves (augmentation)
            out = np.zeros_like(a)
            out[..., 0:3] = a[..., 3:6]
            out[..., 3:6] = a[..., 0:3]
            return out

        if shuffle_or_not:
            joints3d = swap(joints3d)

        if self.pose_rep == "xyz":
            pose = self._poses[self.keys[ind]][frame_ix]  # [T, V, C]
            if shuffle_or_not:
                pose = swap(pose)
            ret = np.concatenate([joints3d, pose], axis=1)
            return np.ascontiguousarray(ret.transpose(1, 2, 0), dtype=np.float32)

        # translations: re-base to the first frame of the first person
        if self.translation:
            if self.num_person > 1:
                base = joints3d[0, 0, 0:3].copy()
                tr = joints3d[:, 0].copy()
                for p in range(self.num_person):
                    tr[:, 3 * p: 3 * (p + 1)] -= base
            else:
                tr = joints3d[:, 0] - joints3d[0, 0]

        ret = self._converted_window(ind, frame_ix)
        if shuffle_or_not:
            # swapping converted per-person halves == converting swapped input
            per = ret.shape[2] // self.num_person
            ret = np.concatenate([ret[:, :, per:], ret[:, :, :per]], axis=2)
        if not self.glob:
            ret = ret[:, 1:, :]

        if self.translation:
            C = ret.shape[2]
            padded_tr = np.zeros((ret.shape[0], C), dtype=ret.dtype)
            if self.num_person > 1:
                per = C // self.num_person
                for p in range(self.num_person):
                    padded_tr[:, per * p: per * p + 3] = tr[:, 3 * p: 3 * p + 3]
            else:
                padded_tr[:, :3] = tr
            ret = np.concatenate((ret, padded_tr[:, None]), axis=1)
        return np.ascontiguousarray(ret.transpose(1, 2, 0), dtype=np.float32)

    def _sample_item(self, data_index: int) -> dict:
        nframes = self._num_frames_in_video[self.keys[data_index]]
        frame_ix = sample_frame_indices(
            nframes, self.num_frames, self.sampling, self.sampling_step,
            self.max_len, self.min_len,
        )
        inp = self._load(data_index, frame_ix)
        action = self.get_action(data_index)
        return {
            "inp": inp,
            "action": action,
            "action_text": self.action_to_action_name(action),
        }

    def __getitem__(self, index: int) -> dict:
        idx = self._train[index] if self.split == "train" else self._test[index]
        return self._sample_item(idx)

    def get_cmotion(self, one_action: int, mode: str = "fixed", data_index: int = -1):
        """Pick an actor clip of the given action for conditional generation."""
        idx_list = [
            i for i in range(len(self._actions))
            if self._actions[self.keys[i]] == one_action
        ]
        if not idx_list:
            raise ValueError(f"no clips with action {one_action}")
        if mode == "fixed":
            data_index = idx_list[0]
        elif mode == "random":
            data_index = random.choice(idx_list)
        elif mode == "appointed":
            data_index = idx_list[data_index % max(len(idx_list) - 1, 1)]
        return self._sample_item(data_index)

    def __len__(self) -> int:
        n = len(self._train) if self.split == "train" else len(self._test)
        if self.num_seq_max != -1:
            n = min(n, self.num_seq_max)
        return n

    def shuffle(self):
        """Shuffle the split's indices in place with the `random` module.

        The reference's reset_shuffle keeps an alias of the index list that
        random.shuffle then mutates, so across the multi-seed evaluation a
        reset restores nothing and the shuffles accumulate. That is
        reproduced here by keeping the saved original in lockstep once it
        exists: it decides which batches each evaluation seed selects."""
        idx = list(self._train if self.split == "train" else self._test)
        random.shuffle(idx)
        shuffled = np.asarray(idx)
        if self.split == "train":
            self._train = shuffled
            if self._original_train is not None:
                self._original_train = shuffled
        else:
            self._test = shuffled
            if self._original_test is not None:
                self._original_test = shuffled

    def reset_shuffle(self):
        """Save the split's order on the first call, restore it after (see
        shuffle for why a restore changes nothing)."""
        if self.split == "train":
            if self._original_train is None:
                self._original_train = self._train
            else:
                self._train = self._original_train
        else:
            if self._original_test is None:
                self._original_test = self._test
            else:
                self._test = self._original_test
