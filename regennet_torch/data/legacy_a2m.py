"""Single-person action-to-motion datasets, HumanAct12 and UESTC (the
port's copy of regennet_tpu/data/legacy_a2m.py).

Pickle archives of per-clip axis-angle poses and 3-D joints, with the
frame sampling of the two-person feeder (`feeder.sample_frame_indices`),
the translation re-based on the root joint's trajectory, the pose-rep
conversion in numpy and the optional front-view alignment. The same
`random` stream gives the same windows and shuffles as the JAX package.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from regennet_torch.data import np_rotations as npr
from regennet_torch.data.feeder import sample_frame_indices

HUMANACT12_ACTIONS = {
    0: "warm_up", 1: "walk", 2: "run", 3: "jump", 4: "drink",
    5: "lift_dumbbell", 6: "sit", 7: "eat", 8: "turn steering wheel",
    9: "phone", 10: "boxing", 11: "throw",
}

# UESTC subject split (51 training subjects of 118)
UESTC_TRAIN_SUBJECTS = [
    1, 2, 6, 12, 13, 16, 21, 24, 28, 29, 30, 31, 33, 35, 39, 41, 42, 45, 47,
    50, 52, 54, 55, 57, 59, 61, 63, 64, 67, 69, 70, 71, 73, 77, 81, 84, 86,
    87, 88, 90, 91, 93, 96, 99, 102, 103, 104, 107, 108, 112, 113,
]


class SinglePersonDataset:
    """Shared single-person (num_person=1) sampling/conversion machinery."""

    def __init__(self, num_frames=60, sampling="conseq", sampling_step=1,
                 split="train", pose_rep="rot6d", translation=True, glob=True,
                 max_len=-1, min_len=-1, num_seq_max=-1,
                 align_pose_frontview=False, **kwargs):
        self.num_frames = num_frames
        self.sampling = sampling
        self.sampling_step = sampling_step
        self.split = split
        self.pose_rep = pose_rep
        self.translation = translation
        self.glob = glob
        self.max_len = max_len
        self.min_len = min_len
        self.num_seq_max = num_seq_max
        self.align_pose_frontview = align_pose_frontview
        self.num_person = 1
        self._original_train = None
        self._original_test = None

    # subclasses fill: _pose (list [T,J,3] axis-angle), _joints (list [T,K,3]),
    # _num_frames_in_video, _actions, _train, _test, num_actions,
    # _action_classes

    def action_to_action_name(self, action):
        return self._action_classes[action]

    def get_action(self, ind):
        return self._actions[ind]

    def _load(self, ind, frame_ix):
        pose = np.asarray(self._pose[ind][frame_ix], dtype=np.float32)
        joints = np.asarray(self._joints[ind][frame_ix], dtype=np.float32)
        jix = getattr(self, "_jointsIx", None)
        if jix is not None:  # UESTC keeps the 18 action2motion VIBE joints
            joints = joints[:, jix]

        if self.pose_rep == "xyz":
            # the reference's single-person xyz item is the raw
            # (un-centered) joints concatenated with the rotvec pose
            # (reference: data_loaders/a2m/dataset.py:99-107)
            ret = np.concatenate([joints, pose], axis=1)
            return np.ascontiguousarray(ret.transpose(1, 2, 0))

        ret_tr = joints[:, 0, :] - joints[0, 0, :] if self.translation else None
        if not self.glob:
            pose = pose[:, 1:, :]

        if self.align_pose_frontview:
            first_rm = npr.axis_angle_to_matrix(pose[0, 0])
            all_root = npr.axis_angle_to_matrix(pose[:, 0])
            aligned = first_rm.T @ all_root
            pose[:, 0] = npr.matrix_to_axis_angle(aligned)
            if self.translation:
                ret_tr = (first_rm.T @ ret_tr.T).T

        if self.pose_rep == "rotvec":
            ret = pose
        elif self.pose_rep == "rotmat":
            ret = npr.axis_angle_to_matrix(pose).reshape(*pose.shape[:2], 9)
        elif self.pose_rep == "rotquat":
            ret = npr.axis_angle_to_quaternion(pose)
        elif self.pose_rep == "rot6d":
            ret = npr.matrix_to_rotation_6d(npr.axis_angle_to_matrix(pose))
        else:
            raise NotImplementedError(self.pose_rep)

        if self.translation:
            padded_tr = np.zeros((ret.shape[0], ret.shape[2]), dtype=ret.dtype)
            padded_tr[:, :3] = ret_tr
            ret = np.concatenate((ret, padded_tr[:, None]), axis=1)
        return np.ascontiguousarray(ret.transpose(1, 2, 0), dtype=np.float32)

    def _sample_item(self, data_index):
        nframes = self._num_frames_in_video[data_index]
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

    def __getitem__(self, index):
        idx = self._train[index] if self.split == "train" else self._test[index]
        return self._sample_item(idx)

    def __len__(self):
        n = len(self._train) if self.split == "train" else len(self._test)
        if self.num_seq_max != -1:
            n = min(n, self.num_seq_max)
        return n

    def shuffle(self):
        # reference data_loaders/a2m/dataset.py:285-301 shuffles the index
        # list IN PLACE while reset_shuffle holds an alias — so resets are
        # no-ops once taken and shuffles accumulate across eval seeds;
        # keep the saved original in lockstep to reproduce that
        import random

        idx = list(self._train if self.split == "train" else self._test)
        random.shuffle(idx)
        if self.split == "train":
            self._train = idx
            if self._original_train is not None:
                self._original_train = idx
        else:
            self._test = idx
            if self._original_test is not None:
                self._original_test = idx

    def reset_shuffle(self):
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


class HumanAct12Poses(SinglePersonDataset):
    """reference: data_loaders/a2m/humanact12poses.py:7-44."""

    dataname = "humanact12"

    def __init__(self, datapath="dataset/HumanAct12Poses", **kwargs):
        super().__init__(**kwargs)
        with open(os.path.join(datapath, "humanact12poses.pkl"), "rb") as f:
            data = pickle.load(f)
        self._pose = [np.asarray(x).reshape(-1, 24, 3) for x in data["poses"]]
        self._joints = [np.asarray(x) for x in data["joints3D"]]
        self._num_frames_in_video = [p.shape[0] for p in self._pose]
        self._actions = [int(x) for x in data["y"]]
        self.num_actions = 12
        self._action_classes = HUMANACT12_ACTIONS
        self._train = list(range(len(self._pose)))
        self._test = self._train  # humanact12 evaluates on train (reference)


# VIBE joints3d indices kept for UESTC (reference:
# data_loaders/a2m/uestc.py:11 action2motion_joints)
UESTC_JOINTS_IX = [8, 1, 2, 3, 4, 5, 6, 7, 0, 9, 10, 11, 12, 13, 14, 21, 24,
                   38]


def _uestc_get_z(cam_s, cam_pos, joints, img_size, flength):
    """Depth offset mapping the orthographic crop camera to perspective
    (reference: data_loaders/a2m/uestc.py:14-23)."""
    joints_orth_target = (cam_s * (joints[:, :2] + cam_pos) + 1) * 0.5 * img_size
    height3d = np.linalg.norm(
        np.max(joints[:, :2], axis=0) - np.min(joints[:, :2], axis=0)
    )
    height2d = np.linalg.norm(
        np.max(joints_orth_target, axis=0) - np.min(joints_orth_target, axis=0)
    )
    return float(flength * (height3d / height2d))


def _uestc_trans_from_vibe(vibe, index, use_z=True):
    """Per-frame global translation from the VIBE camera track, re-based to
    the first frame (reference: data_loaders/a2m/uestc.py:26-48)."""
    alltrans = []
    for t in range(vibe["joints3d"][index].shape[0]):
        cam_orig = vibe["orig_cam"][index][t]
        x, y = cam_orig[2], cam_orig[3]
        if use_z:
            z = _uestc_get_z(cam_s=cam_orig[0], cam_pos=cam_orig[2:4],
                             joints=vibe["joints3d"][index][t],
                             img_size=540, flength=500)
        else:
            z = 0
        alltrans.append([x, y, z])
    alltrans = np.array(alltrans)
    return alltrans - alltrans[0]


class UESTC(SinglePersonDataset):
    """reference: data_loaders/a2m/uestc.py:52-226 (vibe method): 4-field
    video names a{act}_d{view}_p{subject}_c{side}, side-2 videos rotated to
    front view about y by -view*pi/4 (view 8 side 2 dropped), VIBE camera
    global translation added to the joints, action2motion 18-joint subset,
    51/67 subject split with a min-frames filter on the train set."""

    dataname = "uestc"

    def __init__(self, datapath="dataset/uestc", view="all", **kwargs):
        super().__init__(**kwargs)
        with open(os.path.join(datapath, "info", "num_frames_min.txt")) as f:
            num_frames_video = np.asarray(
                [int(s) for s in f.read().splitlines()]
            )
        with open(os.path.join(datapath, "info", "names.txt")) as f:
            videos = f.read().splitlines()
        self._videos = videos

        with open(os.path.join(datapath, "vibe_cache_refined.pkl"), "rb") as f:
            vibe_data = pickle.load(f)
        self._pose = [
            np.asarray(p, dtype=np.float32).reshape(-1, 24, 3)
            for p in vibe_data["pose"]
        ]
        self._joints = [
            np.asarray(j, dtype=np.float32) for j in vibe_data["joints3d"]
        ]
        globpath = os.path.join(datapath, "globtrans_usez.pkl")
        if os.path.exists(globpath):
            with open(globpath, "rb") as f:
                self._globtrans = [
                    np.asarray(g, dtype=np.float32) for g in pickle.load(f)
                ]
        else:
            self._globtrans = [
                _uestc_trans_from_vibe(vibe_data, i, use_z=True).astype(
                    np.float32
                )
                for i in range(len(self._pose))
            ]
        self._jointsIx = UESTC_JOINTS_IX

        num_frames_method = [p.shape[0] for p in self._pose]
        self._num_frames_in_video = list(
            np.minimum(num_frames_video, num_frames_method).astype(int)
        )
        self._actions = [self.parse_action(v) for v in videos]
        self.num_actions = 40
        self._action_classes = {
            i: f"uestc_action_{i}" for i in range(self.num_actions)
        }
        info_classes = os.path.join(datapath, "info", "action_classes.txt")
        if os.path.exists(info_classes):
            with open(info_classes) as f:
                names = f.read().splitlines()
            self._action_classes = dict(enumerate(names))

        # y-rotations undoing the 45-degree camera views
        def get_rotation(v):
            return npr.axis_angle_to_matrix(
                np.asarray([0.0, -v * np.pi / 4, 0.0], dtype=np.float32)
            )

        rotations = {key: get_rotation(key) for key in range(8)}

        self._train, self._test = [], []
        for index, video in enumerate(videos):
            _, vview, subject, side = self._action_view_subject_side(video)
            if view == "frontview" and side != 1:
                continue
            if side != 1:
                if vview == 8:  # don't take view 8 in side 2
                    continue
                rotation = rotations[vview]
                global_matrix = npr.axis_angle_to_matrix(self._pose[index][:, 0])
                self._pose[index][:, 0] = npr.matrix_to_axis_angle(
                    rotation @ global_matrix
                )
                self._joints[index] = self._joints[index] @ rotation.T
                self._globtrans[index] = self._globtrans[index] @ rotation.T
            self._joints[index] = (
                self._joints[index] + self._globtrans[index][:, None]
            )
            if subject in UESTC_TRAIN_SUBJECTS:
                self._train.append(index)
            else:
                self._test.append(index)

        # keep only train sequences with enough method-extracted frames
        # (reference: uestc.py:169-177); the test set stays unfiltered
        threshold = self.num_frames * 3 / 4 if self.num_frames > 0 else 0
        keep = set(np.where(num_frames_video >= threshold)[0].tolist())
        self._train = list(set(self._train) & keep)
        self._test = list(set(self._test))

    @staticmethod
    def _action_view_subject_side(video_name: str):
        spl = video_name.split("_")
        return (int(spl[0][1:]), int(spl[1][1:]), int(spl[2][1:]),
                int(spl[3][1:]))

    @classmethod
    def parse_action(cls, video_name: str) -> int:
        return cls._action_view_subject_side(video_name)[0]
