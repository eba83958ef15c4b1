"""Skeleton kinematics + quaternion helpers for HumanML3D/KIT dataset
construction (the port's copy of regennet_tpu/data/humanml/skeleton.py;
host-side numpy: offline preprocessing, not the device compute path).

Capability parity with the legacy T2M skeleton stack (reference:
data_loaders/humanml/common/quaternion.py + common/skeleton.py +
utils/paramUtil.py): raw bone-direction templates, quaternion algebra
(wxyz), sequence-continuity fixing, and the Skeleton class with inverse /
forward kinematics used by `motion_process.process_file`.

Conventions: quaternions are wxyz; the humanml cont6d representation stores
the rotation matrix's first two COLUMNS (unlike the pytorch3d row
convention in regennet_torch/ops/rotations — both exist in the reference too).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
from scipy.ndimage import gaussian_filter1d

# -- template skeletons (reference: data_loaders/humanml/utils/paramUtil.py)

# unit bone directions of the 22-joint HumanML3D (SMPL-derived) skeleton
T2M_RAW_OFFSETS = np.array([
    [0, 0, 0],    # 0 root
    [1, 0, 0],    # 1 l_hip
    [-1, 0, 0],   # 2 r_hip
    [0, 1, 0],    # 3 spine1
    [0, -1, 0],   # 4 l_knee
    [0, -1, 0],   # 5 r_knee
    [0, 1, 0],    # 6 spine2
    [0, -1, 0],   # 7 l_ankle
    [0, -1, 0],   # 8 r_ankle
    [0, 1, 0],    # 9 spine3
    [0, 0, 1],    # 10 l_foot
    [0, 0, 1],    # 11 r_foot
    [0, 1, 0],    # 12 neck
    [1, 0, 0],    # 13 l_collar
    [-1, 0, 0],   # 14 r_collar
    [0, 0, 1],    # 15 head
    [0, -1, 0],   # 16 l_shoulder
    [0, -1, 0],   # 17 r_shoulder
    [0, -1, 0],   # 18 l_elbow
    [0, -1, 0],   # 19 r_elbow
    [0, -1, 0],   # 20 l_wrist
    [0, -1, 0],   # 21 r_wrist
], dtype=np.float32)

KIT_RAW_OFFSETS = np.array([
    [0, 0, 0], [0, 1, 0], [0, 1, 0], [0, 1, 0], [0, 1, 0],
    [1, 0, 0], [0, -1, 0], [0, -1, 0], [-1, 0, 0], [0, -1, 0],
    [0, -1, 0], [1, 0, 0], [0, -1, 0], [0, -1, 0], [0, 0, 1],
    [0, 0, 1], [-1, 0, 0], [0, -1, 0], [0, -1, 0], [0, 0, 1],
    [0, 0, 1],
], dtype=np.float32)

from regennet_torch.data.humanml.motion_process import (  # noqa: E402
    KIT_KINEMATIC_CHAIN,
    T2M_KINEMATIC_CHAIN,
)

# r_hip, l_hip, sdr_r, sdr_l (reference: scripts/motion_process.py:441-443
# t2m / :486-489 kit); the IK method unpacks this in the opposite hip order
# (common/skeleton.py:58) — a reference quirk reproduced for parity, see
# Skeleton.inverse_kinematics.
T2M_FACE_JOINTS = [2, 1, 17, 16]
KIT_FACE_JOINTS = [11, 16, 5, 8]
# lower-leg joints (scale reference), foot joints, feet-contact threshold
T2M_FEET = {"fid_l": [7, 10], "fid_r": [8, 11], "l_idx": (5, 8),
            "feet_thre": 0.002}
KIT_FEET = {"fid_l": [19, 20], "fid_r": [14, 15], "l_idx": (17, 18),
            "feet_thre": 0.05}


# -- quaternion algebra (wxyz) -----------------------------------------


def qmul(q: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Hamilton product q*r (reference: common/quaternion.py:33-56)."""
    w1, x1, y1, z1 = np.moveaxis(q, -1, 0)
    w2, x2, y2, z2 = np.moveaxis(r, -1, 0)
    return np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], axis=-1)


def qinv(q: np.ndarray) -> np.ndarray:
    """Conjugate (unit-quaternion inverse)."""
    return q * np.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def qrot(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate vectors v by quaternions q (broadcast on leading dims)."""
    qvec = q[..., 1:]
    uv = np.cross(qvec, v)
    uuv = np.cross(qvec, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def qbetween(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Quaternion rotating unit(u) onto unit(v)
    (reference: common/quaternion.py qbetween_np): axis = u x v,
    w = |u||v| + u.v, then normalise."""
    axis = np.cross(u, v)
    w = np.sqrt((u ** 2).sum(-1) * (v ** 2).sum(-1)) + (u * v).sum(-1)
    q = np.concatenate([w[..., None], axis], axis=-1)
    return q / (np.linalg.norm(q, axis=-1, keepdims=True) + 1e-12)


def qfix(q: np.ndarray) -> np.ndarray:
    """Pick q / -q per frame for temporal continuity ([T, J, 4];
    reference: common/quaternion.py:149-166)."""
    result = q.copy()
    dots = np.sum(q[1:] * q[:-1], axis=2)
    mask = (np.cumsum(dots < 0, axis=0) % 2).astype(bool)
    result[1:][mask] *= -1
    return result


def quaternion_to_matrix(q: np.ndarray) -> np.ndarray:
    w, x, y, z = np.moveaxis(q, -1, 0)
    two = 2.0 / np.maximum((q * q).sum(-1), 1e-12)
    m = np.stack([
        1 - two * (y * y + z * z), two * (x * y - z * w), two * (x * z + y * w),
        two * (x * y + z * w), 1 - two * (x * x + z * z), two * (y * z - x * w),
        two * (x * z - y * w), two * (y * z + x * w), 1 - two * (x * x + y * y),
    ], axis=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def quaternion_to_cont6d(q: np.ndarray) -> np.ndarray:
    """First two matrix COLUMNS (reference: common/quaternion.py:308-311)."""
    mat = quaternion_to_matrix(q)
    return np.concatenate([mat[..., :, 0], mat[..., :, 1]], axis=-1)


def cont6d_to_matrix(cont6d: np.ndarray) -> np.ndarray:
    """Column Gram-Schmidt (reference: common/quaternion.py:320-336)."""
    x_raw, y_raw = cont6d[..., 0:3], cont6d[..., 3:6]
    x = x_raw / np.linalg.norm(x_raw, axis=-1, keepdims=True)
    z = np.cross(x, y_raw)
    z = z / np.linalg.norm(z, axis=-1, keepdims=True)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=-1)


# -- skeleton ----------------------------------------------------------


class Skeleton:
    """Bone-template skeleton with IK/FK (reference: common/skeleton.py)."""

    def __init__(self, raw_offsets: np.ndarray, kinematic_tree: List[List[int]]):
        self.raw_offsets = np.asarray(raw_offsets, np.float32)
        self.kinematic_tree = kinematic_tree
        self._offset: Optional[np.ndarray] = None
        self.parents = [0] * len(self.raw_offsets)
        self.parents[0] = -1
        for chain in kinematic_tree:
            for j in range(1, len(chain)):
                self.parents[chain[j]] = chain[j - 1]

    def njoints(self) -> int:
        return len(self.raw_offsets)

    def set_offset(self, offsets: np.ndarray):
        self._offset = np.asarray(offsets, np.float32)

    def get_offsets_joints(self, joints: np.ndarray) -> np.ndarray:
        """Per-joint offset = bone length from a rest pose x the unit
        template direction ([J, 3] -> [J, 3])."""
        offsets = self.raw_offsets.copy()
        for i in range(1, len(self.raw_offsets)):
            offsets[i] = (
                np.linalg.norm(joints[i] - joints[self.parents[i]]) * offsets[i]
            )
        self._offset = offsets
        return offsets

    def inverse_kinematics(self, joints: np.ndarray, face_joint_idx,
                           smooth_forward: bool = False) -> np.ndarray:
        """[T, J, 3] world joints -> [T, J, 4] local quaternions.

        Root rotation aligns the body's forward direction (up x across) to
        Z+; each child's local rotation maps the template bone direction
        onto the observed bone (reference: common/skeleton.py:55-100).

        NOTE the unpacking below swaps the hips relative to the declared
        [r_hip, l_hip, sdr_r, sdr_l] order — the reference does exactly
        this (common/skeleton.py:58 vs scripts/motion_process.py:195), so
        `across` is (l-r hips)+(r-l shoulders); the published HumanML3D
        data was built with this behavior, so it is reproduced verbatim."""
        l_hip, r_hip, sdr_r, sdr_l = face_joint_idx
        across = (joints[:, r_hip] - joints[:, l_hip]) + (
            joints[:, sdr_r] - joints[:, sdr_l]
        )
        across = across / np.linalg.norm(across, axis=-1, keepdims=True)
        forward = np.cross(np.array([[0.0, 1.0, 0.0]]), across)
        if smooth_forward:
            forward = gaussian_filter1d(forward, 20, axis=0, mode="nearest")
        forward = forward / np.linalg.norm(forward, axis=-1, keepdims=True)

        target = np.tile(np.array([[0.0, 0.0, 1.0]]), (len(forward), 1))
        root_quat = qbetween(forward, target)

        quat_params = np.zeros(joints.shape[:-1] + (4,), np.float32)
        root_quat[0] = np.array([1.0, 0.0, 0.0, 0.0])
        quat_params[:, 0] = root_quat
        for chain in self.kinematic_tree:
            R = root_quat
            for j in range(len(chain) - 1):
                u = np.tile(self.raw_offsets[chain[j + 1]][None],
                            (len(joints), 1))
                v = joints[:, chain[j + 1]] - joints[:, chain[j]]
                v = v / np.linalg.norm(v, axis=-1, keepdims=True)
                rot_u_v = qbetween(u, v)
                R_loc = qmul(qinv(R), rot_u_v)
                quat_params[:, chain[j + 1]] = R_loc
                R = qmul(R, R_loc)
        return quat_params

    def forward_kinematics(self, quat_params: np.ndarray, root_pos: np.ndarray,
                           skel_joints: Optional[np.ndarray] = None,
                           do_root_R: bool = True) -> np.ndarray:
        """[T, J, 4] local quats + [T, 3] root -> [T, J, 3] world joints.
        The accumulated rotation including the child's own local rotation is
        applied to the child's rest offset (reference:
        common/skeleton.py:125-148)."""
        if skel_joints is not None:
            offsets = np.stack(
                [self.get_offsets_joints(j) for j in skel_joints]
            )
        else:
            offsets = np.tile(self._offset[None], (len(quat_params), 1, 1))
        joints = np.zeros(quat_params.shape[:-1] + (3,), np.float32)
        joints[:, 0] = root_pos
        for chain in self.kinematic_tree:
            if do_root_R:
                R = quat_params[:, 0]
            else:
                R = np.tile(np.array([[1.0, 0.0, 0.0, 0.0]]),
                            (len(quat_params), 1))
            for i in range(1, len(chain)):
                R = qmul(R, quat_params[:, chain[i]])
                joints[:, chain[i]] = (
                    qrot(R, offsets[:, chain[i]]) + joints[:, chain[i - 1]]
                )
        return joints

    def forward_kinematics_cont6d(self, cont6d_params: np.ndarray,
                                  root_pos: np.ndarray,
                                  skel_joints: Optional[np.ndarray] = None,
                                  do_root_R: bool = True) -> np.ndarray:
        """Same FK from cont6d rotations (reference:
        common/skeleton.py:149-172)."""
        if skel_joints is not None:
            offsets = np.stack(
                [self.get_offsets_joints(j) for j in skel_joints]
            )
        else:
            offsets = np.tile(self._offset[None], (len(cont6d_params), 1, 1))
        joints = np.zeros(cont6d_params.shape[:-1] + (3,), np.float32)
        joints[:, 0] = root_pos
        for chain in self.kinematic_tree:
            if do_root_R:
                matR = cont6d_to_matrix(cont6d_params[:, 0])
            else:
                matR = np.tile(np.eye(3)[None], (len(cont6d_params), 1, 1))
            for i in range(1, len(chain)):
                matR = matR @ cont6d_to_matrix(cont6d_params[:, chain[i]])
                joints[:, chain[i]] = (
                    (matR @ offsets[:, chain[i]][..., None])[..., 0]
                    + joints[:, chain[i - 1]]
                )
        return joints


def make_skeleton(dataset_name: str = "humanml") -> Skeleton:
    if dataset_name in ("humanml", "t2m"):
        return Skeleton(T2M_RAW_OFFSETS, T2M_KINEMATIC_CHAIN)
    if dataset_name == "kit":
        return Skeleton(KIT_RAW_OFFSETS, KIT_KINEMATIC_CHAIN)
    raise ValueError(f"unknown dataset {dataset_name}")
