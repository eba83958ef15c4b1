"""Numpy rotation conversions for the host-side data path (the port's copy
of the functions of regennet_tpu/data/np_rotations.py that the feeders
use: the two-person feeder's axis-angle -> rot6d, and the matrix ->
axis-angle route of UESTC's front-view alignment; PyTorch3D conventions,
wxyz quaternions, the same arithmetic).
"""

from __future__ import annotations

import numpy as np


def axis_angle_to_quaternion(axis_angle: np.ndarray) -> np.ndarray:
    """Axis-angle (..., C) -> (..., C + 1), real part first. Like the
    pytorch3d original this accepts any last-dim width."""
    aa = np.asarray(axis_angle, np.float32)
    if aa.shape[-1] == 3:
        sq = (aa[..., 0] * aa[..., 0] + aa[..., 1] * aa[..., 1]
              + aa[..., 2] * aa[..., 2])[..., None]
    else:
        sq = np.sum(aa * aa, axis=-1, keepdims=True)
    small = sq < 1e-12
    angles = np.sqrt(np.where(small, 1.0, sq))
    half = 0.5 * angles
    sin_half_over_angle = np.where(small, 0.5 - sq / 48.0, np.sin(half) / angles)
    out = np.empty(aa.shape[:-1] + (aa.shape[-1] + 1,), np.float32)
    out[..., :1] = np.where(small, 1.0 - sq / 8.0, np.cos(half))
    out[..., 1:] = aa * sin_half_over_angle
    return out


def quaternion_to_matrix(quaternions: np.ndarray) -> np.ndarray:
    q = np.asarray(quaternions, np.float32)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    two_s = np.float32(2.0) / (w * w + x * x + y * y + z * z)
    m = np.empty(q.shape[:-1] + (3, 3), np.float32)
    m[..., 0, 0] = 1.0 - two_s * (y * y + z * z)
    m[..., 0, 1] = two_s * (x * y - z * w)
    m[..., 0, 2] = two_s * (x * z + y * w)
    m[..., 1, 0] = two_s * (x * y + z * w)
    m[..., 1, 1] = 1.0 - two_s * (x * x + z * z)
    m[..., 1, 2] = two_s * (y * z - x * w)
    m[..., 2, 0] = two_s * (x * z - y * w)
    m[..., 2, 1] = two_s * (y * z + x * w)
    m[..., 2, 2] = 1.0 - two_s * (x * x + y * y)
    return m


def axis_angle_to_matrix(axis_angle: np.ndarray) -> np.ndarray:
    return quaternion_to_matrix(axis_angle_to_quaternion(axis_angle))


def matrix_to_rotation_6d(matrix: np.ndarray) -> np.ndarray:
    m = np.asarray(matrix)
    return m[..., :2, :].reshape(*m.shape[:-2], 6)


def _sqrt_positive_part(x: np.ndarray) -> np.ndarray:
    return np.sqrt(np.maximum(x, 0.0))


def standardize_quaternion(quaternions: np.ndarray) -> np.ndarray:
    return np.where(quaternions[..., :1] < 0, -quaternions, quaternions)


def matrix_to_quaternion(matrix: np.ndarray) -> np.ndarray:
    m = np.asarray(matrix, np.float32)
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    q_abs = np.stack(
        [
            _sqrt_positive_part(1.0 + m00 + m11 + m22),
            _sqrt_positive_part(1.0 + m00 - m11 - m22),
            _sqrt_positive_part(1.0 - m00 + m11 - m22),
            _sqrt_positive_part(1.0 - m00 - m11 + m22),
        ],
        axis=-1,
    )
    quat_by_w = np.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    quat_by_x = np.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], axis=-1)
    quat_by_y = np.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], axis=-1)
    quat_by_z = np.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], axis=-1)
    quat_candidates = np.stack([quat_by_w, quat_by_x, quat_by_y, quat_by_z], axis=-2)

    denom = 2.0 * np.maximum(q_abs, 0.1)
    quat_candidates = quat_candidates / denom[..., None]

    best = np.argmax(q_abs, axis=-1)
    onehot = (best[..., None] == np.arange(4)).astype(m.dtype)
    quat = np.sum(quat_candidates * onehot[..., None], axis=-2)
    return standardize_quaternion(
        quat / np.linalg.norm(quat, axis=-1, keepdims=True)
    )


def quaternion_to_axis_angle(quaternions: np.ndarray) -> np.ndarray:
    q = np.asarray(quaternions, np.float32)
    sq = np.sum(q[..., 1:] * q[..., 1:], axis=-1, keepdims=True)
    small = sq < 1e-12
    norms = np.sqrt(np.where(small, 1.0, sq))
    half_angles = np.arctan2(norms, q[..., :1])
    sin_half_over_angle = np.where(
        small, 0.5 - sq / 12.0, np.sin(half_angles) / (2.0 * half_angles)
    )
    return q[..., 1:] / sin_half_over_angle


def matrix_to_axis_angle(matrix: np.ndarray) -> np.ndarray:
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))
