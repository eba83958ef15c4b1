"""Numpy rotation conversions for the host-side data path (the port's copy
of the functions of regennet_tpu/data/np_rotations.py that the feeder
uses; PyTorch3D conventions, wxyz quaternions, the same arithmetic).
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
