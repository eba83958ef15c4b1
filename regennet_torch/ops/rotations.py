"""3-D rotation conversions used by the pose decode (counterpart of part of
regennet_tpu/ops/rotations.py; PyTorch3D conventions, wxyz quaternions).

Functions act on trailing dims and broadcast over leading batch dims.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def quaternion_to_matrix(quaternions: torch.Tensor) -> torch.Tensor:
    """Unit quaternions (..., 4), real part first -> matrices (..., 3, 3)."""
    w, x, y, z = torch.unbind(quaternions, -1)
    two_s = 2.0 / (quaternions * quaternions).sum(-1)
    m = torch.stack(
        [
            1.0 - two_s * (y * y + z * z), two_s * (x * y - z * w),
            two_s * (x * z + y * w),
            two_s * (x * y + z * w), 1.0 - two_s * (x * x + z * z),
            two_s * (y * z - x * w),
            two_s * (x * z - y * w), two_s * (y * z + x * w),
            1.0 - two_s * (x * x + y * y),
        ],
        dim=-1,
    )
    return m.reshape(quaternions.shape[:-1] + (3, 3))


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle vectors (..., 3) -> unit quaternions (..., 4), wxyz, with
    Taylor branches around the zero angle."""
    sq = (axis_angle * axis_angle).sum(-1, keepdim=True)
    small = sq < 1e-12
    angles = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    half = 0.5 * angles
    sin_half_over_angle = torch.where(small, 0.5 - sq / 48.0, torch.sin(half) / angles)
    cos_half = torch.where(small, 1.0 - sq / 8.0, torch.cos(half))
    return torch.cat([cos_half, axis_angle * sin_half_over_angle], dim=-1)


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle vectors (..., 3) -> rotation matrices (..., 3, 3)."""
    return quaternion_to_matrix(axis_angle_to_quaternion(axis_angle))


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Continuous 6-D representation (..., 6) -> matrices (..., 3, 3) by
    Gram-Schmidt (Zhou et al. 2019); the rows are the orthonormal vectors."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.vector_norm(a1, dim=-1, keepdim=True).clamp_min(_EPS)
    a2_proj = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = a2_proj / torch.linalg.vector_norm(a2_proj, dim=-1, keepdim=True).clamp_min(_EPS)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)
