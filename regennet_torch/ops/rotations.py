"""3-D rotation conversions used by the pose decode, the orient loss and
the HumanML3D decode, and the Euler-angle conversions (counterpart of
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


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(0, x)) with a gradient of 0 (not NaN) where x <= 0: the
    double where keeps sqrt'(0) = inf out of the backward."""
    positive = x > 0.0
    safe = torch.where(positive, x, torch.ones_like(x))
    return torch.where(positive, torch.sqrt(safe), torch.zeros_like(x))


def standardize_quaternion(quaternions: torch.Tensor) -> torch.Tensor:
    """Make the real part non-negative (each rotation has two unit-quat covers)."""
    return torch.where(quaternions[..., :1] < 0, -quaternions, quaternions)


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> unit quaternions (..., 4), wxyz, by
    the "largest denominator" construction, selected without branching."""
    m00, m01, m02 = matrix[..., 0, 0], matrix[..., 0, 1], matrix[..., 0, 2]
    m10, m11, m12 = matrix[..., 1, 0], matrix[..., 1, 1], matrix[..., 1, 2]
    m20, m21, m22 = matrix[..., 2, 0], matrix[..., 2, 1], matrix[..., 2, 2]
    q_abs = torch.stack(
        [
            _sqrt_positive_part(1.0 + m00 + m11 + m22),
            _sqrt_positive_part(1.0 + m00 - m11 - m22),
            _sqrt_positive_part(1.0 - m00 + m11 - m22),
            _sqrt_positive_part(1.0 - m00 - m11 + m22),
        ],
        dim=-1,
    )
    # candidate quaternions, one per dominant component (each 2|q_i| q)
    candidates = torch.stack(
        [
            torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
            torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1),
            torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1),
            torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1),
        ],
        dim=-2,
    )
    # the floor keeps the rows that are not selected finite
    candidates = candidates / (2.0 * q_abs.clamp_min(0.1))[..., None]
    onehot = torch.nn.functional.one_hot(q_abs.argmax(dim=-1), 4).to(matrix.dtype)
    quat = (candidates * onehot[..., None]).sum(dim=-2)
    return standardize_quaternion(
        quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    )


def quaternion_to_axis_angle(quaternions: torch.Tensor) -> torch.Tensor:
    """Unit quaternions (..., 4), wxyz -> axis-angle vectors (..., 3), with a
    Taylor branch near the identity whose gradient stays finite."""
    xyz = quaternions[..., 1:]
    sq = (xyz * xyz).sum(-1, keepdim=True)
    small = sq < 1e-12
    norms = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    half_angles = torch.atan2(norms, quaternions[..., :1])
    sin_half_over_angle = torch.where(
        small, 0.5 - sq / 12.0, torch.sin(half_angles) / (2.0 * half_angles)
    )
    return xyz / sin_half_over_angle


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> axis-angle vectors (..., 3)."""
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))



def _axis_rotation(axis: str, angle: torch.Tensor) -> torch.Tensor:
    cos, sin = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    if axis == "X":
        flat = (one, zero, zero, zero, cos, -sin, zero, sin, cos)
    elif axis == "Y":
        flat = (cos, zero, sin, zero, one, zero, -sin, zero, cos)
    elif axis == "Z":
        flat = (cos, -sin, zero, sin, cos, zero, zero, zero, one)
    else:
        raise ValueError(f"invalid axis {axis}")
    return torch.stack(flat, dim=-1).reshape(angle.shape + (3, 3))


def _check_convention(convention: str) -> None:
    if len(convention) != 3 or any(c not in "XYZ" for c in convention):
        raise ValueError(f"invalid convention {convention}")


def euler_angles_to_matrix(euler_angles: torch.Tensor, convention: str) -> torch.Tensor:
    """Euler angles (..., 3) in the given convention ("XYZ", "ZYX", ...;
    the matrix of the first axis applied last) -> matrices (..., 3, 3)."""
    _check_convention(convention)
    m = [_axis_rotation(axis, euler_angles[..., i]) for i, axis in enumerate(convention)]
    return m[0] @ m[1] @ m[2]


def _angle_from_tan(axis: str, other_axis: str, data: torch.Tensor, horizontal: bool,
                    tait_bryan: bool) -> torch.Tensor:
    i1, i2 = {"X": (2, 1), "Y": (0, 2), "Z": (1, 0)}[axis]
    if horizontal:
        i2, i1 = i1, i2
    even = (axis + other_axis) in ("XY", "YZ", "ZX")
    if horizontal == even:
        return torch.atan2(data[..., i1], data[..., i2])
    if tait_bryan:
        return torch.atan2(-data[..., i2], data[..., i1])
    return torch.atan2(data[..., i2], -data[..., i1])


def matrix_to_euler_angles(matrix: torch.Tensor, convention: str) -> torch.Tensor:
    """Matrices (..., 3, 3) -> Euler angles (..., 3) in the given convention."""
    _check_convention(convention)
    i0 = "XYZ".index(convention[0])
    i2 = "XYZ".index(convention[2])
    tait_bryan = i0 != i2
    if tait_bryan:
        sign = -1.0 if i0 - i2 in (-1, 2) else 1.0
        central = torch.asin(torch.clamp(matrix[..., i0, i2] * sign, -1.0, 1.0))
    else:
        central = torch.acos(torch.clamp(matrix[..., i0, i0], -1.0, 1.0))
    o0 = _angle_from_tan(convention[0], convention[1], matrix[..., i2], False, tait_bryan)
    o2 = _angle_from_tan(convention[2], convention[1], matrix[..., i0, :], True, tait_bryan)
    return torch.stack([o0, central, o2], dim=-1)

def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of quaternions (..., 4), wxyz."""
    aw, ax, ay, az = torch.unbind(a, -1)
    bw, bx, by, bz = torch.unbind(b, -1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quaternion_invert(quaternion: torch.Tensor) -> torch.Tensor:
    """The conjugate (the inverse of a unit quaternion)."""
    return quaternion * quaternion.new_tensor([1.0, -1.0, -1.0, -1.0])


def quaternion_apply(quaternion: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Rotate points (..., 3) by quaternions (..., 4): q p q^-1."""
    point_q = torch.cat([torch.zeros_like(point[..., :1]), point], dim=-1)
    out = quaternion_multiply(quaternion_multiply(quaternion, point_q),
                              quaternion_invert(quaternion))
    return out[..., 1:]
