"""HumanML3D RIC motion representation -> 3-D joints, in torch (the decode
half of regennet_tpu/data/humanml/motion_process.py).

The 263-dim HumanML3D feature vector (251 for KIT) packs [root rot-vel(1),
root lin-vel-xz(2), root height(1), RIC joint positions((J-1)*3), 6d
rotations((J-1)*6), local velocities(J*3), foot contacts(4)]. These
functions recover world joints (and forward-kinematic joints from
rotations) from that vector: `sample.generate` decodes its humanml/kit
samples with `recover_from_ric`. The extraction half (raw joints -> RIC
features, which needs the skeleton) is not ported.
"""

from __future__ import annotations

import torch

from regennet_torch.ops import rotations as geo

# standard HumanML3D (t2m) 22-joint kinematic chains
T2M_KINEMATIC_CHAIN = [
    [0, 2, 5, 8, 11],
    [0, 1, 4, 7, 10],
    [0, 3, 6, 9, 12, 15],
    [9, 14, 17, 19, 21],
    [9, 13, 16, 18, 20],
]
KIT_KINEMATIC_CHAIN = [
    [0, 11, 12, 13, 14, 15],
    [0, 16, 17, 18, 19, 20],
    [0, 1, 2, 3, 4],
    [3, 5, 6, 7],
    [3, 8, 9, 10],
]


def _y_rotation_quat(angle: torch.Tensor) -> torch.Tensor:
    """wxyz quaternion for a rotation of `angle` about the Y axis."""
    zeros = torch.zeros_like(angle)
    return torch.stack([torch.cos(angle), zeros, torch.sin(angle), zeros], dim=-1)


def recover_root_rot_pos(data: torch.Tensor):
    """data [..., T, F] -> (root Y-rotation quats [..., T, 4], root pos
    [..., T, 3]); integrates the stored rotational and planar velocities."""
    rot_vel = data[..., 0]
    r_rot_ang = torch.cumsum(
        torch.cat([torch.zeros_like(rot_vel[..., :1]), rot_vel[..., :-1]], dim=-1), dim=-1)
    r_rot_quat = _y_rotation_quat(r_rot_ang)

    vel_xz = torch.cat([torch.zeros_like(data[..., :1, 1:3]), data[..., :-1, 1:3]], dim=-2)
    r_vel = torch.stack([vel_xz[..., 0], torch.zeros_like(vel_xz[..., 0]), vel_xz[..., 1]],
                        dim=-1)
    # rotate the per-frame planar velocity into world frame, then integrate
    r_vel = geo.quaternion_apply(geo.quaternion_invert(r_rot_quat), r_vel)
    r_pos = torch.cumsum(r_vel, dim=-2)
    r_pos = torch.cat([r_pos[..., :1], data[..., 3:4], r_pos[..., 2:]], dim=-1)  # height
    return r_rot_quat, r_pos


def recover_from_ric(data: torch.Tensor, joints_num: int) -> torch.Tensor:
    """Rotation-invariant-coordinate features -> world joints
    [..., T, joints_num, 3]."""
    r_rot_quat, r_pos = recover_root_rot_pos(data)
    positions = data[..., 4:(joints_num - 1) * 3 + 4]
    positions = positions.reshape(positions.shape[:-1] + (joints_num - 1, 3))
    inv = geo.quaternion_invert(r_rot_quat)[..., None, :]
    positions = geo.quaternion_apply(inv.expand(positions.shape[:-1] + (4,)), positions)
    offset = torch.stack([r_pos[..., 0], torch.zeros_like(r_pos[..., 1]), r_pos[..., 2]],
                         dim=-1)
    positions = positions + offset[..., None, :]
    return torch.cat([r_pos[..., None, :], positions], dim=-2)


def quaternion_to_cont6d(quaternions: torch.Tensor) -> torch.Tensor:
    """wxyz quats -> the humanml cont6d representation: the rotation
    matrix's first two COLUMNS (unlike the pytorch3d rot6d convention of
    the a2m pose representations, its first two ROWS)."""
    mat = geo.quaternion_to_matrix(quaternions)
    return torch.cat([mat[..., :, 0], mat[..., :, 1]], dim=-1)


def cont6d_to_matrix(cont6d: torch.Tensor) -> torch.Tensor:
    """humanml cont6d (two columns) -> rotation matrix via Gram-Schmidt."""
    x_raw, y_raw = cont6d[..., 0:3], cont6d[..., 3:6]
    x = x_raw / torch.linalg.vector_norm(x_raw, dim=-1, keepdim=True)
    z = torch.linalg.cross(x, y_raw, dim=-1)
    z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1)  # columns


def recover_rot6d(data: torch.Tensor, joints_num: int) -> torch.Tensor:
    """The per-joint continuous-6d rotations [..., T, J, 6] (humanml column
    convention) with the root's Y rotation folded in as joint 0."""
    r_rot_quat, _ = recover_root_rot_pos(data)
    start = 4 + (joints_num - 1) * 3
    rots = data[..., start:start + (joints_num - 1) * 6]
    rots = rots.reshape(rots.shape[:-1] + (joints_num - 1, 6))
    root6d = quaternion_to_cont6d(r_rot_quat)
    return torch.cat([root6d[..., None, :], rots], dim=-2)


def recover_from_rot(data: torch.Tensor, joints_num: int, offsets,
                     kinematic_chain=T2M_KINEMATIC_CHAIN) -> torch.Tensor:
    """Forward kinematics from the stored cont6d rotations and bone offsets
    [J, 3]: the accumulated global rotation, the child's local rotation
    included, is applied to the child's rest offset."""
    _, r_pos = recover_root_rot_pos(data)
    rotmats = cont6d_to_matrix(recover_rot6d(data, joints_num))  # [..., T, J, 3, 3]
    offsets = torch.as_tensor(offsets, dtype=data.dtype, device=data.device)

    joints = [None] * joints_num
    glob = [None] * joints_num
    joints[0] = r_pos
    glob[0] = rotmats[..., 0, :, :]
    for chain in kinematic_chain:
        for parent, child in zip(chain[:-1], chain[1:]):
            glob[child] = glob[parent] @ rotmats[..., child, :, :]
            joints[child] = joints[parent] + torch.einsum(
                "...ij,j->...i", glob[child], offsets[child])
    return torch.stack(joints, dim=-2)
