"""HumanML3D RIC motion representation -> 3-D joints, in torch (the decode
half of regennet_tpu/data/humanml/motion_process.py).

The 263-dim HumanML3D feature vector (251 for KIT) packs [root rot-vel(1),
root lin-vel-xz(2), root height(1), RIC joint positions((J-1)*3), 6d
rotations((J-1)*6), local velocities(J*3), foot contacts(4)]. These
functions recover world joints (and forward-kinematic joints from
rotations) from that vector: `sample.generate` decodes its humanml/kit
samples with `recover_from_ric`.

The extraction half builds a HumanML3D/KIT feature dataset from raw joint
positions (host-side numpy over data/humanml/skeleton.py: retarget, IK,
RIC features, foot contacts, the group-pooled Mean/Std):
`python -m regennet_torch.data.humanml.motion_process --joints_dir raw
--out_dir built --example_id 000000` (`--device cpu` to check each clip's
recovery on the CPU instead of the card).
"""

from __future__ import annotations

import os

import numpy as np
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


# ---------------------------------------------------------------------------
# Dataset construction: raw joint positions -> RIC feature vectors.
# Host-side numpy (offline preprocessing); the recovery check runs on a device.
# reference: data_loaders/humanml/scripts/motion_process.py:13-359,435-528
# ---------------------------------------------------------------------------


def _spec(dataset_name: str):
    from regennet_torch.data.humanml import skeleton as sk

    if dataset_name in ("humanml", "t2m"):
        return dict(joints_num=22, face=sk.T2M_FACE_JOINTS, feet=sk.T2M_FEET,
                    make=lambda: sk.make_skeleton("humanml"))
    if dataset_name == "kit":
        return dict(joints_num=21, face=sk.KIT_FACE_JOINTS, feet=sk.KIT_FEET,
                    make=lambda: sk.make_skeleton("kit"))
    raise ValueError(f"unknown dataset {dataset_name}")


def uniform_skeleton(positions, target_offset, dataset_name: str = "humanml"):
    """Retarget a joint sequence onto the target skeleton's bone lengths:
    scale the root trajectory by the leg-length ratio, then IK on the source
    and FK with the target offsets (reference: :13-37)."""
    spec = _spec(dataset_name)
    l_idx1, l_idx2 = spec["feet"]["l_idx"]
    skel = spec["make"]()
    src_offset = skel.get_offsets_joints(positions[0])
    tgt_offset = np.asarray(target_offset, np.float32)

    src_leg_len = (np.abs(src_offset[l_idx1]).max()
                   + np.abs(src_offset[l_idx2]).max())
    tgt_leg_len = (np.abs(tgt_offset[l_idx1]).max()
                   + np.abs(tgt_offset[l_idx2]).max())
    scale_rt = tgt_leg_len / src_leg_len
    tgt_root_pos = positions[:, 0] * scale_rt

    quat_params = skel.inverse_kinematics(positions, spec["face"])
    skel.set_offset(tgt_offset)
    return skel.forward_kinematics(quat_params, tgt_root_pos)


def _foot_detect(positions, thres, fid_l, fid_r):
    """Per-frame binary foot contacts from squared foot displacement
    (reference: :63-88)."""
    def contacts(fid):
        d2 = ((positions[1:, fid] - positions[:-1, fid]) ** 2).sum(-1)
        return (d2 < thres).astype(np.float32)

    return contacts(fid_l), contacts(fid_r)


def extract_features(positions, feet_thre, dataset_name: str = "humanml"):
    """Normalised joint positions [T, J, 3] -> RIC feature matrix
    [T-1, 4 + (J-1)*9 + J*3 + 4] (reference extract_features :39-166; the
    same packing process_file performs after its own normalisation)."""
    from regennet_torch.data.humanml import skeleton as sk

    spec = _spec(dataset_name)
    positions = np.asarray(positions, np.float32).copy()
    global_positions = positions.copy()

    feet_l, feet_r = _foot_detect(
        positions, feet_thre, spec["feet"]["fid_l"], spec["feet"]["fid_r"]
    )

    # cont6d joint params with a smoothed forward direction (reference
    # get_cont6d_params :255-275)
    skel = spec["make"]()
    quat_params = skel.inverse_kinematics(
        positions, spec["face"], smooth_forward=True
    )
    cont_6d_params = sk.quaternion_to_cont6d(quat_params)
    r_rot = quat_params[:, 0].copy()
    velocity = positions[1:, 0] - positions[:-1, 0]
    velocity = sk.qrot(r_rot[1:], velocity)
    r_velocity = sk.qmul(r_rot[1:], sk.qinv(r_rot[:-1]))

    # rotation-invariant local pose (reference get_rifke :231-238)
    positions[..., 0] -= positions[:, 0:1, 0]
    positions[..., 2] -= positions[:, 0:1, 2]
    positions = sk.qrot(
        np.repeat(r_rot[:, None], positions.shape[1], axis=1), positions
    )

    root_y = positions[:, 0, 1:2]
    r_velocity = np.arcsin(r_velocity[:, 2:3])  # Y-rotation half-angle rate
    l_velocity = velocity[:, [0, 2]]
    root_data = np.concatenate([r_velocity, l_velocity, root_y[:-1]], axis=-1)

    rot_data = cont_6d_params[:, 1:].reshape(len(cont_6d_params), -1)
    ric_data = positions[:, 1:].reshape(len(positions), -1)
    local_vel = sk.qrot(
        np.repeat(r_rot[:-1, None], global_positions.shape[1], axis=1),
        global_positions[1:] - global_positions[:-1],
    ).reshape(len(positions) - 1, -1)

    data = np.concatenate(
        [root_data, ric_data[:-1], rot_data[:-1], local_vel, feet_l, feet_r],
        axis=-1,
    )
    return data, global_positions, positions, l_velocity


def process_file(positions, feet_thre=None, dataset_name: str = "humanml",
                 tgt_offsets=None):
    """Raw world joints [T, J, 3] -> (features [T-1, F], ground_positions,
    rifke_positions, l_velocity) (reference process_file :169-359):
    retarget -> put on floor -> root XZ to origin -> initial pose faces Z+
    -> extract_features."""
    from regennet_torch.data.humanml import skeleton as sk

    spec = _spec(dataset_name)
    if feet_thre is None:
        feet_thre = spec["feet"]["feet_thre"]
    positions = np.asarray(positions, np.float32)[:, : spec["joints_num"]]

    if tgt_offsets is not None:
        positions = uniform_skeleton(positions, tgt_offsets, dataset_name)

    positions = positions - positions.min(axis=0).min(axis=0)[1] * np.array(
        [0.0, 1.0, 0.0], np.float32
    )
    root_pos_init = positions[0]
    positions = positions - root_pos_init[0] * np.array([1.0, 0.0, 1.0],
                                                        np.float32)

    # initial facing: note process_file unpacks face joints in the declared
    # order (r_hip first), unlike the IK quirk — reproduced exactly
    r_hip, l_hip, sdr_r, sdr_l = spec["face"]
    across = (root_pos_init[r_hip] - root_pos_init[l_hip]) + (
        root_pos_init[sdr_r] - root_pos_init[sdr_l]
    )
    across = across / np.linalg.norm(across)
    forward_init = np.cross(np.array([0.0, 1.0, 0.0]), across)
    forward_init = forward_init / np.linalg.norm(forward_init)
    root_quat_init = sk.qbetween(forward_init[None],
                                 np.array([[0.0, 0.0, 1.0]]))[0]
    positions = sk.qrot(
        np.broadcast_to(root_quat_init, positions.shape[:-1] + (4,)),
        positions,
    )

    return extract_features(positions, feet_thre, dataset_name)


def compute_feature_stats(features_list, joints_num: int):
    """Mean / group-pooled Std over all frames (the HumanML3D protocol:
    Std is averaged within each feature block so every block is scaled
    uniformly at normalisation time)."""
    all_frames = np.concatenate(features_list, axis=0)
    mean = all_frames.mean(axis=0)
    std = all_frames.std(axis=0)
    j = joints_num
    bounds = [0, 1, 3, 4, 4 + (j - 1) * 3, 4 + (j - 1) * 9,
              4 + (j - 1) * 9 + j * 3, 4 + (j - 1) * 9 + j * 3 + 4]
    for a, b in zip(bounds[:-1], bounds[1:]):
        std[a:b] = std[a:b].mean()
    return mean.astype(np.float32), (std + 1e-9).astype(np.float32)


def build_dataset(joints_dir: str, out_dir: str, example_id: str,
                  dataset_name: str = "humanml", feet_thre=None,
                  compute_stats: bool = True, fps: int = 20, device="cpu"):
    """Build new_joints/ + new_joint_vecs/ (+ Mean/Std) from a directory of
    raw [T, J(, 3)] joint .npy files (reference __main__ :435-528). Each
    clip's features are recovered to joints by `recover_from_ric` on
    `device` (new_joints/ holds them); a clip that fails, or recovers to
    NaN, is skipped and named, as the reference skips it."""
    spec = _spec(dataset_name)
    j = spec["joints_num"]
    skel = spec["make"]()
    example = np.load(os.path.join(joints_dir, example_id + ".npy"))
    example = example.reshape(len(example), -1, 3)
    tgt_offsets = skel.get_offsets_joints(example[0])

    os.makedirs(os.path.join(out_dir, "new_joints"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "new_joint_vecs"), exist_ok=True)
    frame_num, features = 0, []
    names = sorted(f for f in os.listdir(joints_dir) if f.endswith(".npy"))
    for name in names:
        raw = np.load(os.path.join(joints_dir, name))
        raw = raw.reshape(len(raw), -1, 3)[:, :j]
        try:
            data, _, _, _ = process_file(
                raw, feet_thre, dataset_name, tgt_offsets
            )
            rec = recover_from_ric(torch.as_tensor(data, device=device), j).cpu().numpy()
            if np.isnan(rec).any():
                print(f"skipping {name}: NaN in recovery", flush=True)
                continue
            np.save(os.path.join(out_dir, "new_joints", name), rec)
            np.save(os.path.join(out_dir, "new_joint_vecs", name), data)
            features.append(data)
            frame_num += data.shape[0]
        except Exception as e:  # noqa: BLE001  (reference skips bad clips)
            print(f"skipping {name}: {e}", flush=True)
    if compute_stats and features:
        mean, std = compute_feature_stats(features, j)
        np.save(os.path.join(out_dir, "Mean.npy"), mean)
        np.save(os.path.join(out_dir, "Std.npy"), std)
    print(
        f"Total clips: {len(features)}, Frames: {frame_num}, "
        f"Duration: {frame_num / fps / 60:.4f}m", flush=True,
    )
    return frame_num


def _cli(argv=None):
    import argparse

    from regennet_torch.device import resolve_device
    from regennet_torch.utils.parser_util import device_arg

    p = argparse.ArgumentParser(
        description="Build RIC feature datasets from raw joints "
        "(reference: scripts/motion_process.py __main__)"
    )
    p.add_argument("--joints_dir", required=True, type=str)
    p.add_argument("--out_dir", required=True, type=str)
    p.add_argument("--example_id", required=True, type=str,
                   help="clip id providing the target skeleton offsets")
    p.add_argument("--dataset", default="humanml", choices=["humanml", "kit"])
    p.add_argument("--feet_thre", default=None, type=float)
    p.add_argument("--no_stats", action="store_true")
    p.add_argument("--device", default=0, type=device_arg,
                   help="CUDA device id of the recovery check, or 'cpu'")
    args = p.parse_args(argv)
    return build_dataset(args.joints_dir, args.out_dir, args.example_id,
                         args.dataset, args.feet_thre,
                         compute_stats=not args.no_stats,
                         device=resolve_device(None, args.device))


if __name__ == "__main__":
    _cli()
