"""Build SMPL-X h5 motion archives from PyMAF-X tracking output: `python -m
regennet_torch.preprocess.prepare_data --src <root> --dest out.h5` (the
port's copy of regennet_tpu/preprocess/prepare_data.py).

Per clip (`<class>/<seq>/output.pkl`, camera 1 only), the per-frame SMPL-X
rotation matrices (22 body joints with the global orient, jaw, eyes, 15 +
15 hand joints) become axis-angle; the global orient and the camera-space
translation are rotated into the canonical frame (-view x 45 degrees about
x); and the clip is packed [T, 56, 3 * 2] with the translation in the
last row, the layout the Feeder reads. Host numpy and h5py; the geometry
on the port's ops/rotations.py (on the CPU); joblib reads the pickles.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from regennet_torch.ops import rotations as geo


def get_rotation(view: int) -> np.ndarray:
    """The canonicalising rotation: -view * 45 degrees about the x axis."""
    theta = -view * np.pi / 4
    return geo.axis_angle_to_matrix(torch.tensor([theta, 0.0, 0.0])).numpy()


def _to_aa(rm) -> np.ndarray:
    return geo.matrix_to_axis_angle(torch.as_tensor(np.asarray(rm, np.float32))).numpy()


def parse_motion_file(motion_file: str, rotation: np.ndarray) -> np.ndarray:
    """One PyMAF-X output.pkl -> [T, 56, 6] (two persons on the channels)."""
    import joblib

    data = joblib.load(motion_file)

    def cat(key, sub=None):
        return np.concatenate([np.asarray(batch[key] if sub is None else batch[key][:, sub])
                               for batch in data["smplx_params"]], axis=0)

    body_pose = cat("body_pose", np.s_[0:22])  # [N, 22, 3, 3]
    left_hand = cat("left_hand_pose")
    right_hand = cat("right_hand_pose")
    jaw = cat("jaw_pose")
    leye = cat("leye_pose")
    reye = cat("reye_pose")

    body_aa = _to_aa(body_pose)
    # the global orient in the canonical frame
    global_rm = geo.axis_angle_to_matrix(torch.as_tensor(body_aa[:, 0])).numpy()
    body_aa[:, 0] = _to_aa(rotation @ global_rm)

    root_transl = np.asarray(data["orig_cam_t"], dtype=np.float64).copy()
    root_transl[:, -1] = root_transl[:, -1] / 20
    root_transl = root_transl @ rotation.T

    max_frame = int(data["frame_ids"][-1]) + 1
    final_pose = np.zeros((2, max_frame, 56, 3), dtype=np.float32)
    if len(data["person_ids"]) != body_aa.shape[0]:
        raise ValueError(f"{motion_file}: {len(data['person_ids'])} person ids for "
                         f"{body_aa.shape[0]} poses")
    for idx, person_id in enumerate(data["person_ids"]):
        splits = person_id.split("_")
        frame_idx = int(splits[-2][1:])
        person_idx = int(splits[-1][1:])
        if person_idx > 1:
            continue
        final_pose[person_idx, frame_idx] = np.concatenate(
            (body_aa[idx], _to_aa(jaw[idx]), _to_aa(leye[idx]), _to_aa(reye[idx]),
             _to_aa(left_hand[idx]), _to_aa(right_hand[idx]), root_transl[idx, None]), axis=0)
    # [2, T, 56, 3] -> [T, 56, 6] (the persons interleaved on the channels)
    return final_pose.transpose(1, 2, 0, 3).reshape(-1, 56, 6)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--src", required=True, help="PyMAF-X output root (class/seq/output.pkl)")
    p.add_argument("--dest", required=True, help="output h5 path")
    p.add_argument("--view", default=0, type=int)
    return p.parse_args(argv)


def main(args=None):
    import h5py

    if args is None:
        args = parse_args()
    os.makedirs(os.path.dirname(args.dest) or ".", exist_ok=True)
    rotation = get_rotation(args.view)
    with h5py.File(args.dest, "w") as fw:
        for action_class in sorted(os.listdir(args.src)):
            print(action_class)
            seq_dir = os.path.join(args.src, action_class)
            for seq_name in sorted(os.listdir(seq_dir)):
                motion_file = os.path.join(seq_dir, seq_name, "output.pkl")
                if not os.path.exists(motion_file) or int(seq_name[5:8]) != 1:
                    continue
                poses = parse_motion_file(motion_file, rotation)
                fw.create_dataset(seq_name.split("_")[0], data=poses, dtype="f4")
    print(f"wrote {args.dest}")


if __name__ == "__main__":
    main()
