"""Synthetic motion data (the port's copy of the clip generator of
regennet_tpu/data/synthetic.py).

Clips follow the on-disk contract of the NTU120-AS / Chi3D archives:
[T, V+1, C] with the root translation in the last row and the label in
the key name. `make_clips` returns them in memory (for Feeder(clips=...));
`write_dataset` / `make_dataset_pair` write h5 files (h5py imported only
there). `learnable=True` gives clips whose action is learnable from the
motion (make_action_clip). `write_humanact12_pkl` and `write_uestc_assets`
write the single-person archives (pickle and text files, no h5py) that
data/legacy_a2m.py reads. Same seed, same clips and files as the JAX
package's generator.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

NUM_ACTIONS = {"chi3d": 8, "ntu": 26, "gta": 1}


def _smooth_noise(rng, shape, smooth=9):
    x = rng.normal(size=shape).astype(np.float32)
    kernel = np.ones(smooth) / smooth
    return np.apply_along_axis(
        lambda v: np.convolve(v, kernel, mode="same"), 0, x
    ).astype(np.float32)


def make_clip(rng, length: int, njoints: int = 55, num_person: int = 2):
    """[T, njoints+1, 3*num_person]: axis-angle per joint + translation row."""
    C = 3 * num_person
    pose = _smooth_noise(rng, (length, njoints, C)) * 0.4
    transl = np.cumsum(_smooth_noise(rng, (length, 1, C)) * 0.02, axis=0)
    transl += rng.normal(size=(1, 1, C)).astype(np.float32)
    return np.concatenate([pose, transl], axis=1)


_AXES_CACHE: dict = {}


def _fixed_joint_axes(njoints: int) -> np.ndarray:
    """Per-joint oscillation axes, FIXED across the whole dataset.

    A per-CLIP random axis makes every clip's channel pattern unique, and
    a classifier then memorizes clips instead of learning the per-action
    dynamics (measured: ST-GCN train acc 1.0 / test acc 0.25). Fixing the
    axes keeps channel structure consistent; per-clip variation lives in
    the phases and the noise."""
    axes = _AXES_CACHE.get(njoints)
    if axes is None:
        r = np.random.default_rng(12345)
        axes = r.normal(size=(njoints, 3)).astype(np.float32)
        axes /= np.linalg.norm(axes, axis=1, keepdims=True) + 1e-8
        _AXES_CACHE[njoints] = axes
    return axes


def make_action_clip(rng, length: int, action: int, num_actions: int,
                     njoints: int = 55, num_person: int = 2):
    """Action-CONDITIONED clip [T, njoints+1, 3*num_person]: per-action
    distinct dynamics, so the label is learnable FROM the motion.

    `make_clip` above assigns labels independent of the motion (fine for
    shape/protocol tests, useless for capability studies: an evaluator
    trained on it classifies at exact chance). Here each action carries
    three signatures, all of which survive the data path (conseq frame
    windows with random shift, whole-clip axis-angle->rot6d conversion,
    per-clip first-frame translation re-basing — data/feeder.py):

    * frequency: joints oscillate sinusoidally at a per-action frequency
      (band-separated below Nyquist, resolvable inside a >=24-frame
      window) along dataset-fixed per-joint axes, with a per-action
      spatial amplitude profile over the joints (a graph-conv-readable
      cue);
    * interaction: the REACTOR (person 2 / channels 3:6 — the diffusion
      target under ccollate's channel split) answers at the same
      frequency with an action-dependent phase lag and amplitude, sharing
      the actor's random per-clip joint phases — its motion is coupled to
      the actor's, like the reference task (reaction synthesis);
    * direction: the reactor holds an action-dependent bearing from the
      actor and pulses toward/away from it, while the actor drifts on an
      action-dependent heading.

    The actor's signature is deliberately MILD and the reactor's STRONG:
    a classifier on concat(cmotion, sample) (the eval-protocol input,
    reference: eval/a2m/stgcn_eval.py:71) must rely on the reactor half,
    keeping generated-reaction metrics sensitive to what the CMDM
    actually synthesises.
    """
    if num_person != 2:
        raise ValueError("make_action_clip models an actor/reactor pair")
    t = np.arange(length, dtype=np.float32)[:, None]  # [T, 1]
    # per-action constants
    omega = 0.25 + 2.1 * (action + 0.5) / num_actions  # rad/frame, < pi
    lag = np.pi * (action + 1.0) / (num_actions + 1.0)
    amp_re = 0.35 + 0.15 * (action % 2)
    heading = 2.0 * np.pi * action / num_actions
    bearing = 2.0 * np.pi * (action + 0.5) / num_actions
    # per-clip randomness (shared by both persons: the coupling the CMDM
    # must pick up from the actor condition); axes and the per-action
    # spatial profile are dataset constants so the channel structure is
    # consistent across clips
    phase = rng.uniform(0.0, 2.0 * np.pi, size=(1, njoints)).astype(
        np.float32
    )
    axis = _fixed_joint_axes(njoints)
    j = np.arange(njoints, dtype=np.float32)
    profile = 0.35 + 0.65 * (
        0.5 + 0.5 * np.cos(2.0 * np.pi * (action + 1.0) * j / njoints)
    )  # [V] — which joints move strongly is itself an action signature

    def person_pose(amp, extra_lag, noise_scale, sub):
        osc = np.sin(omega * t + phase + extra_lag) * profile[None]  # [T,V]
        pose = amp * osc[:, :, None] * axis[None]  # [T, V, 3]
        return pose + noise_scale * _smooth_noise(sub, (length, njoints, 3))

    pose_actor = person_pose(0.12, 0.0, 0.18, rng)
    pose_react = person_pose(amp_re, lag, 0.10, rng)

    # translations: actor drifts on its heading; reactor sits at an
    # action-dependent bearing from the actor and pulses radially
    dir_a = np.array([np.cos(heading), 0.0, np.sin(heading)], np.float32)
    dir_b = np.array([np.cos(bearing), 0.15, np.sin(bearing)], np.float32)
    base = rng.normal(size=(1, 3)).astype(np.float32)
    tr_actor = (
        base + 0.01 * t * dir_a[None]
        + 0.05 * _smooth_noise(rng, (length, 3))
    )
    radial = 0.8 + 0.3 * np.sin(0.5 * omega * t[:, 0] + lag)  # [T]
    tr_react = (
        tr_actor + radial[:, None] * dir_b[None]
        + 0.05 * _smooth_noise(rng, (length, 3))
    )

    pose = np.concatenate([pose_actor, pose_react], axis=2)  # [T, V, 6]
    transl = np.concatenate([tr_actor, tr_react], axis=1)[:, None]  # [T,1,6]
    return np.concatenate([pose, transl], axis=1).astype(np.float32)


def clip_key(dataname: str, split: str, i: int, action: int) -> str:
    """Key name that encodes the label the way the real archives do."""
    if dataname == "ntu":
        return f"S001C001P{i:03d}R001A{action + 1:03d}"
    if dataname == "chi3d":
        return f"s{i:03d}_{split}_{action}"
    return f"clip{i:04d}_{action}"


def make_clips(dataname: str = "chi3d", split: str = "train",
               num_clips: int = 16, min_len: int = 40, max_len: int = 200,
               njoints: int = 55, num_person: int = 2,
               seed: int = 0, learnable: bool = False) -> Dict[str, np.ndarray]:
    """{key: clip} with action i % num_actions for clip i; `learnable`
    gives make_action_clip's action-conditioned clips."""
    rng = np.random.default_rng(seed + (0 if split == "train" else 1))
    num_actions = NUM_ACTIONS[dataname]
    clips = {}
    for i in range(num_clips):
        action = i % num_actions
        length = int(rng.integers(min_len, max_len))
        clips[clip_key(dataname, split, i, action)] = (
            make_action_clip(rng, length, action, num_actions, njoints, num_person)
            if learnable else make_clip(rng, length, njoints, num_person)
        )
    return clips


def _write_clips(path: str, clips: Dict[str, np.ndarray]) -> str:
    import h5py

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with h5py.File(path, "w") as f:
        for key, clip in clips.items():
            f.create_dataset(key, data=clip)
    return path


def write_dataset(path: str, dataname: str = "chi3d", split: str = "train",
                  num_clips: int = 16, **kwargs) -> str:
    return _write_clips(path, make_clips(dataname, split, num_clips, **kwargs))


def make_clip_pair(dataname: str = "chi3d", num_clips: int = 16,
                   **kwargs) -> Dict[str, Dict[str, np.ndarray]]:
    """The clips of a train/test pair, in memory: {"train": {key: clip},
    "test": {key: clip}} (num_clips and max(num_clips // 2, 4) clips)."""
    return {"train": make_clips(dataname, "train", num_clips, **kwargs),
            "test": make_clips(dataname, "test", max(num_clips // 2, 4), **kwargs)}


def make_dataset_pair(root: str, dataname: str = "chi3d", num_clips: int = 16,
                      **kwargs) -> str:
    """Write make_clip_pair's clips to {root}/{dataname}_train.h5 and
    _test.h5; returns the train path. kwargs: make_clips's (min_len,
    max_len, learnable, ...)."""
    for split, clips in make_clip_pair(dataname, num_clips, **kwargs).items():
        _write_clips(os.path.join(root, f"{dataname}_{split}.h5"), clips)
    return os.path.join(root, f"{dataname}_train.h5")


def write_humanact12_pkl(root: str, num_clips: int = 24, min_len: int = 30,
                         max_len: int = 90, seed: int = 0) -> str:
    """Synthetic HumanAct12-format pickle: poses [T, 72] axis-angle, 3-D
    joints [T, 24, 3] and labels, under {root}/humanact12poses.pkl;
    returns root."""
    import pickle

    rng = np.random.default_rng(seed)
    poses, joints, ys = [], [], []
    for i in range(num_clips):
        T = int(rng.integers(min_len, max_len))
        poses.append((_smooth_noise(rng, (T, 24, 3)) * 0.4).reshape(T, 72))
        j = _smooth_noise(rng, (T, 24, 3)) * 0.3
        j[:, 0] += np.cumsum(_smooth_noise(rng, (T, 3)) * 0.02, axis=0)
        joints.append(j)
        ys.append(i % 12)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "humanact12poses.pkl"), "wb") as f:
        pickle.dump({"poses": poses, "joints3D": joints, "y": ys}, f)
    return root


def write_uestc_assets(root: str, num_videos: int = 16, min_len: int = 30,
                       max_len: int = 80, seed: int = 0) -> str:
    """Synthetic UESTC asset layout: info/{names,num_frames_min,
    action_classes}.txt and vibe_cache_refined.pkl with [T, 72] poses,
    [T, 49, 3] VIBE joints and [T, 4] crop cameras; both camera sides, so
    the front-view rotation runs. Returns root."""
    import pickle

    from regennet_torch.data.legacy_a2m import UESTC_TRAIN_SUBJECTS

    rng = np.random.default_rng(seed)
    test_subjects = [3, 4, 5]
    names, lengths, poses, joints, cams = [], [], [], [], []
    for i in range(num_videos):
        action = i % 40
        view = i % 8  # views 0-7 (view 8 only exists for side 1)
        subject = (UESTC_TRAIN_SUBJECTS[i % 8] if i % 3 else
                   test_subjects[i % 3 - 1])
        side = 1 if i % 2 else 2
        names.append(f"a{action}_d{view}_p{subject:03d}_c{side}_color.avi")
        T = int(rng.integers(min_len, max_len))
        lengths.append(T)
        poses.append((_smooth_noise(rng, (T, 24, 3)) * 0.4).reshape(T, 72))
        joints.append(_smooth_noise(rng, (T, 49, 3)) * 0.3)
        cams.append(np.concatenate(
            [rng.uniform(0.5, 2.0, size=(T, 2)), _smooth_noise(rng, (T, 2))],
            axis=1).astype(np.float32))
    info = os.path.join(root, "info")
    os.makedirs(info, exist_ok=True)
    with open(os.path.join(info, "names.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    with open(os.path.join(info, "num_frames_min.txt"), "w") as f:
        f.write("\n".join(str(n) for n in lengths) + "\n")
    with open(os.path.join(info, "action_classes.txt"), "w") as f:
        f.write("\n".join(f"uestc_class_{i}" for i in range(40)) + "\n")
    with open(os.path.join(root, "vibe_cache_refined.pkl"), "wb") as f:
        pickle.dump({"pose": poses, "joints3d": joints, "orig_cam": cams}, f)
    return root
