"""The port's HumanML3D preprocessing against the JAX package's: the Euler
conversions of regennet_torch/ops/rotations.py, the skeleton
(data/humanml/skeleton.py: quaternion helpers, IK, FK) and the extraction
half of data/humanml/motion_process.py (process_file, extract_features,
compute_feature_stats, the build CLI with --device cpu), on
tests/test_humanml_extract.py's synthetic motions, for humanml and kit.

The numpy stages are copies of the JAX package's and agree to 1e-6; the
CLI's recovered joints come from torch's recover_from_ric against jnp's,
within 1e-5 x max(1, max|jax|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regennet_torch.data.humanml import motion_process as mp
from regennet_torch.data.humanml import skeleton as sk
from regennet_torch.ops import rotations
from regennet_tpu.data.humanml import motion_process as jmp
from regennet_tpu.data.humanml import skeleton as jsk
from regennet_tpu.ops import rotations as jrotations
from tests.test_humanml_extract import _synthetic_motion


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _kit_motion(T=16, seed=0):
    """A KIT-skeleton joint sequence: small random local rotations FK'd
    through the KIT template at unequal bone lengths (tests/
    test_humanml_extract.py::TestProcessFile::test_kit_dims, with a moving
    root)."""
    rng = np.random.default_rng(seed)
    skel = jsk.make_skeleton("kit")
    offsets = jsk.KIT_RAW_OFFSETS * (0.25 * (1.0 + 0.4 * np.arange(21) / 21.0))[:, None]
    offsets[0] = 0
    skel.set_offset(offsets)
    q = np.tile(np.array([1.0, 0, 0, 0]), (T, 21, 1)) + 0.05 * rng.normal(size=(T, 21, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    root = np.stack([np.linspace(0, 0.4, T), np.full(T, 0.8), np.linspace(0, 0.8, T)], -1)
    return skel.forward_kinematics(q.astype(np.float32), root.astype(np.float32))


MOTIONS = {"humanml": lambda seed=0: _synthetic_motion(T=24, seed=seed),
           "kit": lambda seed=0: _kit_motion(seed=seed)}


def _close(ours, ref, what=""):
    ref = np.asarray(ref)
    assert np.shape(ours) == ref.shape, what
    err = float(np.abs(np.asarray(ours) - ref).max())
    assert err <= 1e-5 * max(1.0, float(np.abs(ref).max())), (what, err)


@pytest.mark.parametrize("convention", ["XYZ", "ZYX", "YXZ", "XZY", "XYX", "ZXZ"])
def test_euler_angles_match_jax(convention):
    rng = np.random.default_rng(0)
    angles = rng.uniform(-1.4, 1.4, size=(7, 3)).astype(np.float32)
    mats = rotations.euler_angles_to_matrix(torch.tensor(angles), convention)
    _close(mats, jrotations.euler_angles_to_matrix(jnp.asarray(angles), convention))
    back = rotations.matrix_to_euler_angles(mats, convention)
    _close(back, jrotations.matrix_to_euler_angles(jnp.asarray(mats.numpy()), convention))
    # the angles come back within the convention's principal range
    _close(rotations.euler_angles_to_matrix(back, convention), mats)
    with pytest.raises(ValueError, match="invalid convention"):
        rotations.matrix_to_euler_angles(mats, convention[:2])


def test_quaternion_helpers_match_jax():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(6, 3, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    r = rng.normal(size=(6, 3, 4))
    v = rng.normal(size=(6, 3, 3))
    for name, args in (("qmul", (q, r)), ("qinv", (q,)), ("qrot", (q, v)),
                       ("qbetween", (v, v[::-1])), ("qfix", (q,)),
                       ("quaternion_to_matrix", (q,)), ("quaternion_to_cont6d", (q,)),
                       ("cont6d_to_matrix", (jsk.quaternion_to_cont6d(q),))):
        np.testing.assert_allclose(getattr(sk, name)(*args), getattr(jsk, name)(*args),
                                   rtol=0, atol=1e-12, err_msg=name)
    for table in ("T2M_RAW_OFFSETS", "KIT_RAW_OFFSETS", "T2M_FACE_JOINTS", "KIT_FACE_JOINTS",
                  "T2M_FEET", "KIT_FEET"):
        assert str(getattr(sk, table)) == str(getattr(jsk, table)), table


@pytest.mark.parametrize("dataset", ["humanml", "kit"])
def test_skeleton_ik_and_fk_match_jax(dataset):
    positions = MOTIONS[dataset]()
    face = sk.T2M_FACE_JOINTS if dataset == "humanml" else sk.KIT_FACE_JOINTS
    ours, ref = sk.make_skeleton(dataset), jsk.make_skeleton(dataset)
    assert ours.parents == ref.parents
    np.testing.assert_allclose(ours.get_offsets_joints(positions[0]),
                               ref.get_offsets_joints(positions[0]), rtol=0, atol=1e-7)
    for smooth in (False, True):
        quat = ours.inverse_kinematics(positions, face, smooth_forward=smooth)
        np.testing.assert_allclose(quat, ref.inverse_kinematics(positions, face,
                                                                smooth_forward=smooth),
                                   rtol=0, atol=1e-6)
    fk = ours.forward_kinematics(quat, positions[:, 0])
    np.testing.assert_allclose(fk, ref.forward_kinematics(quat, positions[:, 0]),
                               rtol=0, atol=1e-6)
    cont6d = sk.quaternion_to_cont6d(quat)
    np.testing.assert_allclose(ours.forward_kinematics_cont6d(cont6d, positions[:, 0]),
                               ref.forward_kinematics_cont6d(cont6d, positions[:, 0]),
                               rtol=0, atol=1e-5)
    if dataset == "humanml":  # IK then FK rebuilds the motion
        np.testing.assert_allclose(fk, positions, atol=2e-2)


@pytest.mark.parametrize("dataset", ["humanml", "kit"])
def test_process_file_and_extract_features_match_jax(dataset):
    positions = MOTIONS[dataset]()
    target = MOTIONS[dataset](seed=3)[0]
    tgt_offsets = jsk.make_skeleton(dataset).get_offsets_joints(target)
    ours = mp.process_file(positions, dataset_name=dataset, tgt_offsets=tgt_offsets)
    ref = jmp.process_file(positions, dataset_name=dataset, tgt_offsets=tgt_offsets)
    for i, (a, b) in enumerate(zip(ours, ref)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=f"output {i}")
    assert ours[0].shape == (len(positions) - 1, 263 if dataset == "humanml" else 251)
    feet = sk.T2M_FEET if dataset == "humanml" else sk.KIT_FEET
    for a, b in zip(mp.extract_features(ours[1], feet["feet_thre"], dataset),
                    jmp.extract_features(ours[1], feet["feet_thre"], dataset)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    # the features recover the normalised joints, in torch as in jnp
    rec = mp.recover_from_ric(torch.tensor(ours[0]), ours[1].shape[1]).numpy()
    _close(rec, jmp.recover_from_ric(jnp.asarray(ours[0]), ours[1].shape[1]))
    if dataset == "humanml":
        np.testing.assert_allclose(rec, ours[1][:-1], atol=5e-3)


def test_compute_feature_stats_matches_jax():
    feats = [mp.process_file(_synthetic_motion(T=16, seed=s), dataset_name="humanml")[0]
             for s in range(3)]
    for a, b in zip(mp.compute_feature_stats(feats, 22), jmp.compute_feature_stats(feats, 22)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dataset", ["humanml", "kit"])
def test_build_cli_on_the_cpu_matches_jax(tmp_path, dataset):
    joints_dir = tmp_path / "joints"
    joints_dir.mkdir()
    for i in range(3):
        np.save(joints_dir / f"{i:06d}.npy", MOTIONS[dataset](seed=i))
    np.save(joints_dir / "000003.npy", np.full((16, 22, 3), np.nan, np.float32))  # skipped
    argv = ["--joints_dir", str(joints_dir), "--example_id", "000000", "--dataset", dataset]
    frames = mp._cli(argv + ["--out_dir", str(tmp_path / "ours"), "--device", "cpu"])
    jmp.build_dataset(str(joints_dir), str(tmp_path / "jax"), "000000", dataset)
    T = len(MOTIONS[dataset]())
    assert frames == 3 * (T - 1)
    for sub in ("new_joint_vecs", "new_joints"):
        names = sorted(p.name for p in (tmp_path / "ours" / sub).glob("*.npy"))
        assert names == sorted(p.name for p in (tmp_path / "jax" / sub).glob("*.npy"))
        assert names == [f"{i:06d}.npy" for i in range(3)]
        for name in names:
            ours, ref = (np.load(tmp_path / d / sub / name) for d in ("ours", "jax"))
            if sub == "new_joint_vecs":
                np.testing.assert_array_equal(ours, ref)
            else:
                _close(ours, ref, name)
    for stat in ("Mean.npy", "Std.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "ours" / stat),
                                      np.load(tmp_path / "jax" / stat))
