"""preprocess/{actor_reactor,split_2p,prepare_data}.py of regennet_torch
against the JAX package's, on the CPU on synthetic files: the same h5
archives key for key (prepare_data's geometry f32 within 1e-5 x max(1,
max|jax|)), from two-person clips with order labels, an NTU-style archive,
and PyMAF-X-style pickles written by joblib.
"""

import os
from argparse import Namespace

import numpy as np
import pytest

from regennet_tpu.preprocess import actor_reactor as jactor_reactor
from regennet_tpu.preprocess import prepare_data as jprepare
from regennet_tpu.preprocess import split_2p as jsplit
from regennet_torch.preprocess import actor_reactor, prepare_data, split_2p
from tests.test_torch_actor_cvae import close

h5py = pytest.importorskip("h5py")


def _same_archives(a, b, scale=None):
    with h5py.File(a) as fa, h5py.File(b) as fb:
        assert sorted(fa) == sorted(fb) and len(fa) > 0
        for key in fb:
            if scale is None:
                np.testing.assert_array_equal(fa[key][()], fb[key][()], err_msg=key)
            else:
                close(fa[key][()], fb[key][()], scale=scale, what=key)


def test_actor_reactor_matches_jax(tmp_path):
    src = tmp_path / "src.h5"
    labels = tmp_path / "labels"
    labels.mkdir()
    rng = np.random.default_rng(0)
    with h5py.File(src, "w") as f:
        for name, label in [("clipA", 0), ("clipB", 1), ("clipC", 1)]:
            f.create_dataset(name, data=rng.normal(size=(5, 56, 6)).astype(np.float32))
            (labels / f"{name}.mp4.txt").write_text(f"{label}\n")
    actor_reactor.main(actor_reactor.parse_args(["--src", str(src), "--dest",
                                                 str(tmp_path / "o.h5"), "--label_folder",
                                                 str(labels)]))
    jactor_reactor.main(Namespace(src=str(src), dest=str(tmp_path / "j.h5"),
                                  label_folder=str(labels)))
    _same_archives(tmp_path / "o.h5", tmp_path / "j.h5")


def test_split_2p_matches_jax(tmp_path):
    src = tmp_path / "ntu.h5"
    rng = np.random.default_rng(0)
    with h5py.File(src, "w") as f:
        for name in ["S001C001P001R001A050", "S001C001P003R001A050", "S001C001P001R001A010",
                     "S001C001P001R001A106", "S002C002P008R002A120", "S003C001P103R001A060"]:
            f.create_dataset(name, data=rng.normal(size=(5, 56, 6)))
    split_2p.main(split_2p.parse_args(["-d", str(src), "-o", str(tmp_path / "o")]))
    jsplit.main(Namespace(data_path=str(src), out_path=str(tmp_path / "j")))
    for split in ("train", "test"):
        _same_archives(tmp_path / "o" / f"xsub.{split}.h5", tmp_path / "j" / f"xsub.{split}.h5")
    with h5py.File(tmp_path / "o" / "xsub.train.h5") as f:
        assert sorted(f) == ["S001C001P001R001A001", "S001C001P001R001A012",
                             "S002C002P008R002A026", "S003C001P103R001A011"]


def _rotations(rng, shape):
    """Random rotation matrices [..., 3, 3] (QR of normal draws)."""
    q, r = np.linalg.qr(rng.normal(size=shape + (3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[..., None, :]
    det = np.linalg.det(q)
    q[..., :, 0] *= det[..., None]
    return q.astype(np.float32)


def _write_pymafx(path, rng, frames=3):
    import joblib

    ids = [f"seq_f{t:06d}_p{p}" for t in range(frames) for p in (0, 1, 2)]
    n = len(ids)
    half = n // 2
    batches = []
    for lo, hi in ((0, half), (half, n)):
        m = hi - lo
        batches.append({"body_pose": _rotations(rng, (m, 24)), "jaw_pose": _rotations(rng, (m, 1)),
                        "leye_pose": _rotations(rng, (m, 1)), "reye_pose": _rotations(rng, (m, 1)),
                        "left_hand_pose": _rotations(rng, (m, 15)),
                        "right_hand_pose": _rotations(rng, (m, 15))})
    os.makedirs(os.path.dirname(path), exist_ok=True)
    joblib.dump({"smplx_params": batches, "orig_cam_t": rng.normal(size=(n, 3)),
                 "frame_ids": np.arange(frames), "person_ids": ids}, path)


def test_prepare_data_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    root = tmp_path / "pymafx"
    # <name>_<camera id in [5:8]>_...: camera 1 is kept
    for cls, seq in [("A001", "seqA_001_x"), ("A001", "seqB_002_x"), ("A002", "seqC_001_y")]:
        _write_pymafx(str(root / cls / seq / "output.pkl"), rng)
    for view in (0, 3):
        close(prepare_data.get_rotation(view), jprepare.get_rotation(view))
        ours, ref = tmp_path / f"o{view}.h5", tmp_path / f"j{view}.h5"
        prepare_data.main(prepare_data.parse_args(["--src", str(root), "--dest", str(ours),
                                                   "--view", str(view)]))
        jprepare.main(Namespace(src=str(root), dest=str(ref), view=view))
        _same_archives(ours, ref, scale=1e-5)
        with h5py.File(ours) as f:
            assert sorted(f) == ["seqA", "seqC"] and f["seqA"].shape == (3, 56, 6)
