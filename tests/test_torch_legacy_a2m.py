"""regennet_torch's single-person a2m modules against the JAX package's.

* the synthetic writers write the same files; the HumanAct12 and UESTC
  items (rot6d and xyz; UESTC's test and train splits over both camera
  sides, so the side-2 front-view rotation runs; HumanAct12 with
  align_pose_frontview) and their `collate` batches are bit-equal under
  the same `random` stream, and so are the shuffle streams;
* the GRU classifier on weights carried from flax
  (gru_classifier_state_dict_from_flax) and on a released-layout file
  that both packages read: features, hidden state and logits within
  1e-5 x max(1, max|jax|), with lengths shorter than T;
* the unconstrained openpose ST-GCN and the single-person UESTC ST-GCN
  on weights carried by stgcn_state_dict_from_flax, and the openpose one
  from a released-layout file: features and logits within 1e-5 x
  max(1, max|jax|); the openpose graph equal;
* KID, precision / recall and diversity: equal from the same features;
* compute_accuracy's confusion matrices: equal to the JAX package's on
  the same clips and classifier weights; its CLI end to end on the CPU.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regennet_tpu.convert.torch_ckpt import (
    convert_gru_classifier,
    convert_stgcn,
    load_torch_state_dict,
)
from regennet_tpu.data import synthetic as jsynthetic
from regennet_tpu.data.collate import collate as jcollate
from regennet_tpu.data.get_data import get_dataset as jget_dataset
from regennet_tpu.eval import compute_accuracy as jca
from regennet_tpu.eval import unconstrained as JU
from regennet_tpu.models.gru_classifier import MotionDiscriminator as JMotionDiscriminator
from regennet_tpu.models.stgcn import STGCN as JSTGCN
from regennet_tpu.models.stgcn import make_unconstrained_stgcn as jmake_unconstrained
from regennet_tpu.models.stgcn_graph import Graph as JGraph
from regennet_torch.convert.from_flax import (
    gru_classifier_state_dict_from_flax,
    stgcn_state_dict_from_flax,
)
from regennet_torch.data import synthetic
from regennet_torch.data.collate import collate
from regennet_torch.data.get_data import BatchLoader, get_collate_fn, get_dataset
from regennet_torch.eval import compute_accuracy as ca
from regennet_torch.eval import unconstrained as U
from regennet_torch.models import gru_classifier
from regennet_torch.models.stgcn import STGCN, make_unconstrained_stgcn, random_init_
from regennet_torch.models.stgcn_graph import Graph
from regennet_torch.train import checkpoint
from tests.test_legacy import _fabricate_unconstrained_stgcn_sd
from tests.test_torch_chip_smoke import one_torch_thread  # noqa: F401
from tests.test_torch_stgcn import _variables

T = 16


def _files(root):
    return {p.relative_to(root): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """Each dataset written by both packages' writers: {name: (jax, port)}."""
    base = tmp_path_factory.mktemp("a2m")
    out = {}
    for name, jwrite, write, n in (
            ("humanact12", jsynthetic.write_humanact12_pkl, synthetic.write_humanact12_pkl, 24),
            ("uestc", jsynthetic.write_uestc_assets, synthetic.write_uestc_assets, 24)):
        kw = dict(num_clips=n) if name == "humanact12" else dict(num_videos=n)
        out[name] = (jwrite(str(base / name / "jax"), **kw),
                     write(str(base / name / "port"), **kw))
    return out


@pytest.mark.parametrize("name", ["humanact12", "uestc"])
def test_writers_write_the_same_files(roots, name):
    from pathlib import Path

    jroot, root = (Path(r) for r in roots[name])
    ours, ref = _files(root), _files(jroot)
    assert ours.keys() == ref.keys() and len(ours) >= 1
    for rel in ref:
        assert ours[rel] == ref[rel], rel


def _pair(roots, name, split="train", pose_rep="rot6d", **kw):
    args = dict(name=name, num_frames=T, num_person=1, split=split, setting="mdm",
                pose_rep=pose_rep, body_model="smpl", **kw)
    return (jget_dataset(data_path=roots[name][0], **args),
            get_dataset(data_path=roots[name][1], **args))


DATASET_CASES = [("humanact12", "train", "rot6d", {}), ("humanact12", "train", "xyz", {}),
                 ("humanact12", "train", "rot6d", {"align_pose_frontview": True}),
                 ("uestc", "train", "rot6d", {}), ("uestc", "test", "rot6d", {}),
                 ("uestc", "test", "xyz", {})]


@pytest.mark.parametrize("name,split,pose_rep,kw", DATASET_CASES)
def test_items_and_batches_match_jax(roots, name, split, pose_rep, kw):
    jds, ds = _pair(roots, name, split, pose_rep, **kw)
    assert type(ds).__name__ == type(jds).__name__
    assert (len(ds), ds.num_actions) == (len(jds), jds.num_actions) and len(ds) >= 4
    assert ds._train == jds._train and ds._test == jds._test
    for i in range(len(ds)):
        items = []
        for d in (jds, ds):
            random.seed(i)
            items.append(d[i])
        ref, ours = items
        assert (ours["action"], ours["action_text"]) == (ref["action"], ref["action_text"])
        assert ours["inp"].dtype == ref["inp"].dtype == np.float32
        np.testing.assert_array_equal(ours["inp"], ref["inp"])
    assert get_collate_fn(name, "mdm") is collate
    batches = []
    for d, fn in ((jds, jcollate), (ds, collate)):
        random.seed(7)
        batches.append(list(BatchLoader(d, 4, fn, seed=3)))
    assert len(batches[0]) == len(batches[1]) >= 1
    for (jm, jc), (m, c) in zip(*batches):
        np.testing.assert_array_equal(m, jm)
        assert c["y"].keys() == jc["y"].keys()
        for key in ("mask", "lengths", "action"):
            np.testing.assert_array_equal(c["y"][key], jc["y"][key])
        assert c["y"]["action_text"] == jc["y"]["action_text"]


@pytest.mark.parametrize("name", ["humanact12", "uestc"])
def test_shuffle_streams_match_jax(roots, name):
    """The evaluation's reshuffles accumulate across seeds, in both splits."""
    jds, ds = _pair(roots, name)
    for split in ("train", "test"):
        jds.split = ds.split = split
        for seed in (0, 1, 2):
            for d in (jds, ds):
                random.seed(seed)
                d.reset_shuffle()
                d.shuffle()
            assert (ds._train, ds._test) == (jds._train, jds._test)


def _perturbed(tree, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(size=np.shape(a)) * scale).astype(np.float32),
        tree)


def _hold(ours, ref, keys, tol=1e-5):
    for key in keys:
        r = np.asarray(ref[key])
        o = ours[key].detach().numpy() if torch.is_tensor(ours[key]) else ours[key]
        assert o.shape == r.shape, key
        np.testing.assert_allclose(o, r, rtol=0, atol=tol * max(1.0, float(np.abs(r).max())),
                                   err_msg=key)


def _motion(B=5, Tm=20, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, 24, 3, Tm)) * 0.5).astype(np.float32), \
        np.array([20, 13, 7, 1, 20][:B])


def test_gru_classifier_matches_flax():
    m, lengths = _motion()
    disc = JMotionDiscriminator(output_size=12)
    variables = {"params": _perturbed(jax.tree_util.tree_map(
        np.asarray, disc.init(jax.random.PRNGKey(0), m, lengths)["params"]), seed=1)}
    ref = disc.apply(variables, jnp.asarray(m), jnp.asarray(lengths))
    model = checkpoint.load_classifier_state(gru_classifier.MotionDiscriminator(output_size=12),
                                      gru_classifier_state_dict_from_flax(variables))
    with torch.no_grad():
        ours = model.eval()(torch.tensor(m), torch.tensor(lengths))
    _hold(ours, ref, ("features", "hidden", "yhat"))
    # the last valid frame is read: a shorter length changes the features
    with torch.no_grad():
        full = model(torch.tensor(m), torch.full((5,), 20))
    assert not torch.allclose(full["features"][1], ours["features"][1])


def test_released_gru_classifier_file_loads_in_both(tmp_path):
    """A reference-layout {"model": state dict} file (bias_hh's r and z
    slices nonzero, as torch trains them) read natively by the port and
    through convert_gru_classifier by the JAX package."""
    m, lengths = _motion(seed=2)
    src = gru_classifier.random_init_(gru_classifier.MotionDiscriminator(output_size=12),
                                      torch.Generator().manual_seed(3))
    path = tmp_path / "humanact12_gru.tar"
    torch.save({"model": src.state_dict()}, path)
    ref = JMotionDiscriminator(output_size=12).apply(
        convert_gru_classifier(load_torch_state_dict(str(path))), jnp.asarray(m),
        jnp.asarray(lengths))
    model = checkpoint.load_classifier_state(gru_classifier.MotionDiscriminator(output_size=12),
                                      str(path))
    with torch.no_grad():
        ours = model.eval()(torch.tensor(m), torch.tensor(lengths))
    _hold(ours, ref, ("features", "hidden", "yhat"))


def test_openpose_graph_matches_jax():
    ours, ref = Graph("openpose"), JGraph("openpose", "spatial")
    assert (ours.num_node, ours.center) == (ref.num_node, ref.center) == (15, 1)
    np.testing.assert_array_equal(ours.A, ref.A)


def _uestc_pair():
    kw = dict(in_channels=6, num_class=40, num_person=1, layout="smpl")
    return JSTGCN(strategy="spatial", **kw), STGCN(**kw), (2, 25, 6, T)


@pytest.mark.parametrize("which", ["unconstrained", "uestc"])
def test_single_person_stgcns_match_flax(which):
    if which == "unconstrained":
        jm, model, shape = jmake_unconstrained(), make_unconstrained_stgcn(), (3, 15, 3, 24)
    else:
        jm, model, shape = _uestc_pair()
    x = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    variables = _variables(jm, x, seed=5)
    ref = jm.apply(variables, {"output": jnp.asarray(x)})
    checkpoint.load_classifier_state(model, stgcn_state_dict_from_flax(variables))
    with torch.no_grad():
        ours = model.eval()(torch.tensor(x))
    _hold(ours, ref, ("features", "yhat"))


def test_released_unconstrained_stgcn_file_loads(tmp_path):
    sd = _fabricate_unconstrained_stgcn_sd(torch)
    path = tmp_path / "humanact12_gru_modi_struct.pth.tar"
    torch.save(sd, path)
    x = np.random.default_rng(6).normal(size=(4, 15, 3, 30)).astype(np.float32)
    ref = jmake_unconstrained().apply(convert_stgcn({k: v.numpy() for k, v in sd.items()}),
                                      {"output": jnp.asarray(x)})
    model = checkpoint.load_classifier_state(make_unconstrained_stgcn(), str(path))
    feats, logits = U.extract_unconstrained_features(model, x, batch_size=3)
    _hold({"features": feats, "yhat": logits}, ref, ("features", "yhat"))


def test_unconstrained_metrics_equal_jax():
    rng = np.random.default_rng(8)
    gt = rng.normal(size=(60, 16))
    gen = gt[::-1] * 0.8 + rng.normal(size=(60, 16)) * 0.3
    assert U.polynomial_mmd(gt, gen) == JU.polynomial_mmd(gt, gen)
    assert U.calculate_kid(gt, gen, n_subsets=10, subset_size=30, seed=2) == \
        JU.calculate_kid(gt, gen, n_subsets=10, subset_size=30, seed=2)
    assert U.precision_recall(gt, gen) == JU.precision_recall(gt, gen)
    assert U.evaluate_unconstrained_metrics(gt, gen, seed=3) == \
        JU.evaluate_unconstrained_metrics(gt, gen, seed=3)
    assert U.SMPL_TO_OPENPOSE15 == JU.SMPL_TO_OPENPOSE15
    assert U.OPENPOSE15_ROOT == JU.OPENPOSE15_ROOT


REDUCED = dict(channels=(8, 16), strides=(1, 2))


@pytest.fixture(scope="module")
def chi3d_path(tmp_path_factory):
    return jsynthetic.make_dataset_pair(str(tmp_path_factory.mktemp("acc")), "chi3d",
                                        num_clips=24)


def test_confusion_matrices_match_jax(chi3d_path):
    kw = dict(name="chi3d", num_frames=T, num_person=2, data_path=chi3d_path,
              setting="mdm", pose_rep="rot6d", body_model="smplx")
    jm = JSTGCN(in_channels=12, num_class=8, num_person=2, layout="smplx", strategy="spatial",
                **{k: tuple(v) for k, v in REDUCED.items()})
    variables = _variables(jm, np.zeros((1, 56, 12, T), np.float32), seed=9)
    model = STGCN(12, 8, num_person=2, layout="smplx", **REDUCED)
    checkpoint.load_classifier_state(model, stgcn_state_dict_from_flax(variables))
    results = []
    for getter, fn, run in (
            (jget_dataset, jcollate, lambda loaders: jca.compute_accuracy(
                jm, variables, loaders, 8)),
            (get_dataset, collate, lambda loaders: ca.compute_accuracy(model, loaders, 8))):
        random.seed(0)
        loaders = {split: BatchLoader(getter(split=split, **kw), 4, fn, shuffle=False,
                                      drop_last=False) for split in ("train", "test")}
        results.append(run(loaders))
    (jacc, jconf), (acc, conf) = results
    assert acc == jacc and acc.keys() == {"train", "test"}
    for split in ("train", "test"):
        np.testing.assert_array_equal(conf[split], jconf[split])
        assert conf[split].sum() == (24 if split == "train" else 12)


def test_compute_accuracy_cli_on_cpu(tmp_path):
    """main on a train_stgcn-style checkpoint (model{epoch}.pt) over
    in-memory clips: the yaml beside the checkpoint holds the accuracies
    compute_accuracy gives."""
    from regennet_torch.data.feeder import Feeder
    from regennet_torch.eval import tools

    model = random_init_(STGCN(12, 8, num_person=2, layout="smplx"),
                         torch.Generator().manual_seed(1))
    path = tmp_path / "model000000030.pt"
    torch.save(model.state_dict(), path)
    clips = synthetic.make_clip_pair("chi3d", num_clips=12, min_len=T + 2, max_len=T + 10)
    datasets = {split: Feeder(clips=clips[split], dataname="chi3d", split=split,
                              num_frames=T, num_person=2) for split in ("train", "test")}
    args = ca.parse_args(["--checkpoint", str(path), "--data_path", "", "--num_frames",
                          str(T), "--batch_size", "5"])
    acc = ca.main(args, device="cpu", datasets=datasets)
    assert tools.load_metrics(str(tmp_path / "recognition_accuracies_on_samedata_30.yaml")) \
        == {k: str(v) for k, v in acc.items()}
    assert set(acc) == {"train", "test"} and all(0.0 <= v <= 1.0 for v in acc.values())
