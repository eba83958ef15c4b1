"""regennet_torch's evaluation path against the JAX package's.

* metrics: the same numbers from the same inputs and numpy stream;
* the results file: the text yaml.dump writes, read back as yaml's
  BaseLoader reads it (PyYAML is imported here only);
* the protocol: `stgcn_eval.evaluate` on one synthetic dataset (h5 files
  both feeders read) with 1-step respacing and a denoiser that returns
  cond["cmotion"]: the posterior at t = 0 is then the prediction, so no
  sampling noise enters and the generated batches are the same in both
  packages. Two seeds, seed stacking 1 and 2, and the oracle route; the
  ground-truth and generated arrays the classifiers see must be
  bit-equal, the metrics within 1e-4 relative (one reduced ST-GCN on
  shared variables; its f32 sums differ in order), or 1e-9 absolute for
  the FID of a set with itself (zero up to rounding);
* the auto-regressive `_sample_output` with a deterministic stub sampler;
* `eval_cmdm.main` end to end on the CPU at T = 16.
"""

import json
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from regennet_tpu.data import synthetic as jsynthetic
from regennet_tpu.data.get_data import get_dataset as jget_dataset
from regennet_tpu.diffusion import DiffusionConfig as JConfig
from regennet_tpu.diffusion import make_schedule as jmake_schedule
from regennet_tpu.eval import metrics as JM
from regennet_tpu.eval import stgcn_eval as jeval
from regennet_tpu.models.stgcn import STGCN as JSTGCN
from regennet_torch.convert.from_flax import stgcn_state_dict_from_flax
from regennet_torch.data.get_data import get_dataset
from regennet_torch.diffusion import DiffusionConfig, make_schedule
from regennet_torch.eval import metrics as M
from regennet_torch.eval import stgcn_eval, tools

REDUCED = dict(channels=(8, 16), strides=(1, 2))
T = 16


@pytest.fixture(scope="module")
def data_path(tmp_path_factory):
    root = tmp_path_factory.mktemp("evds")
    return jsynthetic.make_dataset_pair(str(root), "chi3d", num_clips=40)


def _datasets(data_path):
    kw = dict(name="chi3d", num_frames=T, num_person=2, data_path=data_path,
              split="test", setting="cmdm", pose_rep="rot6d", body_model="smplx")
    return jget_dataset(**kw), get_dataset(**kw)


@pytest.mark.parametrize("actor_quirks", [False, True, "a2m"])
def test_metrics_match_jax(actor_quirks):
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(120, 16))
    other = rng.normal(size=(120, 16)) + 0.5
    labels = rng.integers(0, 6, 120)
    logits = rng.normal(size=(120, 6))
    acc, conf = M.calculate_accuracy(logits, labels, 6)
    jacc, jconf = JM.calculate_accuracy(logits, labels, 6)
    assert acc == jacc and np.array_equal(conf, jconf)
    stats = [M.calculate_activation_statistics(f) for f in (feats, other)]
    assert M.calculate_fid(*stats) == JM.calculate_fid(*stats)
    for seed in (3, None):
        np.random.seed(11)
        ours = M.calculate_diversity_multimodality(feats, labels, 6, seed=seed,
                                                   actor_quirks=actor_quirks)
        np.random.seed(11)
        ref = JM.calculate_diversity_multimodality(feats, labels, 6, seed=seed,
                                                   actor_quirks=actor_quirks)
        assert ours == ref


@pytest.mark.parametrize("metrics", [
    {"feats": {"accuracy_gen_test": ["0.25", "0.375"], "fid_gt_train": ["3.14159e-07"],
               "diversity_gen_train": ["12.5", "nan", "-inf", "1e-05", "1", "-0.5"]}},
    {"feats": {"b": [], "a": ["yes", "", " x", "it's", "a: b", "- c", "#d", "0x1f",
                              "2024-01-02", "~", "null", ".5", "x y"]}, "empty": {}},
    {},
])
def test_results_file_is_yaml_dump_text(tmp_path, metrics):
    path = tmp_path / "evaluation_results.yaml"
    tools.save_metrics(str(path), metrics)
    assert path.read_text() == yaml.dump(metrics)
    assert tools.load_metrics(str(path)) == yaml.load(yaml.dump(metrics),
                                                      yaml.loader.BaseLoader)


def test_feeder_shuffles_accumulate_as_jax(data_path):
    import random

    jdata, data = _datasets(data_path)
    for split in ("train", "test"):
        jdata.split = data.split = split
        for seed in (0, 1, 2):
            for feeder in (jdata, data):
                random.seed(seed)
                feeder.reset_shuffle()
                feeder.shuffle()
            np.testing.assert_array_equal(data._train if split == "train" else data._test,
                                          jdata._train if split == "train" else jdata._test)


class _Recorder:
    """An evaluator that keeps every batch it is shown."""

    def __init__(self, inner):
        self.inner, self.num_classes, self.outputs = inner, inner.num_classes, []

    def __call__(self, batch):
        self.outputs.append(np.asarray(batch["output"]))
        return self.inner(batch)


@pytest.fixture(scope="module")
def evaluators():
    jm = JSTGCN(in_channels=12, num_class=8, num_person=2, layout="smplx",
                **{k: tuple(v) for k, v in REDUCED.items()})
    variables = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), {"output": jnp.zeros((1, 56, 12, T))}))
    jev = jeval.STGCNEvaluator("chi3d", "smplx", 8, 12, 2, variables, **REDUCED)
    ev = stgcn_eval.STGCNEvaluator("chi3d", "smplx", 8, 12, 2,
                                   stgcn_state_dict_from_flax(variables), **REDUCED)
    return jev, ev


@pytest.mark.parametrize("seed_batch,oracle", [(1, False), (2, False), (2, True)])
def test_evaluate_matches_jax(data_path, evaluators, seed_batch, oracle):
    jdata, data = _datasets(data_path)
    args = Namespace(batch_size=4, num_samples=24, num_seeds=2,
                     eval_seed_batch=seed_batch, seed_start=3)
    jev, ev = (_Recorder(e) for e in evaluators)
    ref = jeval.evaluate(
        args, lambda: (lambda x, t, cond: jnp.asarray(cond["cmotion"])),
        jmake_schedule("cosine", 1000, timestep_respacing="1"),
        JConfig(model_mean_type="start_x"), jdata, jev, setting="cmdm", oracle=oracle)
    ours = stgcn_eval.evaluate(
        args, lambda: (lambda x, t, cond: cond["cmotion"]),
        make_schedule("cosine", 1000, timestep_respacing="1"),
        DiffusionConfig(model_mean_type="start_x"), data, ev, setting="cmdm",
        oracle=oracle)
    # 2 seeds x {gen, gt} x (7 train batches: the reference keeps the one
    # that crosses num_samples; 5 test batches: the split's 20 clips)
    assert len(ev.outputs) == len(jev.outputs) == 2 * 2 * (7 + 5)
    for a, b in zip(ev.outputs, jev.outputs):
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert ours["feats"].keys() == ref["feats"].keys()
    for key, values in ref["feats"].items():
        assert len(ours["feats"][key]) == 2
        # fid_gt_* compares a set with itself: zero up to rounding
        np.testing.assert_allclose([float(v) for v in ours["feats"][key]],
                                   [float(v) for v in values], rtol=1e-4, atol=1e-9,
                                   err_msg=key)


@pytest.mark.parametrize("setting,auto_regressive", [("cmdm", True), ("cmdm", False),
                                                     ("mdm", True)])
def test_sample_output_matches_jax(setting, auto_regressive):
    rng = np.random.default_rng(4)
    cond_np = {"cmotion": rng.normal(size=(2, 5, 6, 7)).astype(np.float32),
               "action": np.array([[1], [3]])}
    shape = (2, 5, 6, 7)
    calls = []

    def stub(_, cond, shape):
        calls.append(1)
        return torch.as_tensor(cond["cmotion"]) * 2.0 + float(cond["action"].sum())

    def jstub(_, cond, shape):
        return jnp.asarray(cond["cmotion"]) * 2.0 + float(jnp.sum(cond["action"]))

    ours = stgcn_eval._sample_output(stub, torch.Generator(), cond_np, shape, setting,
                                     auto_regressive, "cpu")
    ref = np.asarray(jeval._sample_output(jstub, jax.random.PRNGKey(0), cond_np, shape,
                                          setting, auto_regressive))
    assert len(calls) == (7 if auto_regressive else 1)
    assert ours.shape == ref.shape == ((2, 5, 12, 7) if setting == "cmdm" else shape)
    np.testing.assert_array_equal(ours, ref)


def test_eval_cli_end_to_end_on_cpu(tmp_path):
    """eval_cmdm.main in debug mode with CFG 2.5: a checkpoint and its
    args.json, a random classifier from --seed, in-memory clips; the
    results file is the yaml.dump text of the returned metrics."""
    from regennet_torch.data import synthetic
    from regennet_torch.data.feeder import Feeder
    from regennet_torch.eval import easy_table, eval_cmdm
    from regennet_torch.utils import parser_util
    from regennet_torch.utils.model_util import create_model_and_diffusion

    run = tmp_path / "run"
    train_args = Namespace(
        dataset="chi3d", data_dir="", num_person=2, data_path="", pose_rep="rot6d",
        body_model="smplx", vel_threshold=0.01, shuffle=False, setting="cmdm",
        arch="online", emb_trans_dec=False, wo_pos_emb=False, cm_mode="concat",
        layers=2, latent_dim=32, cond_mask_prob=0.1, lambda_rcxyz=0.0, lambda_vel=0.0,
        lambda_fc=0.0, lambda_orient=1.0, lambda_body=1.0, lambda_transl=1.0,
        unconstrained=False, noise_schedule="cosine", diffusion_steps=10,
        sigma_small=True, num_frames=T)
    data = Feeder(clips=synthetic.make_clips("chi3d", "test", num_clips=128,
                                             min_len=T + 2, max_len=T + 12),
                  dataname="chi3d", split="test", num_frames=T, num_person=2)
    torch.manual_seed(0)
    model, _, _ = create_model_and_diffusion(train_args, data)
    run.mkdir()
    torch.save(model.state_dict(), run / "model000000007.pt")
    (run / "args.json").write_text(json.dumps(vars(train_args)))
    args = parser_util.evaluation_parser([
        "--model_path", str(run / "model000000007.pt"), "--rec_model_path", "random",
        "--seed", "1"])
    assert args.guidance_param == 2.5 and args.eval_mode == "debug"
    args.num_frames = T
    result = eval_cmdm.main(args, device="cpu", data=data)
    path = run / "evaluation_results_run_debug_000000007.yaml"
    assert str(path) == eval_cmdm.results_path(args)
    assert path.read_text() == yaml.dump(result)
    feats = result["feats"]
    assert sorted(feats) == sorted(f"accuracy_{k}_{s}" for k in ("gen", "gt")
                                   for s in ("train", "test"))
    assert all(len(v) == 1 and 0.0 <= float(v[0]) <= 1.0 for v in feats.values())
    easy_table.print_results(str(run), path.name)
