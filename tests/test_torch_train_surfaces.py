"""The trainer's surfaces beside the step: in-training evaluation
(`--eval_during_training`, the a2m route) and `--profile_steps`, against
the JAX package's TrainLoop.

* Evaluation runs after every save, in eval_cmdm's debug protocol, and
  reports the debug metrics under "Eval"; its protocol (batch, sample
  count, seeds, mode, classifier path, reported names and steps) is the
  JAX loop's, both loops run with their evaluation entry stubbed. For
  HumanAct12 and UESTC it runs eval_humanact12_uestc's route with
  eval_rep_times seeds, as the JAX loop does. Without a classifier it
  logs and skips; humanml/kit take eval_humanml's route.
* TensorBoard: the platform and the log format write event files, and
  train_mdm on HumanAct12 logs its loss and evaluations there.
* The profiler window opens and closes at the steps where the JAX loop's
  does (its run_loop driven with the device steps and jax.profiler
  stubbed) and leaves a Chrome trace under <save_dir>/profile.
"""

import json
import os
from argparse import Namespace

import pytest
import torch

from regennet_tpu.train import training_loop as jtl
from regennet_torch.models import cmdm
from regennet_torch.parallel import mesh
from regennet_torch.train import training_loop
from regennet_torch.train.train_platforms import TrainPlatform
from regennet_torch.utils.model_util import create_model_and_diffusion
from tests.test_torch_chip_smoke import one_torch_thread  # noqa: F401
from tests.test_torch_training import _cli_args, _loader

DEBUG_METRICS = {f"accuracy_{k}_{s}" for k in ("gen", "gt") for s in ("train", "test")}


class Recorder(TrainPlatform):
    def __init__(self, save_dir=None):
        self.scalars = []

    def report_scalar(self, name, value, iteration, group_name=None):
        self.scalars.append((name, value, iteration, group_name))

    def evals(self):
        return [s for s in self.scalars if s[3] == "Eval"]


def _loop(tmp_path, data=None, **over):
    args = _cli_args(tmp_path, **over)
    data = data or _loader()
    model, sched, cfg = create_model_and_diffusion(args, data)
    return training_loop.TrainLoop(args, Recorder(), model, sched, cfg, data,
                                   torch.device("cpu"))


def test_eval_during_training_runs_after_every_save(tmp_path):
    """A tiny run (3 steps, saves at steps 2 and 3) with a random ST-GCN:
    one debug evaluation after each save, its four accuracies reported
    under "Eval" at the saved step."""
    loop = _loop(tmp_path, eval_during_training=True, rec_model_path="random",
                 eval_batch_size=4, eval_num_samples=8, diffusion_steps=10)
    loop.run_loop()
    evals = loop.train_platform.evals()
    assert sorted({it for _, _, it, _ in evals}) == [2, 3]
    for step in (2, 3):
        row = {name: value for name, value, it, _ in evals if it == step}
        assert set(row) == DEBUG_METRICS
        assert all(0.0 <= v <= 1.0 for v in row.values())


def _jax_eval_call(monkeypatch, args, data):
    """What the JAX loop's evaluate hands its evaluation entry, and what it
    reports, with eval_cmdm's classifier and evaluation stubbed."""
    from regennet_tpu.eval import eval_cmdm as jeval

    calls = {}

    def evaluate(eval_args, make_fn, sched, cfg, dataset, evaluator):
        calls.update(args=eval_args, dataset=dataset, evaluator=evaluator)
        return {"feats": {k: ["0.5"] for k in sorted(DEBUG_METRICS)}}

    monkeypatch.setattr(jeval, "load_stgcn_evaluator", lambda a, rec: ("stgcn", rec))
    monkeypatch.setattr(jeval, "evaluate", evaluate)
    loop = object.__new__(jtl.TrainLoop)
    loop.args, loop.data, loop.train_platform = args, data, Recorder()
    loop.state, loop.model, loop.sched, loop.cfg = {"params": {}}, None, None, None
    loop.step, loop.resume_step = 3, 4
    loop.evaluate()
    return calls, loop.train_platform.scalars


def test_eval_protocol_is_the_jax_loops(monkeypatch, tmp_path):
    from regennet_torch.eval import eval_cmdm, stgcn_eval

    loop = _loop(tmp_path, eval_during_training=True, rec_model_path="/ckpt/stgcn.pt",
                 eval_num_samples=1000, eval_batch_size=16)
    calls = {}

    def evaluate(eval_args, make_fn, sched, cfg, dataset, evaluator, **kw):
        calls.update(args=eval_args, dataset=dataset, evaluator=evaluator, kw=kw,
                     dtype=make_fn().dtype)
        return {"feats": {k: ["0.5"] for k in sorted(DEBUG_METRICS)}}

    monkeypatch.setattr(eval_cmdm, "load_stgcn_evaluator",
                        lambda a, rec, device: ("stgcn", rec))
    monkeypatch.setattr(stgcn_eval, "evaluate", evaluate)
    monkeypatch.setattr(cmdm, "make_model_fn", lambda model: model)  # make_fn() -> model
    loop.step, loop.resume_step = 3, 4
    loop.evaluate()
    jcalls, jscalars = _jax_eval_call(monkeypatch, loop.args, loop.data)
    for key in ("batch_size", "num_samples", "num_seeds", "eval_mode", "num_actions"):
        assert getattr(calls["args"], key) == getattr(jcalls["args"], key), key
    assert (calls["args"].batch_size, calls["args"].num_samples) == (16, 100)
    assert calls["evaluator"] == jcalls["evaluator"] == ("stgcn", "/ckpt/stgcn.pt")
    assert calls["dataset"] is jcalls["dataset"] is loop.data.dataset
    # the loop's layout (one process's here) says which ranks share the rows
    assert calls["kw"] == {"setting": "cmdm", "acc_only": True, "layout": loop.layout}
    assert loop.layout == mesh.one_process()
    assert calls["dtype"] == torch.float32
    assert loop.train_platform.scalars == jscalars == [
        (k, 0.5, 7, "Eval") for k in sorted(DEBUG_METRICS)]


def test_eval_samples_at_the_compute_dtype_from_the_current_parameters(monkeypatch,
                                                                       tmp_path):
    from regennet_torch.eval import eval_cmdm, stgcn_eval

    loop = _loop(tmp_path, eval_during_training=True, rec_model_path="random",
                 compute_dtype="bfloat16")
    with torch.no_grad():
        for p in loop.model.parameters():
            p.add_(1.0)  # the current parameters, away from the EMA
    seen = {}

    def evaluate(eval_args, make_fn, *rest, **kw):
        model = make_fn()
        seen["dtype"] = model.dtype
        seen["params"] = {n: p.float() for n, p in model.named_parameters()}
        return {"feats": {}}

    monkeypatch.setattr(eval_cmdm, "load_stgcn_evaluator", lambda *a: None)
    monkeypatch.setattr(stgcn_eval, "evaluate", evaluate)
    monkeypatch.setattr(cmdm, "make_model_fn", lambda model: model)
    loop.evaluate()
    assert seen["dtype"] == torch.bfloat16
    for name, p in loop.model.named_parameters():
        assert p.dtype == torch.float32
        torch.testing.assert_close(seen["params"][name], p.detach().bfloat16().float(),
                                   rtol=0, atol=0)
        assert not torch.equal(p.detach(), loop.ema[name])


def test_eval_without_a_classifier_logs_and_skips(monkeypatch, tmp_path, capsys):
    monkeypatch.delenv("REGENNET_REC_MODEL_PATH", raising=False)
    loop = _loop(tmp_path, eval_during_training=True)
    loop.evaluate()
    assert "eval_during_training set but no rec_model_path; skipping" in capsys.readouterr().out
    assert loop.train_platform.scalars == []
    loop.args.eval_during_training = False
    monkeypatch.setenv("REGENNET_REC_MODEL_PATH", "random")
    loop.evaluate()  # not asked for: nothing runs
    assert loop.train_platform.scalars == []


def test_eval_takes_the_classifier_from_the_environment(monkeypatch, tmp_path):
    """With no --rec_model_path, REGENNET_REC_MODEL_PATH names the
    classifier, as in the JAX loop."""
    from regennet_torch.eval import eval_cmdm, stgcn_eval

    monkeypatch.setenv("REGENNET_REC_MODEL_PATH", "/env/stgcn.pt")
    loop = _loop(tmp_path, eval_during_training=True)
    paths = []
    monkeypatch.setattr(eval_cmdm, "load_stgcn_evaluator",
                        lambda a, rec, device: paths.append(rec))
    monkeypatch.setattr(stgcn_eval, "evaluate", lambda *a, **kw: {"feats": {}})
    loop.evaluate()
    assert paths == ["/env/stgcn.pt"]


@pytest.mark.parametrize("dataset,missing", [
    ("humanml", "eval_humanml"), ("kit", "eval_humanml")])
def test_eval_of_unported_datasets_raises(tmp_path, monkeypatch, dataset, missing):
    """humanml and kit no longer raise: they take the eval_humanml route
    (its entry points stubbed here; tests/test_torch_eval_humanml.py runs
    it), with the JAX loop's protocol: the evaluators of --rec_model_path,
    the --eval_split split built once, eval_rep_times replications,
    diversity over min(300, samples), no multimodality, the log
    eval_humanml_{step:09d}.log, R-precision reported as top{k}_<key>."""
    from regennet_torch.data.humanml import dataset as hml
    from regennet_torch.eval import eval_humanml

    loop = _loop(tmp_path, eval_during_training=True, rec_model_path="random",
                 eval_num_samples=-1, eval_rep_times=2, data_path="/data/hml")
    loop.args.dataset = dataset
    calls = []
    monkeypatch.setattr(eval_humanml, "load_t2m_wrapper",
                        lambda *a: calls.append(("wrapper", a)) or "wrapper")
    monkeypatch.setattr(hml, "Text2MotionDataset",
                        lambda *a, **kw: calls.append(("split", a, kw)) or [0] * 7)
    monkeypatch.setattr(eval_humanml, "make_gt_loader_factory", lambda *a: "gt")
    monkeypatch.setattr(eval_humanml, "make_gen_loader_factory", lambda *a, **kw: "gen")

    def evaluation(wrapper, gt, gens, log_file, **kw):
        calls.append(("evaluation", wrapper, gt, gens, os.path.basename(log_file), kw))
        return {"R_precision_model": [0.25, 0.5, 0.75], "FID_model": 3.0}

    monkeypatch.setattr(eval_humanml, "evaluation", evaluation)
    loop.evaluate()
    loop.evaluate()
    assert calls[:2] == [("wrapper", (dataset, "random", loop.args.seed, loop.device)),
                         ("split", ("/data/hml",), {"split": "test", "dataset_name": dataset})]
    assert calls[2:] == [("evaluation", "wrapper", "gt", {"model": "gen"},
                          "eval_humanml_000000000.log",
                          dict(replication_times=2, diversity_times=7, run_mm=False))] * 2
    assert [(n, v) for n, v, _, g in loop.train_platform.evals()] == [
        ("top1_R_precision_model", 0.25), ("top2_R_precision_model", 0.5),
        ("top3_R_precision_model", 0.75), ("FID_model", 3.0)] * 2
    assert missing == "eval_humanml"


@pytest.fixture(scope="module")
def a2m_roots(tmp_path_factory):
    from regennet_torch.data import synthetic

    return {"humanact12": synthetic.write_humanact12_pkl(
                str(tmp_path_factory.mktemp("ha12")), num_clips=24),
            "uestc": synthetic.write_uestc_assets(
                str(tmp_path_factory.mktemp("uestc")), num_videos=24)}


def _a2m_loop(tmp_path, roots, dataset, **over):
    from regennet_torch.data.get_data import get_dataset_loader

    over = dict(dataset=dataset, num_person=1, body_model="smpl", setting="mdm",
                arch="trans_enc", data_path=roots[dataset], **over)
    data = get_dataset_loader(dataset, 4, 16, data_path=roots[dataset], setting="mdm")
    return _loop(tmp_path, data=data, **over)


# what the a2m evaluation of each dataset reports in debug mode (the names
# of the JAX package's legacy evaluate; tests/test_torch_gru_eval.py holds
# the two key sets equal)
LEGACY_METRICS = {
    "humanact12": {f"{m}_{k}" for m in ("accuracy", "diversity", "multimodality", "fid")
                   for k in ("gen", "gt", "gt2")},
    "uestc": DEBUG_METRICS,
}


@pytest.mark.parametrize("dataset", ["humanact12", "uestc"])
def test_eval_of_a2m_datasets_runs_the_legacy_route(monkeypatch, tmp_path, a2m_roots,
                                                    dataset):
    """TrainLoop.evaluate on HumanAct12 (the GRU classifier) and UESTC
    (the single-person ST-GCN), random classifiers: eval_humanact12_uestc
    runs with eval_rep_times seeds, every metric of its first seed is
    reported under "Eval"."""
    from regennet_torch.eval import eval_humanact12_uestc

    loop = _a2m_loop(tmp_path, a2m_roots, dataset, eval_during_training=True,
                     rec_model_path="random", eval_batch_size=4, eval_num_samples=8,
                     diffusion_steps=10, eval_rep_times=2)
    results = []
    evaluate = eval_humanact12_uestc.evaluate
    monkeypatch.setattr(eval_humanact12_uestc, "evaluate",
                        lambda *a, **kw: results.append(evaluate(*a, **kw)) or results[-1])
    loop.step, loop.resume_step = 2, 3
    loop.evaluate()
    feats = results[0]["feats"]
    assert set(feats) == LEGACY_METRICS[dataset]
    assert all(len(v) == 2 for v in feats.values())
    assert sorted(loop.train_platform.scalars) == sorted(
        (k, float(v[0]), 5, "Eval") for k, v in feats.items())


def _jax_legacy_call(monkeypatch, args, data):
    """What the JAX loop's evaluate hands eval_humanact12_uestc.evaluate."""
    from regennet_tpu.eval import eval_humanact12_uestc as jlegacy

    calls = {}

    def evaluate(eval_args, make_fn, sched, cfg, dataset, rec):
        calls.update(args=eval_args, dataset=dataset, rec=rec)
        return {"feats": {"accuracy_gen": ["0.5", "0.25"]}}

    monkeypatch.setattr(jlegacy, "evaluate", evaluate)
    loop = object.__new__(jtl.TrainLoop)
    loop.args, loop.data, loop.train_platform = args, data, Recorder()
    loop.state, loop.model, loop.sched, loop.cfg = {"params": {}}, None, None, None
    loop.step, loop.resume_step = 3, 4
    loop.evaluate()
    return calls, loop.train_platform.scalars


@pytest.mark.parametrize("dataset", ["humanact12", "uestc"])
def test_legacy_eval_protocol_is_the_jax_loops(monkeypatch, tmp_path, a2m_roots, dataset):
    from regennet_torch.eval import eval_humanact12_uestc

    loop = _a2m_loop(tmp_path, a2m_roots, dataset, eval_during_training=True,
                     rec_model_path="/ckpt/classifier.tar", eval_num_samples=1000,
                     eval_batch_size=16, eval_rep_times=5)
    calls = {}

    def evaluate(eval_args, make_fn, sched, cfg, dataset, rec):
        calls.update(args=eval_args, dataset=dataset, rec=rec)
        return {"feats": {"accuracy_gen": ["0.5", "0.25"]}}

    monkeypatch.setattr(eval_humanact12_uestc, "evaluate", evaluate)
    loop.step, loop.resume_step = 3, 4
    loop.evaluate()
    jcalls, jscalars = _jax_legacy_call(monkeypatch, loop.args, loop.data)
    for key in ("batch_size", "num_samples", "num_seeds", "eval_mode", "num_actions"):
        assert getattr(calls["args"], key) == getattr(jcalls["args"], key), key
    assert (calls["args"].batch_size, calls["args"].num_samples,
            calls["args"].num_seeds) == (16, 100, 5)
    assert calls["rec"] == jcalls["rec"] == "/ckpt/classifier.tar"
    assert calls["dataset"] is jcalls["dataset"] is loop.data.dataset
    assert loop.train_platform.scalars == jscalars == [("accuracy_gen", 0.5, 7, "Eval")]


def _event_scalars(log_dir):
    """{tag: [(step, value)]} of the event files under log_dir."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(log_dir))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def test_tensorboard_platform_and_log_format_write_events(tmp_path):
    pytest.importorskip("torch.utils.tensorboard")
    from regennet_torch.train.train_platforms import TensorboardPlatform, get_platform
    from regennet_torch.utils import kvlogger

    assert get_platform("TensorboardPlatform") is TensorboardPlatform
    platform = TensorboardPlatform(str(tmp_path / "platform"))
    platform.report_scalar("loss", 0.5, 3, group_name="Loss")
    platform.report_scalar("accuracy_gen", 0.25, 4, group_name="Eval")
    platform.close()
    assert _event_scalars(tmp_path / "platform") == {"Loss/loss": [(3, 0.5)],
                                                     "Eval/accuracy_gen": [(4, 0.25)]}
    log = kvlogger.Logger(str(tmp_path / "log"), formats=("tensorboard",))
    for step, loss in ((0, 2.0), (5, 1.5)):
        log.logkv("step", step)
        log.logkv_mean("loss", loss)
        log.dumpkvs()
    assert _event_scalars(tmp_path / "log" / "tb") == {
        "loss": [(0, 2.0), (5, 1.5)], "step": [(0, 0.0), (5, 5.0)]}


def test_train_mdm_on_humanact12_with_tensorboard(monkeypatch, tmp_path, a2m_roots):
    """train_mdm.main as a user runs it on HumanAct12 (--setting mdm
    --num_person 1 --body_model smpl, the dataset from --data_path), with
    the in-training evaluation and TensorBoard: the loss and the legacy
    route's metrics land in the run's event file."""
    pytest.importorskip("torch.utils.tensorboard")
    from regennet_torch.train import train_mdm
    from regennet_torch.utils import parser_util

    monkeypatch.setenv("REGENNET_LOG_FORMAT", "human,csv")
    args = parser_util.train_args([
        "--save_dir", str(tmp_path / "run"), "--dataset", "humanact12", "--data_path",
        a2m_roots["humanact12"], "--setting", "mdm", "--num_person", "1", "--body_model",
        "smpl", "--num_frames", "16", "--batch_size", "4", "--num_steps", "4",
        "--steps_per_call", "2", "--save_interval", "4", "--log_interval", "2",
        "--layers", "2", "--latent_dim", "32", "--diffusion_steps", "10",
        "--eval_during_training", "--rec_model_path", "random", "--eval_rep_times", "1",
        "--eval_batch_size", "4", "--eval_num_samples", "8",
        "--train_platform_type", "TensorboardPlatform"])
    loop = train_mdm.main(args, device="cpu")
    assert loop.state_step == 4 and loop.model.cmo_process is not None
    scalars = _event_scalars(tmp_path / "run")
    assert [s for s, _ in scalars["Loss/loss"]] == [0, 2]
    assert {f"Eval/{k}" for k in LEGACY_METRICS["humanact12"]} <= set(scalars)
    assert [s for s, _ in scalars["Eval/accuracy_gen"]] == [2, 4]  # after each save


def _jax_profile_window(num_batches, num_steps, steps_per_call, start, n, monkeypatch):
    """The steps at which the JAX loop starts and stops its trace: its own
    run_loop with the device steps, saves and jax.profiler stubbed."""
    import jax.profiler

    loop = object.__new__(jtl.TrainLoop)
    events = []
    monkeypatch.setattr(jax.profiler, "start_trace", lambda d: events.append(loop.step))
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: events.append(loop.step))
    loop.args = Namespace(profile_steps=n, profile_start=start, eval_during_training=False)
    loop.save_dir = "unused"
    loop.data = [(None, None)] * num_batches
    loop.num_epochs = num_steps // (num_batches + 1)
    loop.steps_per_call, loop._block_buf = steps_per_call, []
    loop.step, loop.resume_step, loop.num_steps = 0, 0, num_steps
    loop.lr_anneal_steps, loop.log_interval = 0, 10 ** 9
    loop.save_interval, loop._last_save_at = 10 ** 9, None
    loop.train_platform, loop.global_batch = Recorder(), 1
    loop.run_step = lambda motion, cond: {"loss": 0.0}
    loop.run_block = lambda items: [{"loss": 0.0}] * len(items)
    loop.save = lambda: None
    loop.run_loop()
    return events


@pytest.mark.parametrize("start,n", [(2, 2), (4, 10)])
def test_profile_window_and_trace(monkeypatch, tmp_path, start, n):
    """--profile_steps n --profile_start start --steps_per_call 2 over 6
    steps: the trace opens and closes where the JAX loop's does ((4, 10)
    closes at the end of the run) and is a Chrome trace of the steps, with
    the program's spans in it and its counters logged."""
    from torch import profiler

    events = []
    loop = _loop(tmp_path, data=_loader(num_clips=24), num_steps=6, save_interval=100,
                 profile_steps=n, profile_start=start)
    real = profiler.profile

    class Watched(real):
        def start(self):
            events.append(loop.step)
            super().start()

        def stop(self):
            events.append(loop.step)
            super().stop()

    monkeypatch.setattr(profiler, "profile", Watched)
    logged = []
    monkeypatch.setattr(training_loop.logger, "log",
                        lambda *a, **k: logged.append(" ".join(map(str, a))))
    loop.run_loop()
    counted = [line for line in logged if line.startswith("profiled window's counters")]
    assert len(counted) == 1 and "host_syncs" in counted[0]
    assert loop.state_step == 6 and loop._profiler is None
    assert events == _jax_profile_window(6, 6, 2, start, n, monkeypatch)
    first, last = events
    path = tmp_path / "save" / "profile" / f"trace_steps{first:09d}-{last:09d}.json"
    assert os.listdir(tmp_path / "save" / "profile") == [path.name]
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("aten::" in name for name in names)
    # the program's own spans, recorded for the window alone
    assert {"regennet/train.block", "regennet/train.step", "regennet/denoiser",
            "regennet/train.backward", "regennet/sync"} <= names
