"""The program's traced window (portbench/program.py) and the readers of
it, on synthetic traces whose answers are worked out by hand; the ten
readers of the other two windows read the same with and without it; and,
on the card, every device operation of the window in the span that
launched it."""

import dataclasses
import json
import threading
from pathlib import Path

import pytest

from _portbench_helpers import REPO, harness
from portbench import program, trace

BASE = 1_700_000_000_000_000_000  # the trace's baseTimeNanoseconds
METRICS = harness.ROOT / "metrics"
NEW = ("host_batch_idle_ms.train", "step_idle_ms.train", "host_syncs.train",
       "clip_device_ms.train", "forward_device_ms.train", "loss_device_ms.train",
       "backward_device_ms.train", "optimizer_device_ms.train", "step_idle_ms.sample")


@dataclasses.dataclass(eq=False)
class Record:
    """What the program records of a span (utils/profiling.SpanRecord)."""
    name: str
    start_ns: int
    end_ns: int
    tid: int
    parent: object = None
    request: object = None


def spans(tree, tid, parent=None, out=None):
    """[(name, start_us, end_us, children)] -> Records on the ns clock."""
    out = [] if out is None else out
    for name, start, end, children in tree:
        r = Record(name, BASE + int(start * 1000), BASE + int(end * 1000), tid, parent,
                   None if parent is None else parent.request)
        spans(children, tid, r, out)
        out.append(r)  # in the order they close
    return out


def kernel(name, launch, start, dur, corr, tid=1):
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch,
             "dur": 0.5, "tid": tid, "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": name, "ts": start, "dur": dur,
             "args": {"correlation": corr}}]


def training_window():
    """One optimizer step, us 0-100. Busy [12, 22], [31, 32], [45, 61],
    [66, 79], [85, 90]; the backward launched from autograd's thread 2."""
    main = spans([("train.block", 0, 100, [
        ("train.host_batch", 0, 30, [("clip.encode", 5, 25, [("sync", 5, 6, []),
                                                               ("sync", 20, 25, [])])]),
        ("train.to_device", 30, 40, [("sync", 30, 32, []), ("sync", 35, 37, [])]),
        ("train.step", 40, 95, [("train.loss", 41, 60, [("denoiser", 42, 55, [])]),
                                ("train.backward", 60, 80, []),
                                ("train.optimizer", 80, 95, [])])])], tid=1)
    autograd = spans([("attention.backward", 65, 70, [])], tid=2)
    events = (kernel("clip_gemm", 10, 12, 10, 1) + kernel("gemm_fwd", 45, 45, 13, 3)
              + kernel("mse", 57, 58, 3, 4) + kernel("bwd", 66, 66, 13, 5, tid=2)
              + kernel("adamw", 85, 85, 5, 6))
    events += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 31,
                "dur": 1, "tid": 1, "args": {"correlation": 2}},
               {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)",
                "ts": 31, "dur": 1, "args": {"correlation": 2}}]
    return program.parse(events, BASE, main + autograd, {"host_syncs": 4}, BASE,
                         BASE + 100_000, {"steps": 1}, main_tid=1)


def sampling_window():
    """Two denoiser steps of one request, us 0-90."""
    records = spans([("sample.step", 0, 40, [("denoiser", 5, 30, [])]),
                     ("sample.step", 40, 80, [("denoiser", 45, 70, [])])], tid=1)
    for r in records:
        r.request = 7
    events = (kernel("gemm", 5.5, 6, 24, 1) + kernel("posterior", 31, 31, 7, 2)
              + kernel("gemm", 45.5, 46, 24, 3) + kernel("posterior", 71, 72, 6, 4))
    return program.parse(events, BASE, records, {}, BASE, BASE + 90_000, {"steps": 2},
                         main_tid=1)


def test_the_training_window_by_hand():
    p = training_window()
    assert p.busy_s == pytest.approx(45e-6) and p.window_s == pytest.approx(100e-6)
    assert p.idle_s() == pytest.approx(55e-6)
    opened = {name: spans for name, _, _, spans in p.ops}
    assert opened["bwd"] == {"train.block", "train.step", "train.backward",
                             "attention.backward"}
    assert opened["mse"] == {"train.block", "train.step", "train.loss"}
    assert opened["Memcpy HtoD (Pageable -> Device)"] == {"train.block", "train.to_device",
                                                          "sync"}
    # idle: [0, 12] and [22, 30] in the host batch, [30, 31] and [32, 40] in
    # the copies, [40, 45], [61, 66], [79, 85], [90, 95] in the step, [95, 100]
    # in the block alone
    assert p.idle_ms("train.host_batch") == pytest.approx(0.020)
    assert p.idle_ms("train.to_device", "train.step") == pytest.approx(0.030)
    assert p.idle_ms("train.block") == pytest.approx(0.055)
    assert p.idle_ms("sync") == pytest.approx(0.007)  # [5, 6], [22, 25], [30, 31], [35, 37]
    parents = {name: p.spans[parent][0] for name, _, _, _, parent, _ in p.spans
               if parent is not None}
    assert parents["denoiser"] == "train.loss" and parents["clip.encode"] == "train.host_batch"
    assert p.spans[0][1] == pytest.approx(5.0)  # ns -> the trace's us


def test_the_sampling_window_by_hand():
    p = sampling_window()
    assert p.busy_s == pytest.approx(61e-6) and p.idle_s() == pytest.approx(29e-6)
    assert p.device_ms(within=("denoiser",)) == pytest.approx(0.048)
    assert p.device_ms(within=("sample.step",), outside=("denoiser",)) == pytest.approx(0.013)
    assert p.idle_ms("sample.step") == pytest.approx(0.019)
    assert {s[5] for s in p.spans} == {7}


def _read(name, tr):
    reader = harness.load_module(METRICS / f"{name}.py", "m_" + name.replace(".", "_"))
    return reader.read(tr)


@pytest.mark.parametrize("name, want", [
    ("host_batch_idle_ms.train", 0.020), ("step_idle_ms.train", 0.030),
    ("host_syncs.train", 4.0), ("clip_device_ms.train", 0.010),
    ("forward_device_ms.train", 0.013), ("loss_device_ms.train", 0.003),
    ("backward_device_ms.train", 0.013), ("optimizer_device_ms.train", 0.005),
    ("step_idle_ms.sample", 0.0095)])
def test_each_new_reader_by_hand(name, want):
    window = sampling_window() if name.endswith(".sample") else training_window()
    tr = program.attach(trace.Trace([], [], 0.0, 0.0, 0.0, {}), window)
    assert _read(name, tr) == pytest.approx(want)
    # the busy time of the step is the parts' device time plus the copies
    if name == "loss_device_ms.train":
        parts = sum(_read(n, tr) for n in NEW if n.endswith("_device_ms.train"))
        copies = window.device_ms(within=("train.to_device",))
        assert parts + copies == pytest.approx(1e3 * window.busy_s)


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_spans_reads_nothing(name):
    """The parent's program has no recording: no third window."""
    assert _read(name, trace.Trace([], [], 0.0, 0.0, 0.0, {})) is None


def test_the_window_runs_once_from_the_harness_call():
    """A reader called inside the harness's `run_cell` runs the window once,
    with the work `run_cell` gave window 1, and every reader reads it."""
    from regennet_torch.utils import profiling

    calls = []

    class Driver:
        @staticmethod
        def window(state, seconds, steps, traced):
            calls.append((state, seconds, steps, traced))
            for _ in range(steps):
                with profiling.span("train.step"):
                    profiling.count("host_syncs", 2)
            return {"steps": steps}

    def run_cell(driver, state, cell, sync):
        tr = trace.Trace([], [], 0.0, 0.0, 0.0, {})
        return tr, [_read("host_syncs.train", tr), _read("host_syncs.train", tr)]

    tr, values = run_cell(Driver, "state", {"trace_steps": 3}, lambda: None)
    assert values == [2.0, 2.0]
    assert calls == [("state", None, 3, False)]
    assert [s[0] for s in program.of(tr).spans] == ["train.step"] * 3


def _outside_trace(config):
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "pb:window", "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "pb:host_batch", "ts": 1, "dur": 8,
         "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "pb:denoiser", "ts": 10, "dur": 30,
         "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "pb:attention", "ts": 20, "dur": 5,
         "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "pb:attention_fwd", "ts": 20, "dur": 5,
         "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "pb:attention_bwd", "ts": 50, "dur": 10,
         "tid": 2},
    ]
    events += (kernel("gemm", 12, 14, 10, 1) + kernel("attn", 21, 22, 6, 2)
               + kernel("add", 45, 46, 4, 3) + kernel("bwd", 51, 52, 8, 4, tid=2))
    attention = [("forward", 64, 150, 512, 4, True), ("backward", 64, 150, 512, 4, True)]
    info = {"steps": 2, "denoiser_calls": 2, "config": config, "rows": 64,
            "attention": attention}
    tr = trace.parse(events, 0.0, 100.0, info)
    return dataclasses.replace(tr, timed={"steps": 2, "config": config, "rows": 64},
                               device_ops=tr.ops, busy_s=26e-6, window_s=1e-4,
                               span_window_s=tr.window_s)


@pytest.mark.parametrize("name", sorted(m["name"] for m in json.loads(
    (REPO / "BENCHMARK.json").read_text())["per_layer"] if m["name"] not in NEW))
def test_the_other_readers_read_the_same_with_the_program(name):
    config = json.loads((harness.ROOT / "configs" / "chi3d_online.json").read_text())
    tr = _outside_trace(config)
    without = _read(name, tr)
    assert without is not None
    assert _read(name, program.attach(dataclasses.replace(tr), training_window())) == without
    assert _read(name, program.attach(dataclasses.replace(tr), sampling_window())) == without


def test_the_new_metrics_are_listed_and_read_the_program_alone():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    listed = {m["name"]: m for m in bench["per_layer"]}
    assert set(NEW) <= set(listed)
    for name in NEW:
        cell = "chi3d_online.eval_sample" if name.endswith(".sample") else "humanml_text.train"
        assert listed[name]["workloads"] == [cell]
        assert "recorded.of(trace)" in Path(METRICS / f"{name}.py").read_text()


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the device trace runs only there")


@pytest.mark.cuda
def test_each_device_op_lies_in_the_span_that_launched_it(card):
    """Twenty spans, one kernel each, and a backward launched from
    autograd's thread: after the clock conversion every device operation
    of the window lies in the span that launched it."""
    import torch

    from regennet_torch.utils import profiling

    x = torch.ones(1 << 20, device="cuda")
    w = torch.ones(256, 256, device="cuda", requires_grad=True)

    class Spanned(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a):
            return a * 2.0

        @staticmethod
        def backward(ctx, g):
            ctx.tid = threading.get_native_id()
            with profiling.span("backward.inner"):
                return g * 3.0

    def timed():
        for i in range(20):
            with profiling.span(f"k{i}"):
                x.mul_(1.0 + 1e-7 * i)
        with profiling.span("backward"):
            Spanned.apply(w).sum().backward()
        return {"steps": 1}

    window = program.window(timed, torch.cuda.synchronize)
    assert window is not None and window.ops
    launched = [opened for name, _, _, opened in window.ops
                if any(n.startswith("k") and n[1:].isdigit() for n in opened)]
    assert len(launched) == 20
    for i, opened in enumerate(launched):
        assert opened == {f"k{i}"}
    assert all(opened for _, _, _, opened in window.ops)
    inner = [o for _, _, _, o in window.ops if "backward.inner" in o]
    assert inner and all(o == {"backward", "backward.inner"} for o in inner)
    starts = {n: s for n, s, *_ in window.spans}
    kernels = [ts for _, ts, _, opened in window.ops if opened and next(iter(opened))[0] == "k"]
    assert kernels == sorted(kernels)
    assert starts["k0"] <= kernels[0]
