"""Spans and the traced window.

The benchmark records spans from its own files only, around its calls
into the program's layers: `span(name)` is a torch.profiler
record_function range named "pb:<name>" (a no-op cost outside a
profile). `BackwardSpan` opens a span when the gradient reaches a
function's output and closes it when the gradient leaves its inputs, so
that a backward pass has a span of its own.

`traced_window(timed, spanned)` profiles the same work twice and turns
the Chrome traces into a `Trace`: from a window under the CUDA activity
alone, the union of device busy time against the window's wall; from a
window with the CPU activity too, every device operation with the
benchmark spans that were open on the host thread that launched it
(matched through the launch's correlation id), and the spans themselves.
A profile that recorded no device time is taken again, as
chip_smoke.device_events (commit b14d20cb6bbaa9fb4189ca13e12634674eb6d23e)
does, up to three profiles in all.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

PREFIX = "pb:"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def span(name: str):
    return torch.profiler.record_function(PREFIX + name)


class BackwardSpan:
    """A span around the backward of whatever runs between `enter(...)` on
    its inputs and `exit(...)` on its outputs (both identities)."""

    def __init__(self, name: str):
        self.name = name
        self._open: List[torch.profiler.record_function] = []

    def enter(self, *xs):
        return _SpanEnd.apply(self, *xs)

    def exit(self, x):
        return _SpanStart.apply(self, x)


class _SpanStart(torch.autograd.Function):
    @staticmethod
    def forward(ctx, owner, x):
        ctx.owner = owner
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        rf = span(ctx.owner.name)
        rf.__enter__()
        ctx.owner._open.append(rf)
        return None, g


class _SpanEnd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, owner, *xs):
        ctx.owner = owner
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        if ctx.owner._open:
            ctx.owner._open.pop().__exit__(None, None, None)
        return (None,) + gs


@dataclasses.dataclass
class Trace:
    """The traced windows. Of the spanned one: device ops [(name,
    start_us, dur_us, spans)], spans [(name, start_us, dur_us, tid)], its
    start and length, and what the driver counted in it (`info`). Of the
    timed one: the device's busy seconds (the union of its operations'
    intervals), the window's wall, its device ops and counts (`timed`)."""
    ops: List[Tuple[str, float, float, frozenset]]
    spans: List[Tuple[str, float, float, int]]
    busy_s: float
    window_s: float
    start_us: float
    info: dict
    timed: dict = dataclasses.field(default_factory=dict)
    device_ops: list = dataclasses.field(default_factory=list)
    span_window_s: float = 0.0

    def device_ms(self, within: Optional[str] = None, outside: Optional[str] = None) -> float:
        """Summed device time of ops launched inside span `within` (any op
        if None) and not inside span `outside`."""
        total = 0.0
        for _, _, dur, spans in self.ops:
            if within is not None and within not in spans:
                continue
            if outside is not None and outside in spans:
                continue
            total += dur
        return total / 1e3

    def span_ms(self, *names: str) -> float:
        return sum(dur for name, _, dur, _ in self.spans if name in names) / 1e3

    def busy_intervals(self) -> List[Tuple[float, float]]:
        return merge([(s, s + d) for _, s, d, _ in self.ops])


def merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def open_spans(spans, points) -> Dict[Tuple[float, object], frozenset]:
    """{(ts, tid): names of the spans open on thread tid at host time ts}
    for each point, by one sweep per thread (a thread's spans nest)."""
    out: Dict[Tuple[float, object], frozenset] = {}
    by_tid: Dict[object, list] = {}
    for name, ts, dur, tid in spans:
        by_tid.setdefault(tid, []).append((ts, ts + dur, name))
    points_by_tid: Dict[object, list] = {}
    for p in set(points):
        points_by_tid.setdefault(p[1], []).append(p[0])
    for tid, times in points_by_tid.items():
        todo = sorted(by_tid.get(tid, []))
        stack: List[Tuple[float, str]] = []
        i = 0
        for ts in sorted(times):
            while i < len(todo) and todo[i][0] <= ts:
                start, end, name = todo[i]
                while stack and stack[-1][0] < start:
                    stack.pop()
                stack.append((end, name))
                i += 1
            while stack and stack[-1][0] < ts:
                stack.pop()
            out[(ts, tid)] = frozenset(name for _, name in stack)
    return out


def parse(events: List[dict], t0_us: float, t1_us: float, info: dict) -> Trace:
    """A Trace of the Chrome trace events between host times t0 and t1."""
    launches: Dict[int, Tuple[float, int]] = {}
    devs, spans = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        args = e.get("args") or {}
        if cat in DEVICE_CATS:
            devs.append((e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)),
                         args.get("correlation")))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (float(e["ts"]), e.get("tid"))
        elif cat == "user_annotation" and str(e.get("name", "")).startswith(PREFIX):
            spans.append((e["name"][len(PREFIX):], float(e["ts"]), float(e.get("dur", 0.0)),
                          e.get("tid")))
    ops = []
    for name, ts, dur, corr in devs:
        if ts + dur < t0_us or ts > t1_us:
            continue
        ops.append((name, ts, dur, launches.get(corr)))
    opened = open_spans(spans, [op[3] for op in ops if op[3] is not None])
    ops = [(name, ts, dur, opened.get(launch, frozenset()) if launch else frozenset())
           for name, ts, dur, launch in ops]
    busy = sum(e - s for s, e in merge([(max(s, t0_us), min(s + d, t1_us))
                                        for _, s, d, _ in ops]))
    return Trace(ops, spans, busy / 1e6, (t1_us - t0_us) / 1e6, t0_us, info)


def _events(prof) -> List[dict]:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    return events.get("traceEvents", []) if isinstance(events, dict) else events


def busy_seconds(prof) -> float:
    """The union of a profile's device-operation intervals, in seconds."""
    device = [e for e in _events(prof) if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    return sum(e - s for s, e in merge([(float(x["ts"]), float(x["ts"]) + float(x.get("dur", 0.0)))
                                        for x in device])) / 1e6


def traced_window(timed: Callable[[], dict], spanned: Callable[[], dict],
                  sync: Callable[[], None], attempts: int = 3) -> Trace:
    """Two traced windows of the same work, one after the other. The first,
    `timed()` under the CUDA activity alone, gives the device's busy time
    against the window's wall at little cost on the host. The second,
    `spanned()` with the CPU activity and the benchmark's spans, gives each
    device operation the spans that launched it; the profiler's cost per
    host op slows its host, so its gaps read long. Each returns the
    driver's counts (`timed` and `info`)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
            sync()
            t0 = time.perf_counter()
            counts = timed()
            sync()
            wall = time.perf_counter() - t0
        device = [e for e in _events(prof) if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        if device or not cuda:
            break
    else:
        raise RuntimeError(f"the profiler recorded no device time in {attempts} profiles")
    device_ops = [(e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)), frozenset())
                  for e in device]
    busy = sum(e - s for s, e in merge([(s, s + d) for _, s, d, _ in device_ops])) / 1e6
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        sync()
        with span("window"):
            info = spanned()
            sync()
    events = _events(prof)
    window = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name") == PREFIX + "window"]
    t0 = float(window[0]["ts"])
    trace = parse(events, t0, t0 + float(window[0].get("dur", 0.0)), info)
    return dataclasses.replace(trace, busy_s=busy, window_s=wall, timed=counts,
                               device_ops=device_ops, span_window_s=trace.window_s)


@contextlib.contextmanager
def wrapped(module, attr: str, make: Callable):
    """module.attr replaced by make(original) inside the block."""
    original = getattr(module, attr)
    setattr(module, attr, make(original))
    try:
        yield
    finally:
        setattr(module, attr, original)
