"""The program's own spans and counters, read in a third traced window.

`window(timed, sync)` runs the timed work once more, under the CUDA
activity alone as the timed window does, with the program's recording on
(`regennet_torch.utils.profiling.recording`): the program records a span
with `time.time_ns()` at each of its layers' boundaries, and counts its
blocking copies. The Chrome trace's clock is the same (an event's `ts` in
us x 1000 + the trace's `baseTimeNanoseconds`), so the spans convert to
the trace's us exactly and `parse` places each device operation in the
program spans open at its launch (the cuda_runtime or cuda_driver event of
the same correlation id) on any host thread: autograd launches a GPU
backward from its own thread while the main thread waits inside
`train.backward`. Idle time is split piecewise among the main thread's
innermost open spans. A program without `recording` (an older checkout)
gives None, and the readers of this window read nothing.

The harness hands a reader the `Trace` of the first two windows alone
(trace.traced_window). `of(trace)` runs this window once for that Trace,
when its first reader asks, after the other two: the timed work is the
one the harness's `run_cell` gave window 1 (`driver.window(state, None,
cell["trace_steps"], False)` and `sync`, read from that call's frame, so
that trace.py and harness.py stay as they are). Outside such a call, and
where a Trace was given its window (`attach`), nothing more runs.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from portbench.trace import DEVICE_CATS, LAUNCH_CATS, merge


@dataclasses.dataclass
class Program:
    """The third window. spans: [(name, start_us, dur_us, tid, parent
    index or None, request id or None)] on the trace's clock; ops: device
    operations [(name, start_us, dur_us, names of the program spans open
    at the launch)]; idle: the window's idle us by the index of the main
    thread's innermost open span (None: outside every span); the window's
    busy seconds, wall, the driver's counts (`timed()`'s return) and
    the program's counter totals."""
    spans: List[Tuple[str, float, float, int, Optional[int], Optional[int]]]
    ops: List[Tuple[str, float, float, frozenset]]
    idle: Dict[Optional[int], float]
    busy_s: float
    window_s: float
    counts: dict
    counters: Dict[str, int]

    @property
    def steps(self) -> int:
        return int(self.counts.get("steps", 0))

    def device_ms(self, within: Iterable[str] = (), outside: Iterable[str] = ()) -> float:
        """Device ms of the operations launched while every span of
        `within` and none of `outside` was open."""
        within, outside = frozenset(within), frozenset(outside)
        return sum(dur for _, _, dur, opened in self.ops
                   if within <= opened and not outside & opened) / 1e3

    def idle_ms(self, *names: str) -> float:
        """The card's idle ms while the main thread was inside a span of
        one of `names` (its innermost open span or an ancestor of it)."""
        total = 0.0
        for index, us in self.idle.items():
            while index is not None:
                if self.spans[index][0] in names:
                    total += us
                    break
                index = self.spans[index][4]
        return total / 1e3

    def idle_s(self) -> float:
        return sum(self.idle.values()) / 1e6


def _spans_us(records, base_ns: int):
    """The program's SpanRecords as tuples on the trace's us clock."""
    index = {id(r): i for i, r in enumerate(records)}
    return [(r.name, (r.start_ns - base_ns) / 1e3, (r.end_ns - r.start_ns) / 1e3, r.tid,
             index.get(id(r.parent)) if r.parent is not None else None, r.request)
            for r in records]


def _open_at(spans, times) -> Dict[float, frozenset]:
    """{t: names of the spans open at t on any thread} by one sweep."""
    bounds = sorted((start, start + dur, name) for name, start, dur, *_ in spans)
    out: Dict[float, frozenset] = {}
    active: List[Tuple[float, str]] = []
    i, names = 0, frozenset()
    for t in sorted(set(times)):
        changed = False
        while i < len(bounds) and bounds[i][0] <= t:
            active.append((bounds[i][1], bounds[i][2]))
            i += 1
            changed = True
        kept = [a for a in active if a[0] >= t]
        if changed or len(kept) != len(active):
            active = kept
            names = frozenset(name for _, name in active)
        out[t] = names
    return out


def _innermost(spans, tid) -> List[Tuple[float, float, Optional[int]]]:
    """The main thread's timeline as [(start, end, index of the innermost
    open span or None)]; a thread's spans nest."""
    own = sorted(((s, s + d, i) for i, (_, s, d, t, *_) in enumerate(spans) if t == tid),
                 key=lambda x: (x[0], -x[1]))
    segments = []
    stack: List[Tuple[float, int]] = []
    cursor = float("-inf")

    def close_until(t):
        nonlocal cursor
        while stack and stack[-1][0] <= t:
            end, i = stack.pop()
            if end > cursor:
                segments.append((cursor, end, i))
                cursor = end

    for start, end, i in own:
        close_until(start)
        if start > cursor:
            segments.append((cursor, start, stack[-1][1] if stack else None))
            cursor = start
        stack.append((end, i))
    close_until(float("inf"))
    segments.append((cursor, float("inf"), None))
    return segments


def _split_idle(gaps, segments) -> Dict[Optional[int], float]:
    """us of each gap by the segment it overlaps (both sorted, disjoint)."""
    idle: Dict[Optional[int], float] = {}
    j = 0
    for s, e in gaps:
        while j < len(segments) and segments[j][1] <= s:
            j += 1
        k = j
        while k < len(segments) and segments[k][0] < e:
            lo, hi = max(s, segments[k][0]), min(e, segments[k][1])
            if hi > lo:
                idle[segments[k][2]] = idle.get(segments[k][2], 0.0) + hi - lo
            k += 1
    return idle


def parse(events: List[dict], base_ns: int, records, counters: Dict[str, int], t0_ns: int,
          t1_ns: int, counts: dict, main_tid: int) -> Program:
    """The Program of a Chrome trace's events, the program's span records
    and counter totals, between host times t0 and t1 (time.time_ns())."""
    t0, t1 = (t0_ns - base_ns) / 1e3, (t1_ns - base_ns) / 1e3
    spans = _spans_us(records, base_ns)
    launches: Dict[int, float] = {}
    devs = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat", ""), e.get("args") or {}
        if cat in DEVICE_CATS:
            devs.append((e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)),
                         args.get("correlation")))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = float(e["ts"])
    devs = [d for d in devs if d[1] + d[2] >= t0 and d[1] <= t1]
    opened = _open_at(spans, [launches[c] for *_, c in devs if c in launches])
    ops = [(name, ts, dur, opened[launches[c]] if c in launches else frozenset())
           for name, ts, dur, c in devs]
    busy = merge([(max(s, t0), min(s + d, t1)) for _, s, d, _ in ops])
    edges = [t0] + [x for b in busy for x in b] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    idle = _split_idle(gaps, _innermost(spans, main_tid))
    return Program(spans, ops, idle, sum(e - s for s, e in busy) / 1e6, (t1 - t0) / 1e6, counts,
                   dict(counters))


def _trace_json(prof) -> dict:
    """The profile's Chrome trace: its events and `baseTimeNanoseconds`."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)


def window(timed: Callable[[], dict], sync: Callable[[], None],
           attempts: int = 3) -> Optional[Program]:
    """`timed()` once more under the CUDA activity alone with the program's
    recording on; None where the program has no recording. The CUDA
    activity records the launches (cuda_runtime) beside the device
    operations; a profile without them raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from regennet_torch.utils import profiling

    recording = getattr(profiling, "recording", None)
    if recording is None:
        return None
    cuda = torch.cuda.is_available()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
            sync()
            with recording() as rec:
                t0 = time.time_ns()
                counts = timed()
                sync()
                t1 = time.time_ns()
        trace = _trace_json(prof)
        events = trace.get("traceEvents", [])
        if not cuda or any(e.get("cat") in DEVICE_CATS for e in events):
            break
    else:
        raise RuntimeError(f"the program's window recorded no device time in {attempts} "
                           "profiles")
    if cuda and not any(e.get("cat") in LAUNCH_CATS for e in events):
        raise RuntimeError("the program's window recorded no launch events")
    return parse(events, int(trace["baseTimeNanoseconds"]), rec.spans, rec.counters, t0, t1,
                 counts, threading.get_native_id())


def attach(trace, program: Optional[Program]):
    """Give `trace` its program window (the readers read it by `of`)."""
    trace.program = program
    return trace


def _cell_run(trace) -> Optional[dict]:
    """The locals of the harness's `run_cell` call whose traced windows
    gave `trace` (its `tr`), or None outside such a call."""
    frame = sys._getframe(1)
    while frame is not None:
        if frame.f_code.co_name == "run_cell" and frame.f_locals.get("tr") is trace:
            return frame.f_locals
        frame = frame.f_back
    return None


def of(trace) -> Optional[Program]:
    """The program window of the traced run that gave `trace`: run once,
    on the first call, and kept on the Trace; None where the program
    records no spans or no run gave `trace`."""
    if "program" not in vars(trace):
        run = _cell_run(trace)
        if run is None:
            return attach(trace, None).program
        driver, state, steps = run["driver"], run["state"], run["cell"]["trace_steps"]
        attach(trace, window(lambda: driver.window(state, None, steps, False), run["sync"]))
    return trace.program
