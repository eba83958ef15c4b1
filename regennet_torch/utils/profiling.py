"""Spans, counters and traces of the program's own layers (counterpart of
regennet_tpu/utils/profiling.py).

  * `span(name, request=None)`: a named interval of a layer. Off (the
    default) it is one flag check that returns a shared no-op context: no
    clock read, no allocation, no record_function. Inside `recording()` it
    records a `SpanRecord` (name, start and end by `time.time_ns()`, the
    thread's native id, the innermost span open on the same thread, and a
    request id, inherited from that parent unless given); while a torch
    profiler is active it also opens `record_function("regennet/" + name)`,
    so the profiler's trace shows the span. `time.time_ns()` is the clock
    of torch.profiler's Chrome trace: an event's `ts` (us) x 1000 plus the
    trace's `baseTimeNanoseconds`.
  * `blocking()`: a `span("sync")` around a transfer that waits for the
    device, counted as `host_syncs` (each site reached, whatever the device).
  * `count(name, n=1)`: adds to a counter while recording.
  * `new_request()`: a fresh request id while recording (None when off).
  * `recording()`: turns recording on for its block and yields the
    `Recording`, whose `spans` (in the order they closed) and `counters`
    are complete once the block exits. Safe across threads: autograd runs
    a GPU backward on a thread of its own, whose spans keep their own stack.
  * `trace(logdir)`: a torch.profiler window written for TensorBoard.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

PREFIX = "regennet/"
_NOOP = contextlib.nullcontext()
_recording: Optional["Recording"] = None
_requests = itertools.count(1)


@dataclasses.dataclass(eq=False)
class SpanRecord:
    name: str
    start_ns: int
    end_ns: int
    tid: int
    parent: Optional["SpanRecord"]
    request: Optional[int]


class Recording:
    """The spans and counter totals of one `recording()` block."""

    def __init__(self):
        self.spans: List[SpanRecord] = []
        self.counters: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._local = threading.local()

    def thread(self) -> Tuple[List[SpanRecord], int]:
        """The calling thread's open spans (innermost last) and its native
        id, read once per thread: the id is a system call."""
        mine = getattr(self._local, "mine", None)
        if mine is None:
            mine = self._local.mine = ([], threading.get_native_id())
        return mine

    def add(self, record: SpanRecord):
        with self._lock:
            self.spans.append(record)

    def count(self, name: str, n: int):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n


class _Span:
    __slots__ = ("recording", "name", "request", "record", "range", "stack")

    def __init__(self, recording: Recording, name: str, request: Optional[int]):
        self.recording, self.name, self.request = recording, name, request
        self.record = self.range = self.stack = None

    def __enter__(self):
        stack, tid = self.recording.thread()
        self.stack = stack
        parent = stack[-1] if stack else None
        request = self.request
        if request is None and parent is not None:
            request = parent.request
        # the clock is read outside the record_function range, so the span
        # brackets its event in the profiler's trace
        self.record = SpanRecord(self.name, time.time_ns(), 0, tid, parent, request)
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(PREFIX + self.name)
            self.range.__enter__()
        stack.append(self.record)
        return self.record

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        self.record.end_ns = time.time_ns()
        self.stack.pop()
        self.recording.add(self.record)
        return False


def span(name: str, request: Optional[int] = None):
    """A context manager around one interval of layer `name`."""
    if _recording is None:
        return _NOOP
    return _Span(_recording, name, request)


def count(name: str, n: int = 1):
    if _recording is not None:
        _recording.count(name, n)


def blocking():
    """A `sync` span around a transfer that waits for the device."""
    if _recording is None:
        return _NOOP
    _recording.count("host_syncs", 1)
    return _Span(_recording, "sync", None)


def new_request() -> Optional[int]:
    """A fresh id for the spans of one request while recording, else None."""
    if _recording is None:
        return None
    return next(_requests)


@contextlib.contextmanager
def recording():
    """Record spans and counters inside the block; yields the Recording."""
    global _recording
    if _recording is not None:
        raise RuntimeError("a recording is already on")
    rec = _recording = Recording()
    try:
        yield rec
    finally:
        _recording = None


@contextlib.contextmanager
def trace(logdir: str, on_trace_ready: Optional[Callable] = None):
    """Profile the block (the CPU, and CUDA where a card is visible) and
    write its trace for TensorBoard into `logdir`
    (torch.profiler.tensorboard_trace_handler), or hand the finished
    profiler to `on_trace_ready` instead. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=on_trace_ready or tensorboard_trace_handler(logdir))
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
