"""Profiling and tracing hooks (counterpart of regennet_tpu/utils/profiling.py).

Two layers:
  * `trace(logdir)`: a context manager around torch.profiler (the CPU and,
    where a card is present, the CUDA activity) that writes a
    TensorBoard-loadable trace into `logdir`; `annotate(name)` is a named
    span inside it.
  * `StepTimer`: wall-clock per-step timing with warmup exclusion, for the
    KV logger (steps/sec, p50/p90 step ms).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, List, Optional


@contextlib.contextmanager
def trace(logdir: str, on_trace_ready: Optional[Callable] = None):
    """Profile the block (the CPU, and CUDA where a card is visible) and
    write its trace for TensorBoard into `logdir`
    (torch.profiler.tensorboard_trace_handler), or hand the finished
    profiler to `on_trace_ready` instead. Yields the profiler."""
    import torch
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


def annotate(name: str):
    """Named trace span (torch.profiler.record_function)."""
    from torch.profiler import record_function

    return record_function(name)


class StepTimer:
    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._count = 0
        self._times: List[float] = []
        self._last: Optional[float] = None

    def tick(self):
        now = time.time()
        if self._last is not None:
            self._count += 1
            if self._count > self.warmup:
                self._times.append(now - self._last)
        self._last = now

    def summary(self) -> dict:
        if not self._times:
            return {}
        import numpy as np

        arr = np.asarray(self._times)
        return {
            "step_ms_p50": float(np.percentile(arr, 50) * 1e3),
            "step_ms_p90": float(np.percentile(arr, 90) * 1e3),
            "steps_per_sec": float(1.0 / arr.mean()),
        }
