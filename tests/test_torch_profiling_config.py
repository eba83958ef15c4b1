"""regennet_torch.utils.profiling and utils.config against the JAX
package's modules: the path constants are the same, StepTimer gives the
same summary for the same tick times, and trace() writes a TensorBoard
trace of the block with annotate()'s span in it."""

import os

import pytest
import torch

from regennet_tpu.utils import config as jconfig
from regennet_tpu.utils import profiling as jprofiling
from regennet_torch.utils import config, profiling


def test_config_constants_match_jax():
    names = [n for n in vars(jconfig) if n.isupper()]
    assert len(names) == 9
    for name in names:
        assert getattr(config, name) == getattr(jconfig, name), name


@pytest.mark.parametrize("warmup", [0, 2])
def test_step_timer_matches_jax(monkeypatch, warmup):
    ticks = [0.0, 0.5, 0.75, 1.0, 1.5, 1.625, 2.25]
    summaries = []
    for module in (jprofiling, profiling):
        clock = iter(ticks)
        monkeypatch.setattr(module.time, "time", lambda: next(clock))
        timer = module.StepTimer(warmup=warmup)
        assert timer.summary() == {}
        for _ in ticks:
            timer.tick()
        summaries.append(timer.summary())
        monkeypatch.undo()
    assert summaries[0] == summaries[1]
    assert set(summaries[1]) == {"step_ms_p50", "step_ms_p90", "steps_per_sec"}


def test_trace_writes_a_tensorboard_trace_with_the_span(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir) as prof:
        with profiling.annotate("regennet_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = [os.path.join(d, f) for d, _, fs in os.walk(logdir) for f in fs]
    assert files and all(f.endswith(".pt.trace.json") for f in files)
    assert "regennet_span" in open(files[0]).read()
    assert any(e.key == "regennet_span" for e in prof.key_averages())
