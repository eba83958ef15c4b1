"""regennet_torch.utils.config against the JAX package's module (the path
constants are the same), and utils.profiling.trace(), which writes a
TensorBoard trace of the block with a recorded span in it."""

import os

import torch

from regennet_tpu.utils import config as jconfig
from regennet_torch.utils import config, profiling


def test_config_constants_match_jax():
    names = [n for n in vars(jconfig) if n.isupper()]
    assert len(names) == 9
    for name in names:
        assert getattr(config, name) == getattr(jconfig, name), name


def test_trace_writes_a_tensorboard_trace_with_the_span(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir) as prof, profiling.recording():
        with profiling.span("regennet_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = [os.path.join(d, f) for d, _, fs in os.walk(logdir) for f in fs]
    assert files and all(f.endswith(".pt.trace.json") for f in files)
    assert "regennet/regennet_span" in open(files[0]).read()
    assert any(e.key == "regennet/regennet_span" for e in prof.key_averages())
