"""The benchmark on the card: one short traced run of the sampling cell,
whose device readings exist only there (`python -m pytest -m cuda
portbench/tests` on a machine with an NVIDIA GPU)."""

import io
import json

import pytest

from _portbench_helpers import harness


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels and the device trace run only there")


@pytest.mark.cuda
def test_a_traced_run_on_the_card(card):
    out = io.StringIO()
    harness.run_cell("chi3d_online.eval_sample", 2 ** 31 + 101, 2.0, True, out=out)
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    for name in ("mfu.sample", "attention_roofline.sample"):
        assert 0 < result["metrics"][name]["value"] <= 100
