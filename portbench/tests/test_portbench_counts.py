"""The yardstick's counts against values worked out by hand, and the
traced-window arithmetic on a trace made up by hand."""

import json

import pytest

from _portbench_helpers import REPO
from portbench import trace
from portbench.counts import attention, flops
from portbench.counts.kernel_groups import kernel_group

CHI3D = json.loads((REPO / "portbench/configs/chi3d_online.json").read_text())
TEXT = json.loads((REPO / "portbench/configs/humanml_text.json").read_text())


def test_flagship_sampling_step_by_hand():
    # 64 rows (32 under CFG) x 150 frames, 8 decoder layers of width 512,
    # ff 1024: per layer qkv, causal QK^T and AV over 11,325 pairs, out,
    # ff, and the one-token cross-attention's v and out projections
    B, T, D, FF, F = 64, 150, 512, 1024, 336
    n = B * T
    layer = 2 * n * D * 3 * D + 4 * B * 11325 * D + 2 * n * D * D + 4 * n * D * FF + 4 * B * D * D
    by_hand = 2 * n * F * D + 4 * B * D * D + 2 * n * D * F + 8 * layer
    assert by_hand == 341_207_678_976
    assert flops.denoiser_forward(CHI3D, 64, train=False) == by_hand


def test_training_steps_by_hand():
    assert flops.train_step(CHI3D, 64) == 1_183_721_717_760
    # 197 tokens, non-causal: 38,809 pairs; the text embedding's Linear
    B, T, D, FF, F = 64, 196, 512, 1024, 263
    n, frames = B * 197, B * T
    layer = 2 * n * D * 3 * D + 4 * B * 38809 * D + 2 * n * D * D + 4 * n * D * FF
    forward = (4 * frames * F * D + 2 * frames * 2 * D * D + 4 * B * D * D + 2 * frames * D * F
               + 2 * B * 512 * D + 8 * layer)
    assert flops.train_step(TEXT, 64) == 3 * forward == 1_461_411_643_392


@pytest.mark.parametrize("args, forward, backward", [
    ((64, 150, 512, 4, "float32", True), 78_643_200 / 3.35e12, 2 * 5 * 64 * 11325 * 512 / 67e12),
    ((64, 197, 512, 4, "float32", False), 2 * 2 * 64 * 197 * 197 * 512 / 67e12,
     2 * 5 * 64 * 197 * 197 * 512 / 67e12),
])
def test_attention_bounds_by_hand(args, forward, backward):
    assert attention.forward_ms(*args) == pytest.approx(forward * 1e3, rel=1e-12)
    assert attention.backward_ms(*args) == pytest.approx(backward * 1e3, rel=1e-12)


def test_kernel_groups():
    assert kernel_group("ampere_sgemm_128x64_nn") == "dense GEMMs (cuBLAS)"
    assert kernel_group("void attention_fwd_kernel<float, 160, false, false, true>(Args)") == \
        "training attention forward"
    assert kernel_group("void attention_fwd_stored<float, false, false>(Args)") == \
        "attention forward (B1, B3)"
    assert kernel_group("void attention_train_rows_stored<float, false>()") == \
        "training attention backward"
    assert kernel_group("Memcpy HtoD (Pageable -> Device)") == "Memcpy"
    assert kernel_group("void at::native::vectorized_elementwise_kernel<...>") == \
        "other elementwise"


def test_a_trace_by_hand():
    """Device time goes to the spans open on the launching thread; busy
    time is the union of device intervals inside the window."""
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "pb:window", "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "pb:denoiser", "ts": 10, "dur": 30, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "pb:attention", "ts": 20, "dur": 5, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "pb:attention_bwd", "ts": 50, "dur": 10,
         "tid": 2},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 12, "dur": 1,
         "tid": 1, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 21, "dur": 1,
         "tid": 1, "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 45, "dur": 1,
         "tid": 1, "args": {"correlation": 3}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 51, "dur": 1,
         "tid": 2, "args": {"correlation": 4}},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 14, "dur": 10,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "attn", "ts": 22, "dur": 6,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "add", "ts": 46, "dur": 4,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "bwd", "ts": 52, "dur": 8,
         "args": {"correlation": 4}},
    ]
    tr = trace.parse(events, 0.0, 100.0, {})
    assert tr.device_ms(within="denoiser") == pytest.approx(16e-3)
    assert tr.device_ms(within="attention") == pytest.approx(6e-3)
    assert tr.device_ms(outside="denoiser") == pytest.approx(12e-3)
    assert tr.device_ms(within="attention_bwd") == pytest.approx(8e-3)
    assert tr.busy_s == pytest.approx((14 + 4 + 8) * 1e-6)  # [14, 28], [46, 50], [52, 60]
    assert tr.window_s == pytest.approx(1e-4)
