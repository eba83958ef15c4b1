"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Every test here is marked `cuda` and skips without a CUDA device. The
file imports no JAX, so it also runs where JAX is absent:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
Tolerances as in tests/test_torch_attention.py.
"""

import math

import numpy as np
import pytest
import torch

from regennet_torch.ops import attention

DTYPE_MODES = [("float32", False), ("bfloat16", False), ("bfloat16", True)]
MASKS = ["causal", "full", "kv_len"]


def _tolerance(dtype, ref):
    scale = max(1.0, float(np.abs(ref).max()))
    return (1e-5 if dtype == "float32" else 2.0 ** -6) * scale


@pytest.mark.cuda
@pytest.mark.parametrize("T", [60, 151])
@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("dtype,softmax_f32", DTYPE_MODES)
def test_cuda_kernel_matches_plain_version(T, mask, dtype, softmax_f32):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the GPU")
    batch, dmodel, heads = 8, 512, 4
    gen = torch.Generator(device="cuda").manual_seed(T)
    packed = torch.randn(batch, T, 3 * dmodel, device="cuda", generator=gen)
    packed = packed.to(getattr(torch, dtype))
    q, k, v = packed.split(dmodel, dim=-1)
    causal = mask == "causal"
    kv_len = T - 7 if mask == "kv_len" else None
    before = attention.fused_attention_btd.launches
    out = attention.fused_attention_btd(q, k, v, heads, causal, softmax_f32, kv_len)
    torch.cuda.synchronize()
    assert attention.fused_attention_btd.launches == before + 1
    ref = attention.attention_btd_reference(q, k, v, heads, causal, softmax_f32, kv_len)
    ref_np = ref.float().cpu().numpy()
    np.testing.assert_allclose(
        out.float().cpu().numpy(), ref_np, rtol=0,
        atol=_tolerance(dtype, ref_np),
    )
    assert math.isfinite(float(out.float().abs().max()))
