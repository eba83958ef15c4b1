"""regennet_torch.ops.attention against the JAX package's fused_attention_btd.

The port's plain attention (what the wrapper runs for CPU tensors) is held
against the Pallas kernel in interpret mode on the same numpy inputs; the
CUDA kernel is held against the plain attention on the card
in tests/test_torch_cuda.py.

Tolerances: f32 1e-5 x max(1, max|out|) (the two sum the QK and AV
products in different orders). bf16 2^-6 x max(1, max|out|): outputs are
rounded to bf16 (ulp 2^-7 relative), and with the bf16 softmax a score
whose f32 sum lands on the other side of a bf16 rounding boundary moves
one softmax weight by up to 2^-7 x |score|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regennet_tpu.ops.pallas_attention import fused_attention_btd as jax_attention
from regennet_torch.ops import attention

B, D, H = 2, 64, 4

DTYPE_MODES = [
    ("float32", False),
    ("bfloat16", False),  # the sampler's bf16 softmax
    ("bfloat16", True),
]
MASKS = ["causal", "full", "kv_len"]


def _inputs(T, seed=0):
    rng = np.random.default_rng(seed + T)
    return [rng.normal(size=(B, T, D)).astype(np.float32) for _ in range(3)]


def _tolerance(dtype, ref):
    scale = max(1.0, float(np.abs(ref).max()))
    return (1e-5 if dtype == "float32" else 2.0 ** -6) * scale


@pytest.mark.parametrize("T", [24, 25, 60, 61])
@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("dtype,softmax_f32", DTYPE_MODES)
def test_plain_attention_matches_jax_kernel(T, mask, dtype, softmax_f32):
    q, k, v = _inputs(T)
    causal = mask == "causal"
    kv_len = T - 3 if mask == "kv_len" else None
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    ref = np.asarray(
        jax_attention(
            jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
            num_heads=H, causal=causal, interpret=True,
            softmax_f32=softmax_f32, kv_len=kv_len,
        ).astype(jnp.float32)
    )
    td = getattr(torch, dtype)
    ours = attention.attention_btd_reference(
        torch.tensor(q).to(td), torch.tensor(k).to(td), torch.tensor(v).to(td),
        H, causal=causal, softmax_f32=softmax_f32, kv_len=kv_len,
    )
    assert ours.dtype == td and ours.shape == (B, T, D)
    np.testing.assert_allclose(
        ours.float().numpy(), ref, rtol=0, atol=_tolerance(dtype, ref)
    )


def test_cpu_wrapper_routes_to_plain_version_and_checks_inputs():
    q, k, v = (torch.tensor(a) for a in _inputs(24))
    packed = torch.cat([q, k, v], dim=-1)  # strided views, as the model passes
    qv, kv, vv = packed[..., :D], packed[..., D:2 * D], packed[..., 2 * D:]
    before = attention.fused_attention_btd.launches
    out = attention.fused_attention_btd(qv, kv, vv, H, causal=True)
    torch.testing.assert_close(
        out, attention.attention_btd_reference(q, k, v, H, causal=True),
        rtol=0, atol=0,
    )
    assert attention.fused_attention_btd.launches == before  # no kernel on CPU

    with pytest.raises(ValueError, match="share one"):
        attention.fused_attention_btd(q, k[:, :-1], v, H)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        attention.fused_attention_btd(q.half(), k.half(), v.half(), H)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        attention.fused_attention_btd(q, k.bfloat16(), v, H)
    with pytest.raises(ValueError, match="does not split"):
        attention.fused_attention_btd(q, k, v, 3)
    with pytest.raises(ValueError, match="kv_len"):
        attention.fused_attention_btd(q, k, v, H, causal=False, kv_len=0)


def test_causal_output_ignores_future_keys():
    q, k, v = (torch.tensor(a) for a in _inputs(25))
    out1 = attention.fused_attention_btd(q, k, v, H, causal=True)
    k2, v2 = k.clone(), v.clone()
    k2[:, -1] += 10.0
    v2[:, -1] += 10.0
    out2 = attention.fused_attention_btd(q, k2, v2, H, causal=True)
    torch.testing.assert_close(out1[:, :-1], out2[:, :-1], rtol=0, atol=0)
