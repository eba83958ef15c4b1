"""regennet_torch.ops.attention.fused_causal_attention against the JAX
package's fused_causal_attention (its Pallas kernel in interpret mode) and
attention_reference, on the same numpy inputs [B, H, T, hd].

The port's plain version (what the wrapper runs for CPU tensors) rounds
where the TPU kernel does: f32 scores from the unscaled q, times
1/sqrt(hd) in f32, an f32 softmax, weights cast to v's dtype. Tolerances:
f32 2e-5 absolute (sums in other orders); bf16 2^-7 x max(1, max|jax|),
one bf16 ulp of the largest output (the outputs are rounded to bf16, and
f32 sums in another order can put one on the other side of a rounding
boundary). The JAX attention_reference rounds its bf16 scores to bf16
before the softmax, so at bf16 it is held to the 3e-2 its own test
(tests/test_pallas_attention.py) holds the kernel to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regennet_tpu.ops.pallas_attention import attention_reference as jax_reference
from regennet_tpu.ops.pallas_attention import fused_causal_attention as jax_kernel
from regennet_torch.ops import attention

JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(B, H, T, hd, seed=0):
    rng = np.random.default_rng(seed + T + hd)
    return [rng.normal(size=(B, H, T, hd)).astype(np.float32) for _ in range(3)]


def _torch(arrays, dtype):
    return [torch.tensor(a).to(getattr(torch, dtype)) for a in arrays]


@pytest.mark.parametrize("shape", [(2, 4, 16, 128), (2, 4, 150, 128),
                                   (2, 4, 151, 128), (2, 3, 24, 64)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_attention_matches_jax(shape, causal, dtype):
    q, k, v = _inputs(*shape)
    jq, jk, jv = (jnp.asarray(a, JD[dtype]) for a in (q, k, v))
    kernel = np.asarray(jax_kernel(jq, jk, jv, causal=causal, interpret=True)
                        .astype(jnp.float32))
    ref = np.asarray(jax_reference(jq, jk, jv, causal=causal).astype(jnp.float32))
    ours = attention.fused_causal_attention(*_torch((q, k, v), dtype), causal=causal)
    assert ours.dtype == getattr(torch, dtype) and ours.shape == shape
    ours = ours.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(ours, kernel, rtol=0, atol=2e-5)
        np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-5)
    else:
        ulp = 2.0 ** -7 * max(1.0, float(np.abs(kernel).max()))
        np.testing.assert_allclose(ours, kernel, rtol=0, atol=ulp)
        np.testing.assert_allclose(ours, ref, rtol=0, atol=3e-2)


def test_cpu_wrapper_routes_to_plain_version_and_checks_inputs():
    q, k, v = _torch(_inputs(2, 4, 20, 32), "float32")
    before = attention.fused_causal_attention.launches
    # strided views of one packed tensor, as a caller may pass them
    packed = torch.cat([q, k, v], dim=-1)
    views = packed[..., :32], packed[..., 32:64], packed[..., 64:]
    torch.testing.assert_close(attention.fused_causal_attention(*views),
                               attention.attention_reference(q, k, v),
                               rtol=0, atol=0)
    assert attention.fused_causal_attention.launches == before  # no kernel on CPU
    with pytest.raises(ValueError, match="share one"):
        attention.fused_causal_attention(q, k[:, :, :-1], v)
    with pytest.raises(ValueError, match="share one"):
        attention.fused_causal_attention(q[0], k[0], v[0])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        attention.fused_causal_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        attention.fused_causal_attention(q, k.bfloat16(), v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_output_ignores_later_keys(dtype):
    """Perturbing the last key and value leaves every earlier row unchanged."""
    q, k, v = _torch(_inputs(1, 2, 20, 128, seed=2), dtype)
    out1 = attention.fused_causal_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, -1] += 10.0
    v2[:, :, -1] += 10.0
    out2 = attention.fused_causal_attention(q, k2, v2)
    torch.testing.assert_close(out1[:, :, :-1], out2[:, :, :-1], rtol=0, atol=0)
    assert not torch.equal(out1[:, :, -1], out2[:, :, -1])
