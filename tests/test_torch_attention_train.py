"""regennet_torch.ops.attention's training attention against the JAX
package's fused_attention_btd_train.

The port's plain version (what the wrapper runs for CPU tensors) is fed
the bits the JAX kernel uses in interpret mode (`_interpret_bits`, a
threefry stream) and held against that kernel's forward and its
custom_vjp gradients (`jax.grad`), with torch autograd of the plain
formula on the port's side, and so is the backward kernel's own plain
version (`attention_btd_train_backward_reference`). The Philox bits the
CUDA kernels draw are held bit for bit against a numpy Philox4x32-10.

Tolerances: f32 forward 1e-5 and gradients 3e-5, x max(1, max|ref|)
(sums in other orders; the gradient chains three products). bf16 with
the bf16 softmax 2^-6 x max(1, max|ref|): values are rounded to bf16
(ulp 2^-7 relative) and torch autograd rounds the intermediate gradients
of the bf16 softmax to bf16 where the JAX kernel keeps them in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regennet_tpu.ops.pallas_attention import _interpret_bits
from regennet_tpu.ops.pallas_attention import fused_attention_btd_train as jax_train
from regennet_torch.ops import attention

B, D, H = 3, 64, 2
TOL = {"float32": (1e-5, 3e-5), "bfloat16": (2.0 ** -6, 2.0 ** -6)}
SEED = np.array([[11, -7], [3, 2 ** 30], [-5, 99]], np.int32)


def _inputs(T, seed=0):
    rng = np.random.default_rng(seed + T)
    return [rng.normal(size=(B, T, D)).astype(np.float32) for _ in range(4)]


def _atol(tol, ref):
    return tol * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("T", [24, 25])
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("mask", ["causal", "kv_len"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_jax_kernel_and_gradients(T, rate, mask, dtype):
    q, k, v, do = _inputs(T)
    causal = mask == "causal"
    kv_len = None if causal else T - 5
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = getattr(torch, dtype)
    seed_j = jnp.asarray(SEED)

    def jax_loss(q, k, v):
        out = jax_train(q, k, v, num_heads=H, dropout_rate=rate, seed=seed_j,
                        causal=causal, interpret=True, kv_len=kv_len)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(do)), out

    jq, jk, jv = (jnp.asarray(x, jd) for x in (q, k, v))
    (_, jout), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                           has_aux=True)(jq, jk, jv)
    bits = torch.tensor(np.asarray(_interpret_bits(seed_j, B, H, T)).astype(np.int64))

    tq, tk, tv = (torch.tensor(x).to(td).requires_grad_() for x in (q, k, v))
    out = attention.attention_btd_train_reference(
        tq, tk, tv, H, rate, torch.tensor(SEED), causal=causal, kv_len=kv_len,
        bits=bits)
    (out.float() * torch.tensor(do)).sum().backward()

    plain_grads = attention.attention_btd_train_backward_reference(
        tq.detach(), tk.detach(), tv.detach(), torch.tensor(do), H, rate,
        torch.tensor(SEED), causal=causal, kv_len=kv_len, bits=bits)

    fwd_tol, grad_tol = TOL[dtype]
    ref = np.asarray(jout.astype(jnp.float32))
    np.testing.assert_allclose(out.detach().float().numpy(), ref, rtol=0,
                               atol=_atol(fwd_tol, ref))
    for name, ours, plain, theirs in zip("qkv", (tq.grad, tk.grad, tv.grad),
                                         plain_grads, jgrads):
        theirs = np.asarray(theirs.astype(jnp.float32))
        np.testing.assert_allclose(ours.float().numpy(), theirs, rtol=0,
                                   atol=_atol(grad_tol, theirs), err_msg=f"d{name}")
        assert plain.dtype == td
        np.testing.assert_allclose(plain.float().numpy(), theirs, rtol=0,
                                   atol=_atol(grad_tol, theirs),
                                   err_msg=f"plain backward d{name}")


def _philox_numpy(counter, key):
    """Philox4x32-10 (Salmon et al. 2011) on numpy uint32 arrays."""
    c = [np.asarray(x, np.uint32) for x in counter]
    k0, k1 = (np.asarray(x, np.uint32) for x in key)
    m0, m1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
    with np.errstate(over="ignore"):
        for _ in range(10):
            p0 = c[0].astype(np.uint64) * m0
            p1 = c[2].astype(np.uint64) * m1
            hi0, lo0 = (p0 >> np.uint64(32)).astype(np.uint32), p0.astype(np.uint32)
            hi1, lo1 = (p1 >> np.uint64(32)).astype(np.uint32), p1.astype(np.uint32)
            c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
            k0 = k0 + np.uint32(0x9E3779B9)
            k1 = k1 + np.uint32(0xBB67AE85)
    return c


def test_philox_known_answers():
    # the known-answer vectors of the Random123 library
    cases = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for counter, key, want in cases:
        ours = attention.philox4x32_10(
            tuple(torch.tensor(x) for x in counter), tuple(torch.tensor(x) for x in key))
        assert [int(x) for x in ours] == list(want)
        assert [int(x) for x in _philox_numpy(counter, key)] == list(want)


@pytest.mark.parametrize("layout", ["per_row", "replicated"])
def test_dropout_bits_match_numpy_philox(layout):
    Bb, Hh, T = 3, 2, 9
    seed = SEED if layout == "per_row" else SEED[1]
    bits = attention.dropout_bits(torch.tensor(seed), Bb, Hh, T).numpy()
    assert bits.shape == (Bb, Hh, T, T) and bits.dtype == np.int64
    j = np.arange(T, dtype=np.uint32)[None, None, None, :]
    i = np.arange(T, dtype=np.uint32)[None, None, :, None]
    h = np.arange(Hh, dtype=np.uint32)[None, :, None, None]
    s = seed.astype(np.uint32)
    if layout == "per_row":
        k0, k1 = s[:, 0], s[:, 1]
    else:
        with np.errstate(over="ignore"):
            k0 = s[0] + np.arange(Bb, dtype=np.uint32) * np.uint32(0x9E3779B9)
        k1 = np.full(Bb, s[1], np.uint32)
    key = (k0[:, None, None, None], k1[:, None, None, None])
    want = _philox_numpy((j, i, h, np.zeros((), np.uint32)), key)[0]
    np.testing.assert_array_equal(bits, np.broadcast_to(want, bits.shape).astype(np.int64))
    # the rows draw different masks
    assert not np.array_equal(bits[0], bits[1])


def test_row_bits_do_not_depend_on_batch_or_other_rows():
    T = 7
    seed = torch.tensor(SEED)
    full = attention.dropout_bits(seed, 3, H, T)
    alone = attention.dropout_bits(seed[1:2], 1, H, T)
    torch.testing.assert_close(full[1:2], alone, rtol=0, atol=0)
    other = seed.clone()
    other[0] = torch.tensor([123, 456], dtype=torch.int32)
    changed = attention.dropout_bits(other, 3, H, T)
    torch.testing.assert_close(changed[1:], full[1:], rtol=0, atol=0)
    assert not torch.equal(changed[0], full[0])


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_fraction(rate):
    bits = attention.dropout_bits(torch.tensor(SEED), 3, 4, 64)
    kept = (bits >= attention.dropout_threshold(rate)).double().mean().item()
    assert abs(kept - (1 - rate)) < 0.01


def test_cpu_wrapper_routes_to_plain_version_with_its_gradients():
    T = 24
    q, k, v, do = (torch.tensor(a) for a in _inputs(T))
    packed = torch.cat([q, k, v], dim=-1).requires_grad_()
    qv, kv, vv = packed.split(D, dim=-1)  # strided views, as the model passes
    seed = torch.tensor(SEED)
    before = (attention.fused_attention_btd_train.launches,
              attention.fused_attention_btd_train.backward_launches)
    out = attention.fused_attention_btd_train(qv, kv, vv, H, 0.1, seed)
    (out * do).sum().backward()
    assert (attention.fused_attention_btd_train.launches,
            attention.fused_attention_btd_train.backward_launches) == before

    ref_in = torch.cat([q, k, v], dim=-1).requires_grad_()
    rq, rk, rv = ref_in.split(D, dim=-1)
    ref = attention.attention_btd_train_reference(rq, rk, rv, H, 0.1, seed)
    (ref * do).sum().backward()
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    torch.testing.assert_close(packed.grad, ref_in.grad, rtol=0, atol=0)
    # with the rate at 0 it is the inference attention
    plain = attention.fused_attention_btd_train(q, k, v, H, 0.0, seed)
    torch.testing.assert_close(
        plain, attention.attention_btd_reference(q, k, v, H), rtol=0, atol=0)

    with pytest.raises(ValueError, match="dropout_rate"):
        attention.fused_attention_btd_train(q, k, v, H, 1.0, seed)
    with pytest.raises(ValueError, match="seed must be int32"):
        attention.fused_attention_btd_train(q, k, v, H, 0.1, seed.long())
    with pytest.raises(ValueError, match="seed must be int32"):
        attention.fused_attention_btd_train(q, k, v, H, 0.1, seed[:2])
