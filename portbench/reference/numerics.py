"""Plain numerics of the reference: matrix products at a stated precision,
the cosine DDPM schedule, the sinusoidal tables and the attention dropout
bits. Nothing here imports the program.

Precision "float32" multiplies in float32 with TF32 off. Precision "tf32"
rounds both operands of every product to TF32 (10 mantissa bits, to
nearest) and accumulates in float32, as a TF32 tensor core does, on any
device: it is the control, the step below float32 that would tempt a
later change.

The Philox bits are a frozen copy of `regennet_torch/ops/attention.py`
(`philox4x32_10`, `dropout_bits`, `dropout_threshold`) at commit
b14d20cb6bbaa9fb4189ca13e12634674eb6d23e: the published counter-based
generator, keyed by each batch row's two int32 seed words, with counter
(key, query, head, 0).
"""

from __future__ import annotations

import math

import numpy as np
import torch

PRECISIONS = ("float32", "tf32")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties to even), kept in float32."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b with TF32 operands, forward and backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(round_tf32(a), round_tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        ga = torch.matmul(g, round_tf32(b).transpose(-1, -2))
        gb = torch.matmul(round_tf32(a).transpose(-1, -2), g)
        # broadcast batch dims back to the operands' shapes
        while ga.dim() > a.dim():
            ga = ga.sum(0)
        while gb.dim() > b.dim():
            gb = gb.sum(0)
        for d in range(a.dim() - 2):
            if a.shape[d] == 1 and ga.shape[d] != 1:
                ga = ga.sum(d, keepdim=True)
        for d in range(b.dim() - 2):
            if b.shape[d] == 1 and gb.shape[d] != 1:
                gb = gb.sum(d, keepdim=True)
        return ga, gb


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "float32":
        return torch.matmul(a, b)
    if precision == "tf32":
        return _TF32MatMul.apply(a, b)
    raise ValueError(f"precision {precision!r}: choose one of {PRECISIONS}")


def linear(x, weight, bias, precision: str):
    """x @ weight^T + bias, weight [out, in]."""
    out = matmul(x, weight.t(), precision)
    return out if bias is None else out + bias


def pinned_f32():
    """TF32 off in cuBLAS and cuDNN, so that float32 means float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# the cosine DDPM schedule (Nichol and Dhariwal), float64 on the host
# ---------------------------------------------------------------------------

def cosine_schedule(steps: int, device) -> dict:
    """The arrays the sampler and the loss read, float32 on `device`."""
    def alpha_bar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    betas = np.array([min(1 - alpha_bar((i + 1) / steps) / alpha_bar(i / steps), 0.999)
                      for i in range(steps)], dtype=np.float64)
    ab = np.cumprod(1.0 - betas)
    ab_prev = np.append(1.0, ab[:-1])
    post_var = betas * (1.0 - ab_prev) / (1.0 - ab)
    post_log_var = np.log(np.append(post_var[min(1, steps - 1)], post_var[1:]))
    arrays = {
        "sqrt_ab": np.sqrt(ab),
        "sqrt_one_minus_ab": np.sqrt(1.0 - ab),
        "post_coef1": betas * np.sqrt(ab_prev) / (1.0 - ab),
        "post_coef2": (1.0 - ab_prev) * np.sqrt(1.0 - betas) / (1.0 - ab),
        "post_log_var": post_log_var,
    }
    return {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in arrays.items()}


def sinusoidal(max_len: int, dim: int) -> torch.Tensor:
    """The sin/cos table [max_len, dim], computed in float64, kept in float32."""
    pos = np.arange(max_len)[:, None].astype(np.float64)
    div = np.exp(np.arange(0, dim, 2).astype(np.float64) * (-np.log(10000.0) / dim))
    pe = np.zeros((max_len, dim), dtype=np.float64)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.tensor(pe.astype(np.float32))


# ---------------------------------------------------------------------------
# attention dropout bits: Philox4x32-10
# ---------------------------------------------------------------------------

PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def _mulhilo(a: torch.Tensor, m: int):
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & _U32


def philox4x32_10(counter, key):
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W0) & _U32
        k1 = (k1 + PHILOX_W1) & _U32
    return c0, c1, c2, c3


def keep_mask(seeds: torch.Tensor, heads: int, T: int, rate: float) -> torch.Tensor:
    """[B, H, T(query), T(key)] bool: the attention weights kept at `rate`,
    from the per-row int32 seeds [B, 2]."""
    B = seeds.shape[0]
    dev = seeds.device
    s = seeds.to(torch.int64) & _U32
    key = (s[:, 0].view(B, 1, 1, 1), s[:, 1].view(B, 1, 1, 1))
    j = torch.arange(T, dtype=torch.int64, device=dev).view(1, 1, 1, T)
    i = torch.arange(T, dtype=torch.int64, device=dev).view(1, 1, T, 1)
    h = torch.arange(heads, dtype=torch.int64, device=dev).view(1, heads, 1, 1)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    bits = philox4x32_10((j, i, h, zero), key)[0]
    threshold = min(int(rate * 2 ** 32), 2 ** 32 - 1)
    return (bits >= threshold).expand(B, heads, T, T)
