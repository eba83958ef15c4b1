"""Multi-head attention (counterpart of
regennet_tpu/ops/pallas_attention.py::fused_attention_btd,
::fused_attention_btd_train and ::fused_causal_attention).

The wrappers launch CUDA kernels for tensors on the GPU and run their
plain versions for tensors on the CPU: `fused_attention_btd`,
`fused_causal_attention` and the forward of `fused_attention_btd_train`
the tensor-core forward of `csrc/attention_fwd.cu` (the last with its
dropout), the backward of `fused_attention_btd_train`
`csrc/attention_btd_train.cu`. The [B, T, D] ones compute what their TPU
kernels compute: heads are column slices of D, q is scaled by 1/sqrt(hd)
in the input dtype before QK, scores accumulate in f32 and are rounded to
the input dtype unless `softmax_f32`, masked scores are -1e30, and the
weights are cast to v's dtype before AV (f32 accumulation).

`fused_attention_btd` is the sampling attention; plain version
`attention_btd_reference`.

`fused_attention_btd_train` adds attention-weight dropout and a gradient:
on the GPU an autograd Function whose forward and backward are kernels;
on the CPU its plain version `attention_btd_train_reference`,
differentiated by autograd. `attention_btd_train_backward_reference` is
the backward kernel's plain version, with its rounding points. The GPU
backward is itself an autograd Function (`_AttentionTrainBackward`), so
a gradient taken with create_graph=True (a gradient penalty) can be
differentiated again: its VJP, `attention_btd_train_double_backward`, is
the closed-form second-order term in PyTorch ops. The
dropout bits are Philox4x32-10 keyed by each batch row's two int32 seed
words, with counter (key, query, head, 0): `dropout_bits` computes them
in plain torch, bit for bit as the kernels do.

`fused_causal_attention` is the legacy [B, H, T, hd] attention that no
model path reaches: unscaled q, the f32 score multiplied by 1/sqrt(hd) in
f32 after the dot, an f32 softmax, causal or not; plain version
`attention_reference`.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from regennet_torch.ops import kernels

NEG_FILL = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}
MAX_HEAD_DIM = 256


def _valid_mask(T: int, causal: bool, kv_len: Optional[int], device):
    """[T, T] bool: key j visible to query i (None = everything visible)."""
    valid = None
    if causal:
        i = torch.arange(T, device=device)
        valid = i[None, :] <= i[:, None]
    if kv_len is not None and kv_len < T:
        kmask = (torch.arange(T, device=device) < kv_len)[None, :].expand(T, T)
        valid = kmask if valid is None else valid & kmask
    return valid


def _heads(x, num_heads: int):
    """[B, T, D] -> [B, H, T, hd]."""
    B, T, D = x.shape
    return x.reshape(B, T, num_heads, D // num_heads).transpose(1, 2)


def _merge_heads(x):
    """[B, H, T, hd] -> [B, T, D]."""
    B, H, T, hd = x.shape
    return x.transpose(1, 2).reshape(B, T, H * hd)


def _softmax_weights(q, k, num_heads, causal, softmax_f32, kv_len):
    """The softmax weights P [B, H, T(query), T(key)] in the score dtype
    (q's dtype unless softmax_f32), at the kernels' rounding points."""
    T = q.shape[1]
    hd = q.shape[2] // num_heads
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=q.dtype, device=q.device)
    # bf16 x bf16 products are exact in f32, so f32 matmuls of the widened
    # inputs are the kernel's f32-accumulated products
    s = torch.matmul(_heads(q * scale, num_heads).float(),
                     _heads(k, num_heads).float().transpose(-1, -2))
    s = s if softmax_f32 else s.to(q.dtype)
    valid = _valid_mask(T, causal, kv_len, q.device)
    if valid is not None:
        s = s.masked_fill(~valid, NEG_FILL)
    # the max only shifts the exponent: no gradient flows through it
    p = torch.exp(s - s.amax(dim=-1, keepdim=True).detach())
    return p / p.sum(dim=-1, keepdim=True)


def attention_btd_reference(q, k, v, num_heads: int, causal: bool = True,
                            softmax_f32: bool = False,
                            kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: [B, T, D] x3 -> [B, T, D]."""
    w = _softmax_weights(q, k, num_heads, causal, softmax_f32, kv_len).to(v.dtype)
    out = torch.matmul(w.float(), _heads(v, num_heads).float()).to(q.dtype)
    return _merge_heads(out)


def _check_tensors(q, k, v, layout: str):
    """Shape, dtype and device checks of every wrapper; `layout` names the
    shape, "[B, T, D]" or "[B, H, T, hd]"."""
    if not (q.shape == k.shape == v.shape) or q.dim() != layout.count(",") + 1:
        raise ValueError(
            f"q, k, v must share one {layout} shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"q, k, v must all be float32 or bfloat16, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")


def _check(q, k, v, num_heads, kv_len):
    _check_tensors(q, k, v, "[B, T, D]")
    D = q.shape[2]
    if num_heads < 1 or D % num_heads:
        raise ValueError(f"D={D} does not split into {num_heads} heads")
    if kv_len is not None and kv_len < 1:
        raise ValueError(f"kv_len must be >= 1, got {kv_len}")


def kernel_layout(shape, strides, dtype: torch.dtype, addresses):
    """How the forward kernel loads q, k and v: (copy width in bytes,
    padded head dim). shape is the [B, H, T, hd] of the three views,
    strides one 4-tuple (in elements) each, addresses their byte addresses
    (data_ptr). The width is the widest of 16, 8 and 4 bytes (2 for bf16
    views that take no wider copy) that divides every batch, head and row
    stride, the row of hd elements and every address, in bytes; the head
    dim is zero-padded to a multiple of 16. Raises ValueError for what no
    kernel takes."""
    B, H, T, hd = shape
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} exceeds the kernel's {MAX_HEAD_DIM}")
    if B > 65535 or H > 65535 or B * H * T * hd == 0:
        raise ValueError(f"shape {tuple(shape)} is outside the kernel's grid")
    for name, st in zip("qkv", strides):
        if st[3] != 1:
            raise ValueError(f"{name} must be contiguous in its last dimension")
    item = _ITEMSIZE[dtype]
    spans = [hd * item, *addresses] + [x * item for st in strides for x in st[:3]]
    width = next(w for w in (16, 8, 4, item) if all(x % w == 0 for x in spans))
    return width, -(-hd // 16) * 16


def _check_device(q):
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")


def _head_strides(strides, hd: int):
    """[B, H, T, hd] strides of [B, T, D] tensors with these strides: head h
    is columns [h hd, (h + 1) hd)."""
    return [(st[0], hd, st[1], st[2]) for st in strides]


def _check_kernel_inputs(q, k, v, B, H, hd):
    """What the training kernels take beyond the shape checks: device, head
    dim, grid, layout."""
    _check_device(q)
    kernel_layout((B, H, q.shape[1], hd), _head_strides([x.stride() for x in (q, k, v)], hd),
                  q.dtype, [0, 0, 0])


class ForwardArgs(NamedTuple):
    """The arguments of attention_fwd.cu's `attention_forward` beside the
    pointers (q, k, v, out, seed) and the stream."""
    dtype: int  # 0 float32, 1 bfloat16
    batch: int
    seq: int
    heads: int
    hd: int
    hdp: int  # hd padded to a multiple of 16
    strides: tuple  # (batch, head, row) strides of q, k, v, out in elements
    scale_q: float
    score_scale: float
    causal: int
    kv_len: int  # 0: no key-length mask
    softmax_f32: int
    copy_bytes: int
    seed_per_row: int  # 1: seed is [B, 2]; 0: [2]
    threshold: int  # drop iff bits < threshold; 0 drops nothing
    keep_w: float  # kept weights' scale, 1/(1-rate) in the dtype


def forward_args(shape, strides, dtype: torch.dtype, addresses, scale_q: float,
                 score_scale: float, causal: bool, kv_len: Optional[int],
                 softmax_f32: bool, seed_per_row: int = 0, threshold: int = 0,
                 keep_w: float = 1.0) -> ForwardArgs:
    """attention_forward's arguments for q, k, v, out read as [B, H, T, hd]
    `shape` with `strides` (one 4-tuple in elements each), the copy width
    from kernel_layout on q, k and v's byte `addresses`."""
    B, H, T, hd = shape
    width, hdp = kernel_layout(shape, strides[:3], dtype, addresses)
    return ForwardArgs(_DTYPE_CODE[dtype], B, T, H, hd, hdp,
                       tuple(x for st in strides for x in st[:3]), scale_q, score_scale,
                       int(causal), kv_len or 0, int(softmax_f32), width, seed_per_row,
                       threshold, keep_w)


def _launch_attention(q, k, v, out, args: ForwardArgs, what, seed=None):
    """The forward kernel of attention_fwd.cu on q, k, v, out (and the
    dropout seed) with `args`."""
    lib = _fwd_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.attention_forward(
            args.dtype, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            args.batch, args.seq, args.heads, args.hd, args.hdp, *args.strides,
            args.scale_q, args.score_scale, args.causal, args.kv_len, args.softmax_f32,
            args.copy_bytes, None if seed is None else seed.data_ptr(), args.seed_per_row,
            args.threshold, args.keep_w, stream,
        )
    _raise_on_error(lib.attention_forward_error_string, rc, what, q, args.heads)


@functools.lru_cache(maxsize=None)
def _scale_in(dtype: torch.dtype, hd: int) -> float:
    """1/sqrt(hd) rounded to dtype."""
    return float(torch.tensor(1.0 / math.sqrt(hd), dtype=dtype))


def fused_attention_btd(q, k, v, num_heads: int, causal: bool = True,
                        softmax_f32: bool = False,
                        kv_len: Optional[int] = None) -> torch.Tensor:
    """Multi-head self-attention on [B, T, D] inputs, returning a new
    contiguous [B, T, D] tensor. kv_len masks key columns >= kv_len.

    On the GPU the kernel runs on the current stream, or this raises; q,
    k and v may be strided views whose last dimension is contiguous.
    `fused_attention_btd.launches` counts kernel launches, and
    `.launches_by_tokens` the same by T."""
    _check(q, k, v, num_heads, kv_len)
    if q.device.type == "cpu":
        return attention_btd_reference(q, k, v, num_heads, causal,
                                       softmax_f32, kv_len)
    _check_device(q)
    B, T, D = q.shape
    hd = D // num_heads
    out = torch.empty((B, T, D), dtype=q.dtype, device=q.device)
    args = forward_args((B, num_heads, T, hd),
                        _head_strides([x.stride() for x in (q, k, v, out)], hd), q.dtype,
                        [x.data_ptr() for x in (q, k, v)], _scale_in(q.dtype, hd), 1.0,
                        causal, kv_len, softmax_f32)
    _launch_attention(q, k, v, out, args, "fused_attention_btd")
    fused_attention_btd.launches += 1
    _count_tokens(fused_attention_btd.launches_by_tokens, T)
    return out


def _count_tokens(by_tokens: dict, T: int) -> None:
    by_tokens[T] = by_tokens.get(T, 0) + 1


fused_attention_btd.launches = 0
fused_attention_btd.launches_by_tokens = {}


# ---------------------------------------------------------------------------
# Training attention with dropout
# ---------------------------------------------------------------------------

PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of a * m for int64 tensors a in [0, 2^32) and a
    32-bit constant m; m is split into 16-bit halves so nothing overflows."""
    p_lo = a * (m & 0xFFFF)  # < 2^48
    p_hi = a * (m >> 16)     # < 2^48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & _U32


def philox4x32_10(counter, key):
    """Philox4x32-10 on int64 tensors holding uint32 words: counter is four
    broadcastable tensors, key two. Returns the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W0) & _U32
        k1 = (k1 + PHILOX_W1) & _U32
    return c0, c1, c2, c3


def _seed_words(seed: torch.Tensor, B: int):
    """Philox key words [B, 1, 1, 1] (int64) of each batch row: the row's
    two seed words for a [B, 2] seed; for a [2] seed, the row index times
    0x9E3779B9 is added to the first word so that rows differ."""
    s = seed.to(torch.int64) & _U32
    if s.shape == (2,):
        rows = torch.arange(B, dtype=torch.int64, device=seed.device)
        k0 = (s[0] + rows * PHILOX_W0) & _U32
        k1 = s[1].expand(B)
    else:
        k0, k1 = s[:, 0], s[:, 1]
    return k0.view(B, 1, 1, 1), k1.reshape(B, 1, 1, 1)


def dropout_bits(seed: torch.Tensor, B: int, H: int, T: int) -> torch.Tensor:
    """The 32 random bits of every attention weight, [B, H, T(query),
    T(key)] as int64 values in [0, 2^32): the first Philox4x32-10 word for
    counter (key, query, head, 0) under the row's seed key."""
    _check_seed(seed, B)
    dev = seed.device
    j = torch.arange(T, dtype=torch.int64, device=dev).view(1, 1, 1, T)
    i = torch.arange(T, dtype=torch.int64, device=dev).view(1, 1, T, 1)
    h = torch.arange(H, dtype=torch.int64, device=dev).view(1, H, 1, 1)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    words = philox4x32_10((j, i, h, zero), _seed_words(seed, B))
    return words[0].expand(B, H, T, T)


def dropout_threshold(rate: float) -> int:
    """A weight is dropped iff its bits are below this (uint32 compare)."""
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def _check_seed(seed, B):
    if seed.dtype != torch.int32 or seed.shape not in ((2,), (B, 2)):
        raise ValueError(
            f"seed must be int32 of shape [2] or [{B}, 2], got "
            f"{seed.dtype} {tuple(seed.shape)}"
        )


def attention_btd_train_reference(q, k, v, num_heads: int, dropout_rate: float,
                                  seed: torch.Tensor, causal: bool = True,
                                  softmax_f32: bool = False,
                                  kv_len: Optional[int] = None,
                                  bits: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """Plain PyTorch version of the training kernel, differentiable by
    autograd. bits ([B, H, T, T] values in [0, 2^32)) overrides the
    Philox bits of `seed`, so tests can feed another stream."""
    w = _softmax_weights(q, k, num_heads, causal, softmax_f32, kv_len).to(v.dtype)
    if dropout_rate > 0.0:
        w = _drop(w, _keep_mask(q, num_heads, dropout_rate, seed, bits),
                  dropout_rate)
    out = torch.matmul(w.float(), _heads(v, num_heads).float()).to(q.dtype)
    return _merge_heads(out)


def _keep_mask(q, num_heads, rate, seed, bits):
    B, T, _ = q.shape
    if bits is None:
        bits = dropout_bits(seed, B, num_heads, T)
    return bits.to(q.device) >= dropout_threshold(rate)


def _drop(x, keep, rate):
    """Dropped entries 0, kept ones times 1/(1-rate) taken in x's dtype."""
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=x.dtype, device=x.device)
    return torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype, device=x.device))


def attention_btd_train_backward_reference(q, k, v, dout, num_heads: int,
                                           dropout_rate: float, seed: torch.Tensor,
                                           causal: bool = True,
                                           softmax_f32: bool = False,
                                           kv_len: Optional[int] = None,
                                           bits: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the backward kernel: (dq, dk, dv) of the
    training attention at output gradient dout, with the rounding points
    of the TPU kernel's backward: dO in q's dtype; dV = (P.M)^T dO;
    dP = (dO V^T).M with the keep-scale in f32; dS = P (dP - rowsum(dP P))
    in f32 on the undropped P, rounded to q's dtype once; dQ = scale dS K
    and dK = scale dS^T Q with the unscaled Q and the f32 scale. (Autograd
    of attention_btd_train_reference rounds the softmax VJP to the score
    dtype at more points.)"""
    H = num_heads
    hd = q.shape[2] // H
    with torch.no_grad():
        p = _softmax_weights(q, k, H, causal, softmax_f32, kv_len)
        wd = p.to(v.dtype)
        do = _heads(dout.to(q.dtype), H).float()
        dp = torch.matmul(do, _heads(v, H).float().transpose(-1, -2))
        if dropout_rate > 0.0:
            keep = _keep_mask(q, H, dropout_rate, seed, bits)
            wd, dp = _drop(wd, keep, dropout_rate), _drop(dp, keep, dropout_rate)
        pf = p.float()
        ds = (pf * (dp - (dp * pf).sum(dim=-1, keepdim=True))).to(q.dtype).float()
        scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32, device=q.device)
        dq = torch.matmul(ds, _heads(k, H).float()) * scale
        dk = torch.matmul(ds.transpose(-1, -2), _heads(q, H).float()) * scale
        dv = torch.matmul(wd.float().transpose(-1, -2), do)
    return tuple(_merge_heads(x).to(q.dtype) for x in (dq, dk, dv))


def fused_attention_btd_train(q, k, v, num_heads: int, dropout_rate: float,
                              seed: torch.Tensor, causal: bool = True,
                              softmax_f32: bool = False,
                              kv_len: Optional[int] = None) -> torch.Tensor:
    """Differentiable multi-head self-attention on [B, T, D] inputs with
    attention-weight dropout at `dropout_rate` (0 <= rate < 1).

    seed: int32 [B, 2] (per-row seeds, as the model draws them) or [2].
    On the GPU the forward (attention_fwd.cu, with dropout at rate > 0) and
    the backward are CUDA kernels on the current stream (or this raises);
    the backward regenerates the mask from the seed and saves nothing [B,
    H, T, T]. On the CPU the plain version runs under autograd.
    `fused_attention_btd_train.launches` and `.backward_launches` count
    kernel launches, and `.launches_by_tokens` and
    `.backward_launches_by_tokens` the same by T. The GPU backward is itself
    differentiable (a gradient penalty's `create_graph=True`): its VJP runs
    in PyTorch ops, counted by `.double_backward_launches`."""
    _check(q, k, v, num_heads, kv_len)
    _check_seed(seed, q.shape[0])
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must lie in [0, 1), got {dropout_rate}")
    if seed.device != q.device:
        raise ValueError("seed must lie on the device of q, k, v")
    if q.device.type == "cpu":
        return attention_btd_train_reference(
            q, k, v, num_heads, dropout_rate, seed, causal, softmax_f32, kv_len)
    _check_kernel_inputs(q, k, v, q.shape[0], num_heads, q.shape[2] // num_heads)
    cfg = _TrainConfig(num_heads, float(dropout_rate), bool(causal),
                       bool(softmax_f32), 0 if kv_len is None else int(kv_len))
    return _AttentionTrain.apply(q, k, v, seed.contiguous(), cfg)


fused_attention_btd_train.launches = 0
fused_attention_btd_train.backward_launches = 0
fused_attention_btd_train.launches_by_tokens = {}
fused_attention_btd_train.backward_launches_by_tokens = {}
fused_attention_btd_train.double_backward_launches = 0


class _TrainConfig(NamedTuple):
    num_heads: int
    rate: float
    causal: bool
    softmax_f32: bool
    kv_len: int  # 0: no key-length mask


def _train_scalars(cfg: _TrainConfig, dtype: torch.dtype, hd: int):
    """(threshold, keep scale in the dtype, keep scale in f32, 1/sqrt(hd)
    in the dtype, 1/sqrt(hd) in f32) as the kernels take them."""
    keep = 1.0 / (1.0 - cfg.rate)
    scale = 1.0 / math.sqrt(hd)
    return (
        dropout_threshold(cfg.rate) if cfg.rate > 0.0 else 0,
        float(torch.tensor(keep, dtype=dtype)), float(np.float32(keep)),
        _scale_in(dtype, hd), float(np.float32(scale)),
    )


def _strides(q, k, v):
    return (q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1))


def train_forward_args(shape, strides, dtype: torch.dtype, addresses, seed_shape,
                       cfg: _TrainConfig) -> ForwardArgs:
    """attention_forward's arguments for the training forward of [B, T, D]
    `shape` q, k, v with `strides` (a 3-tuple each) at byte `addresses`,
    into a contiguous [B, T, D] output: B1's head strides and copy width,
    and the dropout of `cfg` with a seed of `seed_shape`."""
    B, T, D = shape
    hd = D // cfg.num_heads
    threshold, keep_w, _, scale_q, _ = _train_scalars(cfg, dtype, hd)
    views = _head_strides([*strides, (T * D, D, 1)], hd)
    return forward_args((B, cfg.num_heads, T, hd), views, dtype, addresses, scale_q, 1.0,
                        cfg.causal, cfg.kv_len, cfg.softmax_f32,
                        seed_per_row=int(len(seed_shape) == 2), threshold=threshold,
                        keep_w=keep_w)


class _AttentionTrain(torch.autograd.Function):
    """The training kernels under autograd: saves (q, k, v, seed) only."""

    @staticmethod
    def forward(ctx, q, k, v, seed, cfg):
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        args = train_forward_args(q.shape, [x.stride() for x in (q, k, v)], q.dtype,
                                  [x.data_ptr() for x in (q, k, v)], seed.shape, cfg)
        _launch_attention(q, k, v, out, args, "attention_btd_train forward", seed)
        fused_attention_btd_train.launches += 1
        _count_tokens(fused_attention_btd_train.launches_by_tokens, q.shape[1])
        ctx.save_for_backward(q, k, v, seed)
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seed = ctx.saved_tensors
        dq, dk, dv = _AttentionTrainBackward.apply(q, k, v, dout.to(q.dtype).contiguous(),
                                                   seed, ctx.cfg)
        return dq, dk, dv, None, None


class _AttentionTrainBackward(torch.autograd.Function):
    """The training attention's backward as a function of (q, k, v, dout):
    its forward is the backward kernel on the GPU (the plain backward
    `attention_btd_train_backward_reference` on the CPU), its backward the
    second-order term `attention_btd_train_double_backward` in PyTorch ops.
    Autograd records it only when the backward itself is differentiated
    (`create_graph=True`, as a gradient penalty does); a first-order
    backward runs the kernel alone, as before."""

    @staticmethod
    def forward(ctx, q, k, v, dout, seed, cfg):
        if q.device.type == "cpu":
            grads = attention_btd_train_backward_reference(
                q, k, v, dout, cfg.num_heads, cfg.rate, seed, cfg.causal, cfg.softmax_f32,
                cfg.kv_len or None)
        else:
            grads = _launch_train_backward(q, k, v, dout, seed, cfg)
        ctx.save_for_backward(q, k, v, dout, seed)
        ctx.cfg = cfg
        return grads

    @staticmethod
    def backward(ctx, gdq, gdk, gdv):
        q, k, v, dout, seed = ctx.saved_tensors
        cfg = ctx.cfg
        grads = attention_btd_train_double_backward(
            q, k, v, dout, gdq, gdk, gdv, cfg.num_heads, cfg.rate, seed, cfg.causal,
            cfg.softmax_f32, cfg.kv_len or None)
        fused_attention_btd_train.double_backward_launches += 1
        return (*grads, None, None)


def _launch_train_backward(q, k, v, dout, seed, cfg: _TrainConfig):
    """(dq, dk, dv) from the backward kernel of attention_btd_train.cu."""
    B, T, D = q.shape
    hd = D // cfg.num_heads
    threshold, keep_w, keep_f32, scale_q, scale_f32 = _train_scalars(cfg, q.dtype, hd)
    dq, dk, dv = (torch.empty((B, T, D), dtype=q.dtype, device=q.device) for _ in range(3))
    stats = torch.empty((3, B, cfg.num_heads, T), dtype=torch.float32, device=q.device)
    lib = _train_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.attention_train_backward(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            stats.data_ptr(), seed.data_ptr(), int(seed.dim() == 2),
            threshold, keep_w, keep_f32, B, T, cfg.num_heads, hd,
            *_strides(q, k, v), scale_q, scale_f32, int(cfg.causal),
            cfg.kv_len, int(cfg.softmax_f32), stream,
        )
    _raise_on_error(lib.attention_train_error_string, rc,
                    "attention_btd_train backward", q, cfg.num_heads)
    fused_attention_btd_train.backward_launches += 1
    _count_tokens(fused_attention_btd_train.backward_launches_by_tokens, T)
    return dq, dk, dv


def attention_btd_train_double_backward(q, k, v, dout, gdq, gdk, gdv, num_heads: int,
                                        dropout_rate: float, seed: torch.Tensor,
                                        causal: bool = True, softmax_f32: bool = False,
                                        kv_len: Optional[int] = None):
    """The vector-Jacobian product of the training attention's backward
    (dq, dk, dv) = f(q, k, v, dout) at cotangents (gdq, gdk, gdv): returns
    (gq, gk, gv, gdout), the second-order term, in closed form and f32.

    Per head, with S = s Q K^T (s = 1/sqrt(hd)), P = softmax(S), the keep
    factor M (the mask times 1/(1-rate)), W = P.M, dP = (dO V^T).M,
    r = rowsum(dP.P) and dS = P.(dP - r), the backward is dV = W^T dO,
    dQ = s dS K, dK = s dS^T Q. Its VJP:
      gdS = s (gdQ K^T + Q gdK^T),  t = rowsum(gdS.P)
      gdP = P.(gdS - t),            gdW = gdP.M
      gP  = gdS.(dP - r) - t dP + (dO gdV^T).M
      gS  = P.(gP - rowsum(gP.P))
      gQ  = s (gS K + dS gdK),      gK = s (gS^T Q + dS^T gdQ)
      gV  = gdW^T dO,               gdO = W gdV + gdW V
    P and M are recomputed from q, k and the seed."""
    H = num_heads
    hd = q.shape[2] // H
    with torch.no_grad():
        p = _softmax_weights(q, k, H, causal, softmax_f32, kv_len).float()
        m = None
        if dropout_rate > 0.0:
            m = _drop(torch.ones_like(p), _keep_mask(q, H, dropout_rate, seed, None),
                      dropout_rate)

        def heads(x):
            return _heads(x, H).float()

        qh, kh, vh, do = heads(q), heads(k), heads(v), heads(dout)
        gq_in, gk_in, gv_in = heads(gdq), heads(gdk), heads(gdv)
        s = 1.0 / math.sqrt(hd)
        dp = torch.matmul(do, vh.transpose(-1, -2))
        w = p if m is None else p * m
        if m is not None:
            dp = dp * m
        r = (dp * p).sum(dim=-1, keepdim=True)
        ds = p * (dp - r)
        gds = s * (torch.matmul(gq_in, kh.transpose(-1, -2))
                   + torch.matmul(qh, gk_in.transpose(-1, -2)))
        t = (gds * p).sum(dim=-1, keepdim=True)
        gdw = p * (gds - t)
        gw = torch.matmul(do, gv_in.transpose(-1, -2))
        if m is not None:
            gdw, gw = gdw * m, gw * m
        gp = gds * (dp - r) - t * dp + gw
        gs = p * (gp - (gp * p).sum(dim=-1, keepdim=True))
        gq = s * (torch.matmul(gs, kh) + torch.matmul(ds, gk_in))
        gk = s * (torch.matmul(gs.transpose(-1, -2), qh)
                  + torch.matmul(ds.transpose(-1, -2), gq_in))
        gv = torch.matmul(gdw.transpose(-1, -2), do)
        gdo = torch.matmul(w, gv_in) + torch.matmul(gdw, vh)
    return (*(_merge_heads(x).to(q.dtype) for x in (gq, gk, gv)),
            _merge_heads(gdo).to(dout.dtype))


def _raise_on_error(error_string, rc, what, q, num_heads):
    if rc != 0:
        raise RuntimeError(
            f"{what} launch failed for {tuple(q.shape)} heads={num_heads} "
            f"{q.dtype}: {error_string(rc).decode()}"
        )


_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FLT, _UINT = ctypes.c_float, ctypes.c_uint

# the extern "C" functions of each kernel source: {name: (restype, argtypes)}
PROTOTYPES = {
    "attention_fwd": {
        "attention_forward": (_INT, [
            _INT, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT, *[_LL] * 12,
            _FLT, _FLT, _INT, _INT, _INT, _INT, _PTR, _INT, _UINT, _FLT, _PTR]),
        "attention_forward_error_string": (ctypes.c_char_p, [_INT]),
    },
    "attention_btd_train": {
        "attention_train_backward": (_INT, [
            _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _UINT, _FLT,
            _FLT, _INT, _INT, _INT, _INT, *[_LL] * 6, _FLT, _FLT, _INT, _INT, _INT, _PTR]),
        "attention_train_error_string": (ctypes.c_char_p, [_INT]),
    },
}


@functools.lru_cache(maxsize=None)
def _fwd_library() -> ctypes.CDLL:
    return kernels.load_library("attention_fwd", PROTOTYPES["attention_fwd"])


@functools.lru_cache(maxsize=None)
def _train_library() -> ctypes.CDLL:
    return kernels.load_library("attention_btd_train", PROTOTYPES["attention_btd_train"])


# ---------------------------------------------------------------------------
# Legacy [B, H, T, hd] attention
# ---------------------------------------------------------------------------


def _score_scale(hd: int) -> float:
    """1/sqrt(hd) rounded to f32, as the TPU kernel multiplies its f32 scores."""
    return float(np.float32(1.0 / (hd ** 0.5)))


def attention_reference(q, k, v, causal: bool = True) -> torch.Tensor:
    """Plain PyTorch version of fused_causal_attention: q, k, v [B, H, T,
    hd] -> [B, H, T, hd] in q's dtype, at the TPU kernel's rounding points
    (f32 scores from the unscaled q, times 1/sqrt(hd) in f32, f32 softmax,
    weights cast to v's dtype, f32 AV accumulation)."""
    T, hd = q.shape[-2], q.shape[-1]
    # bf16 x bf16 products are exact in f32
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * _score_scale(hd)
    valid = _valid_mask(T, causal, None, q.device)
    if valid is not None:
        s = s.masked_fill(~valid, NEG_FILL)
    w = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(w.float(), v.float()).to(q.dtype)


def fused_causal_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """Multi-head attention on [B, H, T, hd] inputs, returning a new
    contiguous [B, H, T, hd] tensor in q's dtype (float32 or bfloat16).

    On the GPU the kernel runs on the current stream, or this raises; q, k
    and v may be strided views whose last dimension is contiguous, with
    hd up to MAX_HEAD_DIM. `fused_causal_attention.launches` counts kernel
    launches."""
    _check_tensors(q, k, v, "[B, H, T, hd]")
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal)
    _check_device(q)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    # q unscaled, the f32 score scaled after the dot, an f32 softmax
    args = forward_args(q.shape, [x.stride() for x in (q, k, v, out)], q.dtype,
                        [x.data_ptr() for x in (q, k, v)], 1.0, _score_scale(q.shape[3]),
                        causal, None, True)
    _launch_attention(q, k, v, out, args, "fused_causal_attention")
    fused_causal_attention.launches += 1
    return out


fused_causal_attention.launches = 0
