"""Multi-head self-attention on [B, T, D] (counterpart of
regennet_tpu/ops/pallas_attention.py::fused_attention_btd).

`fused_attention_btd` launches the CUDA kernel `csrc/attention_btd.cu`
for tensors on the GPU and runs its plain version,
`attention_btd_reference`, for tensors on the CPU. Both compute what the
TPU kernel computes: heads are column slices of D, q is scaled by
1/sqrt(hd) in the input dtype before QK, scores accumulate in f32 and
are rounded to the input dtype unless `softmax_f32`, masked scores are
-1e30, and the weights are cast to v's dtype before AV (f32
accumulation).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from regennet_torch.ops import kernels

NEG_FILL = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
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


def attention_btd_reference(q, k, v, num_heads: int, causal: bool = True,
                            softmax_f32: bool = False,
                            kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: [B, T, D] x3 -> [B, T, D]."""
    B, T, D = q.shape
    hd = D // num_heads
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=q.dtype, device=q.device)

    def heads(x):
        return x.reshape(B, T, num_heads, hd).transpose(1, 2)

    # bf16 x bf16 products are exact in f32, so f32 matmuls of the widened
    # inputs are the kernel's f32-accumulated products
    s = torch.matmul(heads(q * scale).float(), heads(k).float().transpose(-1, -2))
    s = s if softmax_f32 else s.to(q.dtype)
    valid = _valid_mask(T, causal, kv_len, q.device)
    if valid is not None:
        s = s.masked_fill(~valid, NEG_FILL)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = (p / p.sum(dim=-1, keepdim=True)).to(v.dtype)
    out = torch.matmul(w.float(), heads(v).float()).to(q.dtype)
    return out.transpose(1, 2).reshape(B, T, D)


def _check(q, k, v, num_heads, kv_len):
    if not (q.shape == k.shape == v.shape) or q.dim() != 3:
        raise ValueError(
            f"q, k, v must share one [B, T, D] shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"q, k, v must all be float32 or bfloat16, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    D = q.shape[2]
    if num_heads < 1 or D % num_heads:
        raise ValueError(f"D={D} does not split into {num_heads} heads")
    if kv_len is not None and kv_len < 1:
        raise ValueError(f"kv_len must be >= 1, got {kv_len}")


def fused_attention_btd(q, k, v, num_heads: int, causal: bool = True,
                        softmax_f32: bool = False,
                        kv_len: Optional[int] = None) -> torch.Tensor:
    """Multi-head self-attention on [B, T, D] inputs, returning a new
    contiguous [B, T, D] tensor. kv_len masks key columns >= kv_len.

    On the GPU the kernel runs on the current stream, or this raises; q,
    k and v may be strided views whose last dimension is contiguous.
    `fused_attention_btd.launches` counts kernel launches."""
    _check(q, k, v, num_heads, kv_len)
    if q.device.type == "cpu":
        return attention_btd_reference(q, k, v, num_heads, causal,
                                       softmax_f32, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    B, T, D = q.shape
    hd = D // num_heads
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} exceeds the kernel's {MAX_HEAD_DIM}")
    if B > 65535 or num_heads > 65535:
        raise ValueError(f"batch {B} or heads {num_heads} exceed the grid limit")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(2) != 1:
            raise ValueError(f"{name} must be contiguous in its last dimension")
    lib = _library()
    out = torch.empty((B, T, D), dtype=q.dtype, device=q.device)
    scale = float(torch.tensor(1.0 / math.sqrt(hd), dtype=q.dtype))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.attention_btd_launch(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, T, num_heads, hd,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), scale, int(causal),
            0 if kv_len is None else int(kv_len), int(softmax_f32), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"attention_btd launch failed for B={B} T={T} D={D} "
            f"heads={num_heads} {q.dtype}: "
            f"{lib.attention_btd_error_string(rc).decode()}"
        )
    fused_attention_btd.launches += 1
    return out


fused_attention_btd.launches = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = kernels.load_library("attention_btd")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.attention_btd_launch.argtypes = [
        i32, ptr, ptr, ptr, ptr, i32, i32, i32, i32,
        i64, i64, i64, i64, i64, i64, ctypes.c_float, i32, i32, i32, ptr,
    ]
    lib.attention_btd_launch.restype = i32
    lib.attention_btd_error_string.argtypes = [i32]
    lib.attention_btd_error_string.restype = ctypes.c_char_p
    return lib
