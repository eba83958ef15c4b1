"""The least time of one attention call on an H100: a frozen copy of
chip_smoke.attention_bound_ms at commit
b14d20cb6bbaa9fb4189ca13e12634674eb6d23e, with its peaks.

Published peaks of one H100 SXM (NVIDIA's data sheet, dense): 3.35 TB/s of
HBM, 989 TFLOP/s in bf16 on the tensor cores, 67 TFLOP/s in float32 off
them."""

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def attention_bound_ms(B, T, D, H, dtype, causal, kv_len, tensors=4, products=2):
    """Least time for an attention function: its `tensors` [B, T, D]
    inputs and outputs moved once over the memory rate, or the `products`
    [pairs x D] matrix products this mask needs (2 flops per multiply-add)
    over the peak rate of the dtype; the larger, and which it is. The
    forward moves q, k, v, out (4) and computes QK^T and AV (2); the
    backward moves q, k, v, dO, dq, dk, dv (7) and computes QK^T, dO V^T,
    dV, dQ and dK (5)."""
    itemsize = 2 if dtype == "bfloat16" else 4
    bytes_moved = tensors * B * T * D * itemsize
    pairs = T * (T + 1) // 2 if causal else T * (kv_len or T)
    flops = 2 * products * B * pairs * D
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def forward_ms(B, T, D, H, dtype, causal):
    return attention_bound_ms(B, T, D, H, dtype, causal, None)[0]


def backward_ms(B, T, D, H, dtype, causal):
    return attention_bound_ms(B, T, D, H, dtype, causal, None, tensors=7, products=5)[0]
