"""The training attention's share of its roofline: the frozen least
times of every forward and backward call in the window
(portbench/counts/attention.py), over the device time inside the
benchmark's spans around `fused_attention_btd_train`'s forward and its
backward."""

from portbench.counts import attention


def read(trace):
    inside = trace.device_ms(within="attention_fwd") + trace.device_ms(within="attention_bwd")
    calls = trace.info.get("attention", [])
    if not inside or not calls:
        return None
    dtype = trace.info["config"]["compute_dtype"]
    bound = sum((attention.forward_ms if kind == "forward" else attention.backward_ms)(
        B, T, D, H, dtype, causal) for kind, B, T, D, H, causal in calls)
    return 100.0 * bound / inside
