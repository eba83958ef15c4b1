"""The sampling attention's share of its roofline: the frozen least time
of every call in the window (portbench/counts/attention.py), over the
device time inside the benchmark's spans around `fused_attention_btd`."""

from portbench.counts import attention


def read(trace):
    inside = trace.device_ms(within="attention")
    calls = [c for c in trace.info.get("attention", []) if c[0] == "forward"]
    if not inside or not calls:
        return None
    dtype = trace.info["config"]["compute_dtype"]
    bound = sum(attention.forward_ms(B, T, D, H, dtype, causal) for _, B, T, D, H, causal in calls)
    return 100.0 * bound / inside
