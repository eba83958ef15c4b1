"""The sampler's share of the H100's float32 peak: the denoiser's
operations per step, counted from shapes (portbench/counts/flops.py),
times the steps, over the timed traced window's wall (CUDA activity alone)."""

from portbench.counts import flops


def read(trace):
    steps = trace.timed.get("steps", 0)
    if not trace.device_ops or not steps or trace.window_s <= 0:
        return None
    ops = flops.denoiser_forward(trace.timed["config"], trace.timed["rows"], train=False) * steps
    return 100.0 * ops / trace.window_s / flops.PEAK_F32
