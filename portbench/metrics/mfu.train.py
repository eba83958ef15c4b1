"""Training's share of the H100's float32 peak: three times the training
forward's operations per step (forward and backward, no recompute, no
joint decode; portbench/counts/flops.py) times the steps, over the timed traced
window's wall (CUDA activity alone) and the card's peak.""" 

from portbench.counts import flops


def read(trace):
    steps = trace.timed.get("steps", 0)
    if not trace.device_ops or not steps or trace.window_s <= 0:
        return None
    ops = flops.train_step(trace.timed["config"], trace.timed["rows"]) * steps
    return 100.0 * ops / trace.window_s / flops.PEAK_F32
