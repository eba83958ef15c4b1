"""The share of the timed traced window (CUDA activity alone) in which no
operation ran on the card: 1 - the union of device-operation intervals
over the window's wall."""


def read(trace):
    if not trace.device_ops or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
