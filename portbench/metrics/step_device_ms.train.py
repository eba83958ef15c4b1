"""Device busy ms per optimizer step: the union of device-operation
intervals in the timed traced window (CUDA activity alone) over its
steps."""


def read(trace):
    steps = trace.timed.get("steps", 0)
    if not trace.device_ops or not steps:
        return None
    return 1e3 * trace.busy_s / steps
