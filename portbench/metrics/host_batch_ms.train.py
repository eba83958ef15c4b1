"""Host ms per optimizer step in the benchmark's spans around the
trainer's `_make_host_batch` (timestep draw, the condition's numpy, the
CLIP embedding of the captions) and `_to_device`."""


def read(trace):
    steps = trace.info.get("steps", 0)
    spent = trace.span_ms("host_batch", "to_device")
    if not steps or not spent:
        return None
    return spent / steps
