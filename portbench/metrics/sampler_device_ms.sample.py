"""Device ms per denoiser step outside the benchmark's span around the
denoiser (the sampler's posterior update, noise draws and the CFG fold)."""


def read(trace):
    steps = trace.info.get("steps", 0)
    if not trace.ops or not steps:
        return None
    return trace.device_ms(outside="denoiser") / steps
