"""Device ms per denoiser call inside the benchmark's span around the
CMDM's forward (one 2B-row forward of a CFG step)."""


def read(trace):
    calls = trace.info.get("denoiser_calls", 0)
    inside = trace.device_ms(within="denoiser")
    if not calls or not inside:
        return None
    return inside / calls
