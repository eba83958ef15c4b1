"""Card idle ms per denoiser step while the sampler's main thread is
inside the program's `sample.step` span, in its traced window
(portbench/program.py)."""

from portbench import program as recorded


def read(trace):
    program = recorded.of(trace)
    if program is None or not program.ops or not program.steps:
        return None
    return program.idle_ms("sample.step") / program.steps
