"""Device ms per optimizer step launched inside the program's
`train.loss` span and outside its `denoiser` (q_sample, the mse terms,
the joint decode and LBS where the configuration has them), in its traced
window (portbench/program.py)."""

from portbench import program as recorded


def read(trace):
    program = recorded.of(trace)
    if program is None or not program.ops or not program.steps:
        return None
    return program.device_ms(within=("train.loss",), outside=("denoiser",)) / program.steps
