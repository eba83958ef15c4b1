"""Device ms per optimizer step launched inside the program's
`train.optimizer` span (the gradient norm, AdamW, the EMA and the step's
metrics), in its traced window (portbench/program.py)."""

from portbench import program as recorded


def read(trace):
    program = recorded.of(trace)
    if program is None or not program.ops or not program.steps:
        return None
    return program.device_ms(within=("train.optimizer",)) / program.steps
