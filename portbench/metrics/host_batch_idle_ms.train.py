"""Card idle ms per optimizer step while the trainer's main thread is
inside the program's `train.host_batch` span (the timestep draw, the
condition's numpy, the CLIP tokenizer and tower, and its copies), in the
program's traced window (portbench/program.py)."""

from portbench import program as recorded


def read(trace):
    program = recorded.of(trace)
    if program is None or not program.ops or not program.steps:
        return None
    return program.idle_ms("train.host_batch") / program.steps
