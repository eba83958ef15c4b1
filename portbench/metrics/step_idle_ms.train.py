"""Card idle ms per optimizer step while the trainer's main thread is
inside the program's `train.to_device` (pageable copies, each waiting for
the stream) or `train.step` span (the step's launches), in the program's
traced window (portbench/program.py)."""

from portbench import program as recorded


def read(trace):
    program = recorded.of(trace)
    if program is None or not program.ops or not program.steps:
        return None
    return program.idle_ms("train.to_device", "train.step") / program.steps
