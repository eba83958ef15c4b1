"""Device ms per optimizer step launched while the program's
`train.backward` span was open (autograd launches from its own thread
while the main thread waits in it), in its traced window
(portbench/program.py)."""

from portbench import program as recorded


def read(trace):
    program = recorded.of(trace)
    if program is None or not program.ops or not program.steps:
        return None
    return program.device_ms(within=("train.backward",)) / program.steps
