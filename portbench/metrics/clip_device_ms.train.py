"""Device ms per optimizer step launched inside the program's
`clip.encode` span (the CLIP text tower, the tokens' copy and the
embedding's read-back), in its traced window (portbench/program.py)."""

from portbench import program as recorded


def read(trace):
    program = recorded.of(trace)
    if program is None or not program.ops or not program.steps:
        return None
    return program.device_ms(within=("clip.encode",)) / program.steps
