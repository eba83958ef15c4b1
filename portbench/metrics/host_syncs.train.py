"""Blocking transfers per optimizer step: the program's `host_syncs`
counter (each copy that waits for the device: the CLIP tokens' copy and
the embedding's read-back, each pageable copy of `_to_device`) over the
steps of its traced window (portbench/program.py)."""

from portbench import program as recorded


def read(trace):
    program = recorded.of(trace)
    if program is None or not program.steps:
        return None
    return program.counters.get("host_syncs", 0) / program.steps
