"""Explicit device choice: the GPU unless the caller asks for the CPU.

Nothing in the port falls back to the CPU because a GPU is missing: an
entry point called without `device` on a machine without CUDA raises, so
a run that was meant for the card never silently measures the host.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None, index: Union[int, str] = 0) -> torch.device:
    """`device` as given ("cpu", "cuda:1", a torch.device), else cuda:{index},
    or the CPU when index is "cpu" (the CLIs' `--device cpu`).

    Raises RuntimeError when the result is a CUDA device and CUDA is not
    available."""
    if device is None:
        device = "cpu" if index == "cpu" else torch.device("cuda", int(index))
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            "device='cpu' to run on the CPU"
        )
    return dev

