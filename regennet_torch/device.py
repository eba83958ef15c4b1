"""Explicit device choice: the GPU unless the caller asks for the CPU.

Nothing in the port falls back to the CPU because a GPU is missing: an
entry point called without `device` on a machine without CUDA raises, so
a run that was meant for the card never silently measures the host.

It also holds the port's f32 contract: f32 work runs in f32, without TF32
(pin_f32_contract, which every entry point calls); tf32_allowed lifts it
inside a block, for measurements only.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Union

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



def pin_f32_contract() -> None:
    """f32 means f32 on the GPU: no TF32 in cuBLAS matmuls or cuDNN
    convolutions. PyTorch leaves `torch.backends.cudnn.allow_tf32` True, so
    every entry point calls this before it builds a network."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def tf32_allowed() -> Iterator[None]:
    """TF32 allowed in cuBLAS matmuls and cuDNN convolutions inside the
    block, to measure what the f32 contract costs or buys; the contract is
    pinned again after it."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        pin_f32_contract()
