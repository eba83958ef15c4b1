"""Checkpoint load/save in the reference torch layout (counterpart of the
loading side of regennet_tpu/train/checkpoint.py).

A checkpoint is a torch state dict file (`model######.pt`) with the
run's args.json beside it. Released reference files carry keys the
denoiser does not own (the frozen CLIP tower, body-model buffers, the
positional tables); they are dropped before `load_state_dict(strict=True)`.
"""

from __future__ import annotations

import os
from typing import Dict

import torch
from torch import nn

IGNORABLE_PREFIXES = ("clip_model.", "rot2xyz.")
IGNORABLE_SUFFIXES = ("num_batches_tracked", "sequence_pos_encoder.pe", ".pe")
IGNORABLE_EXACT = ("pe",)


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a torch checkpoint file, ignorable keys dropped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and isinstance(sd.get("state_dict"), dict):
        sd = sd["state_dict"]
    return {
        k: v for k, v in sd.items()
        if torch.is_tensor(v)
        and not k.startswith(IGNORABLE_PREFIXES)
        and not k.endswith(IGNORABLE_SUFFIXES)
        and k not in IGNORABLE_EXACT
    }


def load_model(model: nn.Module, path: str) -> nn.Module:
    """Load a checkpoint file into `model` (strict: every key must match)."""
    if not (os.path.isfile(path) and path.endswith((".pt", ".tar"))):
        raise ValueError(
            f"{path}: expected a torch state dict file (.pt); other "
            "checkpoint formats are not supported by the port"
        )
    model.load_state_dict(load_state_dict(path), strict=True)
    return model
