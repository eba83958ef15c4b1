"""Checkpoints in the reference torch layout (counterpart of
regennet_tpu/train/checkpoint.py).

A training checkpoint of step N is two files in the run's directory, with
the run's args.json beside them:
  * `model{N:09d}.pt`: the denoiser's state dict (reference layout), which
    `load_model` and the sampler read as they are;
  * `opt{N:09d}.pt`: the AdamW state, the EMA parameters by name, the step,
    and the host samplers' RNG states.
Released reference files carry keys the denoiser does not own (the frozen
CLIP tower, body-model buffers, the positional tables); they are dropped
before `load_state_dict(strict=True)`.

`load_classifier_state` loads an evaluation classifier (an ST-GCN, the
GRU classifier) from the port's `.pt` file, a released `.pth.tar` or
`.tar` (its state dict, possibly wrapped as {"model": ...} or
{"state_dict": ...}), or a state dict in that layout.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

IGNORABLE_PREFIXES = ("clip_model.", "rot2xyz.")
IGNORABLE_SUFFIXES = ("num_batches_tracked", "sequence_pos_encoder.pe", ".pe")
IGNORABLE_EXACT = ("pe",)
CKPT_RE = re.compile(r"model(\d+)(\.pt)?$")


def ckpt_name(step: int) -> str:
    return f"model{step:09d}.pt"


def opt_name(step: int) -> str:
    return f"opt{step:09d}.pt"


def parse_step_from_path(path: str) -> int:
    m = CKPT_RE.search(os.path.basename(path.rstrip("/")))
    return int(m.group(1)) if m else 0


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


def _cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def save_checkpoint(save_dir: str, step: int, model: nn.Module,
                    optimizer: torch.optim.Optimizer,
                    ema: Dict[str, torch.Tensor],
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Write model{step}.pt and opt{step}.pt; returns the model file's path."""
    return save_state(save_dir, step, model.state_dict(), optimizer.state_dict(), ema, extra)


def save_state(save_dir: str, step: int, model_state: Dict[str, torch.Tensor],
               optimizer_state: Dict[str, Any], ema: Dict[str, torch.Tensor],
               extra: Optional[Dict[str, Any]] = None) -> str:
    """save_checkpoint from the state dicts themselves."""
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(save_dir, ckpt_name(step)))
    torch.save(_cpu(model_state), path)
    train_state = {"optimizer": _cpu(optimizer_state), "ema": _cpu(ema),
                   "step": int(step), **(extra or {})}
    torch.save(train_state, os.path.join(save_dir, opt_name(step)))
    return path


def latest_checkpoint(save_dir: str) -> Optional[str]:
    """The model file of the highest step in save_dir, or None."""
    if not os.path.isdir(save_dir):
        return None
    steps = []
    for name in os.listdir(save_dir):
        m = CKPT_RE.match(name)
        if m and m.group(2) and os.path.isfile(os.path.join(save_dir, name)):
            steps.append((int(m.group(1)), name))
    if not steps:
        return None
    return os.path.join(save_dir, max(steps)[1])


def load_checkpoint(path: str, model: nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    ema: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, Any]:
    """Load model{N}.pt into `model` and, when opt{N}.pt lies beside it,
    the AdamW state into `optimizer` and the EMA into `ema` (in place).
    Returns the opt file's other entries ({"step": N} without one)."""
    load_model(model, path)
    step = parse_step_from_path(path)
    opt_path = os.path.join(os.path.dirname(path), opt_name(step))
    if not os.path.isfile(opt_path):
        return {"step": step}
    state = torch.load(opt_path, map_location="cpu", weights_only=True)
    if optimizer is not None:
        optimizer.load_state_dict(state["optimizer"])
    if ema is not None:
        if set(state["ema"]) != set(ema):
            raise ValueError(f"{opt_path}: EMA names differ from the model's")
        with torch.no_grad():
            for name, value in state["ema"].items():
                ema[name].copy_(value)
    return {k: v for k, v in state.items() if k not in ("optimizer", "ema")}


def load_classifier_state(model: nn.Module,
                          state: Union[str, os.PathLike, Mapping[str, Any]]) -> nn.Module:
    """Load a classifier's weights into `model` from a file path or a state
    dict of tensors or numpy arrays in the reference layout. An ST-GCN's
    adjacency buffer "A" (rebuilt from the layout) and BatchNorm's
    num_batches_tracked may be present or absent; every other key must
    match."""
    if isinstance(state, (str, os.PathLike)):
        state = torch.load(state, map_location="cpu", weights_only=True)
    for wrapper in ("state_dict", "model"):
        if isinstance(state.get(wrapper), Mapping):
            state = state[wrapper]
    sd = {k: v if torch.is_tensor(v) else torch.tensor(np.asarray(v))
          for k, v in state.items() if k != "A"}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(f"classifier state does not match the model: missing "
                         f"{missing[:10]}, unexpected {unexpected[:10]}")
    return model
