"""Flax's default initialisers, drawn into the port's parameters.

The JAX package builds every model with Flax's defaults: a Dense or Conv
kernel is lecun-normal (`variance_scaling(1.0, "fan_in",
"truncated_normal")`), a bias zero, each recurrent gate kernel of a
GRUCell orthogonal, LayerNorm and BatchNorm at one and zero; the few
parameters it declares itself draw from `normal(std)`. A fresh port model
draws the same distributions here (`init_params_`), so a model trained
from scratch starts where the JAX package's starts. Torch's own defaults
(U(+-1/sqrt(fan_in)) kernels and biases, xavier-uniform packed attention
projections) are narrower and have nonzero biases.

Fan-in is Flax's, read from the kernel's layout: input features times the
receptive field. A ConvTranspose1d weight is [in, out, k], so its fan-in
is in * k, where torch's `_calculate_fan_in_and_fan_out` reads out * k.

Every draw is taken in float32 on the CPU from the explicit
`torch.Generator` and then copied into the parameter, so one seed gives
the same parameters on any device and in any dtype.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
from torch import nn

# the std of a standard normal truncated to (-2, 2)
TRUNCATED_STD = 0.87962566103423978


def _put(tensor: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        tensor.copy_(values)
    return tensor


def lecun_normal_(tensor: torch.Tensor, generator: torch.Generator,
                  fan_in: int) -> torch.Tensor:
    """Flax's lecun_normal: a normal truncated at two of its stds, scaled
    so that the result's std is sqrt(1 / fan_in)."""
    std = math.sqrt(1.0 / fan_in) / TRUNCATED_STD
    draw = torch.empty(tensor.shape, dtype=torch.float32)
    nn.init.trunc_normal_(draw, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    return _put(tensor, draw)


def orthogonal_(tensor: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """An orthogonal [H, H] matrix (Flax's `orthogonal()`)."""
    draw = torch.empty(tensor.shape, dtype=torch.float32)
    nn.init.orthogonal_(draw, generator=generator)
    return _put(tensor, draw)


def normal_(tensor: torch.Tensor, generator: torch.Generator, std: float) -> torch.Tensor:
    """Flax's `normal(std)`."""
    return _put(tensor, torch.randn(tensor.shape, generator=generator) * std)


def zeros_(tensor: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return tensor.zero_()


def ones_(tensor: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return tensor.fill_(1.0)


def _recurrent_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """A GRU's weight_hh [3H, H]: each gate block (r, z, n) orthogonal, as
    Flax draws hr, hz and hn."""
    for block in weight.chunk(3, dim=0):
        orthogonal_(block, generator)


_NORMS = (nn.LayerNorm, nn.modules.batchnorm._BatchNorm)
_LAYERS = _NORMS + (nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d, nn.GRU, nn.GRUCell)


def _default_(module: nn.Module, name: str, p: torch.Tensor,
              generator: torch.Generator) -> bool:
    """Draw `module`'s parameter `name` by Flax's default for the layer
    that holds it; False when the layer has no Flax counterpart here."""
    if (name.startswith("bias") and isinstance(module, _LAYERS)) or name == "in_proj_bias":
        zeros_(p)
    elif isinstance(module, _NORMS):
        ones_(p)
    elif isinstance(module, nn.Linear) or name == "in_proj_weight":  # in_proj: packed q, k, v
        lecun_normal_(p, generator, p.shape[1])
    elif isinstance(module, (nn.Conv1d, nn.Conv2d)):
        lecun_normal_(p, generator, p[0].numel())
    elif isinstance(module, nn.ConvTranspose1d):
        lecun_normal_(p, generator, p.shape[0] * p.shape[2])
    elif isinstance(module, (nn.GRU, nn.GRUCell)) and name.startswith("weight_ih"):
        lecun_normal_(p, generator, p.shape[1])
    elif isinstance(module, (nn.GRU, nn.GRUCell)) and name.startswith("weight_hh"):
        _recurrent_(p, generator)
    else:
        return False
    return True


def _matches(full_name: str, key: str) -> bool:
    return f".{key}." in f".{full_name}."


def init_params_(model: nn.Module, generator: torch.Generator,
                 normal: Optional[Mapping[str, Optional[float]]] = None) -> nn.Module:
    """Draw every parameter of `model` as the JAX package's Flax module
    draws its counterpart, in the order of `named_modules()` and, within a
    module, of registration.

    `normal` maps the parameters a JAX module declares with its own
    initialiser to that initialiser's std (`normal(std)`), or to None for
    one left as constructed (a constant, such as the ST-GCN's edge
    importance at one). A key names a dotted run of the parameter's name:
    "action_embedding", "frame_embed.weight". A parameter that neither a
    key nor a layer's default covers raises, so no parameter keeps torch's
    default bounds unseen."""
    normal = dict(normal or {})
    with torch.no_grad():
        for mod_name, module in model.named_modules():
            for name, p in module.named_parameters(recurse=False):
                full = f"{mod_name}.{name}" if mod_name else name
                key = next((k for k in normal if _matches(full, k)), False)
                if key is not False:
                    if normal[key] is not None:
                        normal_(p, generator, normal[key])
                elif not _default_(module, name, p, generator):
                    raise TypeError(f"{full} ({type(module).__name__}): no Flax "
                                    "initialiser is known for it")
    return model
