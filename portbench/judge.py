"""The numbers that decide `correct`: gaps between what the timed path
produced and what the reference works out again, each against a limit of
its own from the cell's file."""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch


def relative_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """max |prog - ref| / max |ref|."""
    prog, ref = prog.double(), ref.double()
    scale = float(ref.abs().max())
    return float((prog - ref).abs().max()) / max(scale, 1e-30)


def scalar_gap(prog: float, ref: float) -> float:
    return abs(prog - ref) / max(abs(ref), 1e-30)


def leaf_norms(tensors: Dict[str, torch.Tensor],
               masks: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, float]:
    """The norm of each leaf, over the entries of its mask if given."""
    return {k: float(torch.linalg.vector_norm((v if masks is None else v[masks[k]]).double()))
            for k, v in tensors.items() if masks is None or k in masks}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              masks: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's, over
    the reference's norm of that leaf or of the median leaf, the larger
    (some gradients are all but zero); over the entries of `masks` where
    given."""
    p, r = leaf_norms(prog, masks), leaf_norms(ref, masks)
    median = float(np.median(list(r.values())))
    return {k: abs(p[k] - r[k]) / max(r[k], median, 1e-30) for k in r}


def leaf_gap(prog, ref, masks=None) -> float:
    """The worst leaf's gap (leaf_gaps)."""
    return max(leaf_gaps(prog, ref, masks).values())


def moving_entries(ref_grad: Dict[str, torch.Tensor], share: float = 1e-3):
    """{leaf: mask of the entries whose reference gradient is at least
    `share` of the median leaf's root-mean-square gradient}, leaves with
    no such entry left out. The others are nought to rounding (a key's
    bias under softmax, a projection of an all-zero input) and move under
    Adam by round-off alone."""
    rms = {k: float(torch.linalg.vector_norm(g.double())) / g.numel() ** 0.5
           for k, g in ref_grad.items()}
    floor = share * float(np.median(list(rms.values())))
    masks = {k: g.abs() >= floor for k, g in ref_grad.items()}
    return {k: m for k, m in masks.items() if bool(m.any())}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """[(name, value, limit, passed)]; a number that is not finite, or has
    no limit, fails."""
    rows = []
    for name, value in numbers.items():
        limit = limits.get(name)
        ok = limit is not None and math.isfinite(value) and value <= limit
        rows.append((name, value, limit, ok))
    return rows
