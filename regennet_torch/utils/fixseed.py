"""Seed fixing for reproducibility (counterpart of regennet_tpu/utils/fixseed.py).

Seeds the host RNGs that frame sampling and shuffling read (`random`,
numpy's global state) and torch's default generators, which draw the
random initialisation of a fresh model. Sampling noise comes from an
explicit `torch.Generator` that the caller seeds.
"""

import random

import numpy as np
import torch


def fixseed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
