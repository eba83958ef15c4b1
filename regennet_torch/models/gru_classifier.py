"""GRU action classifier of the action2motion evaluation (counterpart of
regennet_tpu/models/gru_classifier.py).

A stacked GRU over the per-frame joint coordinates, its hidden state
starting at zero. `hidden` is the last valid frame's top-layer state
(the frame `lengths - 1`), `features` is tanh(linear1(hidden)), the
30-dim vector of the FID and diversity protocol, and `yhat` is
linear2(features), the logits. Module names are the reference
classifier's (`recurrent`, an nn.GRU with batch_first, `linear1`,
`linear2`), so a released `humanact12_gru.tar` ({"model": state dict})
loads as it is (train/checkpoint.load_classifier_state).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn


class MotionDiscriminator(nn.Module):
    def __init__(self, input_size: int = 72, hidden_size: int = 128,
                 hidden_layers: int = 2, output_size: int = 12):
        super().__init__()
        self.recurrent = nn.GRU(input_size, hidden_size, hidden_layers, batch_first=True)
        self.linear1 = nn.Linear(hidden_size, 30)
        self.linear2 = nn.Linear(30, output_size)

    def forward(self, motion: torch.Tensor,
                lengths: torch.Tensor = None) -> Dict[str, torch.Tensor]:
        """motion [B, J, F, T], lengths [B] -> {"features" [B, 30],
        "hidden" [B, hidden_size], "yhat" [B, output_size]}."""
        B, J, F, T = motion.shape
        x = motion.reshape(B, J * F, T).permute(0, 2, 1).float()
        h, _ = self.recurrent(x)  # [B, T, H]; no initial state: zeros
        if lengths is None:
            hidden = h[:, -1]
        else:
            idx = torch.clamp(lengths.long().to(h.device) - 1, 0, T - 1)
            hidden = h[torch.arange(B, device=h.device), idx]
        features = torch.tanh(self.linear1(hidden))
        return {"features": features, "hidden": hidden, "yhat": self.linear2(features)}


def random_init_(model: MotionDiscriminator,
                 generator: torch.Generator) -> MotionDiscriminator:
    """Draw every weight and bias from torch's default bounds with
    `generator`: U(+-1/sqrt(hidden_size)) in the GRU, U(+-1/sqrt(fan_in))
    in the linear layers."""
    with torch.no_grad():
        bound = 1.0 / np.sqrt(model.recurrent.hidden_size)
        for p in model.recurrent.parameters():
            p.uniform_(-bound, bound, generator=generator)
        for lin in (model.linear1, model.linear2):
            bound = 1.0 / np.sqrt(lin.in_features)
            lin.weight.uniform_(-bound, bound, generator=generator)
            lin.bias.uniform_(-bound, bound, generator=generator)
    return model

