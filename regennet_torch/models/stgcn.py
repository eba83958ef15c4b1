"""Spatial-temporal graph convolutional action classifier (counterpart of
regennet_tpu/models/stgcn.py), the frozen evaluator of the CMDM protocol.

Ten st-gcn blocks 64 -> 128 -> 256 (or the `channels` / `strides` given),
learnable per-block edge importance, the spatial-partition graph of
models/stgcn_graph.py, the input split into its persons (one or two) and
a data BatchNorm over the (person, joint, channel) axis; no dropout (the
classifier is only evaluated). It returns pooled `features` (for FID,
diversity and multimodality) and `yhat` logits (for accuracy).
`make_unconstrained_stgcn` builds the six-block openpose evaluator of the
unconstrained protocol.

Convolutions run NCHW over [N * M, C, T, V] with plain torch.nn
functional convolutions (the JAX package runs them outside any kernel of
its own). Module and parameter names are the reference recognition
classifier's (`data_bn`, `st_gcn_networks.{i}.{gcn.conv, tcn.0, tcn.2,
tcn.3, residual.0, residual.1}`, `edge_importance.{i}`, `fcn`), so a
released `.pth.tar` state dict loads as it is (train/checkpoint.py).
BatchNorm layers have eps 1e-5 and are evaluated with their running
statistics: build the module and call `.eval()`. In train mode (the
classifier's trainer, eval/train_stgcn.py) they normalise with the batch
statistics and update the running ones with torch's momentum 0.1, the
JAX package's _BN_MOMENTUM 0.9 (running = 0.9 running + 0.1 batch). One
difference is kept on purpose: torch folds the unbiased batch variance
(n / (n - 1) times the biased one) into running_var, flax the biased one;
the reference's classifier was trained in torch.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

from regennet_torch.models import initializers
from regennet_torch.models.stgcn_graph import Graph

CHANNELS = (64, 64, 64, 64, 128, 128, 128, 256, 256, 256)
STRIDES = (1, 1, 1, 1, 2, 1, 1, 2, 1, 1)


class ConvTemporalGraphical(nn.Module):
    """1x1 convolution to K * C_out channels, contracted with A [K, V, W]."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int):
        super().__init__()
        self.kernel_size = kernel_size
        self.conv = nn.Conv2d(in_channels, out_channels * kernel_size, kernel_size=1)

    def forward(self, x, A):
        x = self.conv(x)  # [N, K * C, T, V]
        n, kc, t, v = x.shape
        x = x.view(n, self.kernel_size, kc // self.kernel_size, t, v)
        return torch.einsum("nkctv,kvw->nctw", x, A)


class STGCNBlock(nn.Module):
    """Graph convolution, then BatchNorm, ReLU, a temporal convolution
    (kernel 9, padding 4, the block's stride), BatchNorm; plus the
    residual branch; ReLU."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 residual: bool = True, temporal_kernel: int = 9,
                 spatial_kernel: int = 3):
        super().__init__()
        pad = (temporal_kernel - 1) // 2
        self.gcn = ConvTemporalGraphical(in_channels, out_channels, spatial_kernel)
        self.tcn = nn.Sequential(
            nn.BatchNorm2d(out_channels, eps=1e-5),
            nn.ReLU(),
            nn.Conv2d(out_channels, out_channels, (temporal_kernel, 1), (stride, 1),
                      (pad, 0)),
            nn.BatchNorm2d(out_channels, eps=1e-5),
        )
        self.has_residual = residual
        if residual and (in_channels != out_channels or stride != 1):
            self.residual = nn.Sequential(
                nn.Conv2d(in_channels, out_channels, 1, (stride, 1)),
                nn.BatchNorm2d(out_channels, eps=1e-5),
            )
        else:
            self.residual = None

    def forward(self, x, A):
        if not self.has_residual:
            res = 0.0
        elif self.residual is None:
            res = x
        else:
            res = self.residual(x)
        return torch.relu(self.tcn(self.gcn(x, A)) + res)


class STGCN(nn.Module):
    """in_channels counts both persons (12 for two-person rot6d)."""

    def __init__(self, in_channels: int, num_class: int, num_person: int = 2,
                 layout: str = "smplx", channels: Sequence[int] = CHANNELS,
                 strides: Sequence[int] = STRIDES):
        super().__init__()
        graph = Graph(layout=layout)
        A = torch.tensor(graph.A, dtype=torch.float32)  # [K, V, V]
        # rebuilt from the layout: a released file's "A" is not loaded
        self.register_buffer("A", A, persistent=False)
        self.num_person = num_person
        self.num_node = graph.num_node
        blocks, c_in = [], in_channels // num_person
        for i, (c, s) in enumerate(zip(channels, strides)):
            blocks.append(STGCNBlock(c_in, c, s, residual=i != 0,
                                     spatial_kernel=A.shape[0]))
            c_in = c
        self.data_bn = nn.BatchNorm1d(in_channels * graph.num_node, eps=1e-5)
        self.st_gcn_networks = nn.ModuleList(blocks)
        self.edge_importance = nn.ParameterList(
            nn.Parameter(torch.ones(A.shape)) for _ in blocks)
        self.fcn = nn.Conv2d(c_in, num_class, kernel_size=1)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x [N, V, C * M, T] (both persons' channels concatenated) ->
        {"features": [N, channels[-1]], "yhat": [N, num_class]}."""
        N, V, CM, T = x.shape
        M = self.num_person
        C = CM // M
        # [N, M, V, C, T]; the data BatchNorm's channels are (m, v, c)
        h = x.reshape(N, V, M, C, T).permute(0, 2, 1, 3, 4)
        h = self.data_bn(h.reshape(N, M * V * C, T))
        h = h.view(N, M, V, C, T).permute(0, 1, 3, 4, 2).reshape(N * M, C, T, V)
        for block, importance in zip(self.st_gcn_networks, self.edge_importance):
            h = block(h, self.A * importance)
        # global pool over (T, V), mean over persons
        feat = h.mean(dim=(2, 3)).view(N, M, -1).mean(dim=1)
        yhat = self.fcn(feat[:, :, None, None])[:, :, 0, 0]
        return {"features": feat, "yhat": yhat}


def make_unconstrained_stgcn(num_class: int = 12) -> STGCN:
    """The unconstrained HumanAct12 evaluator: six blocks over 15
    openpose-layout xyz joints of one person."""
    return STGCN(in_channels=3, num_class=num_class, num_person=1, layout="openpose",
                 channels=(64, 64, 64, 128, 128, 256), strides=(1, 1, 1, 2, 1, 2))


def random_init_(model: STGCN, generator: torch.Generator) -> STGCN:
    """Draw a fresh ST-GCN from `generator` as the JAX package's Flax
    STGCN is drawn (models/initializers): every convolution's kernel
    lecun-normal and its bias zero, BatchNorm at one and zero; the edge
    importance keeps its ones."""
    return initializers.init_params_(model, generator, {"edge_importance": None})


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of the integer labels."""
    return torch.nn.functional.cross_entropy(logits, labels.long())


def accuracy_from_logits(logits: np.ndarray, labels: np.ndarray) -> float:
    return float((np.argmax(logits, axis=1) == labels).mean())
