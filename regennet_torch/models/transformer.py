"""Transformer decoder blocks for the CMDM denoiser (counterpart of
regennet_tpu/models/transformer.py).

Post-LayerNorm layers (eps 1e-5) with the reference torch module and
parameter names (`self_attn`, `multihead_attn` with a packed
`in_proj_weight`, `linear1/2`, `norm1/2/3`), batch-first [B, T, D].
Self-attention always goes through ops.attention.fused_attention_btd:
the CUDA kernel on the GPU, its plain version on the CPU; its softmax
runs in the compute dtype (the JAX package's default bf16 softmax).
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from regennet_torch.ops.attention import fused_attention_btd


class MultiheadAttention(nn.Module):
    """Packed-QKV multi-head attention in the layout of torch's
    nn.MultiheadAttention (in_proj_weight [3D, D], in_proj_bias, out_proj)."""

    def __init__(self, latent_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * latent_dim, latent_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * latent_dim))
        self.out_proj = nn.Linear(latent_dim, latent_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, q_in, kv_in, causal: bool = False):
        D = q_in.shape[-1]
        if kv_in.shape[1] == 1:
            # single-key cross-attention (the timestep/action token): a
            # softmax over one logit is exactly 1, so the output is
            # out_proj(v_proj(memory)) for every query; the q and k parts
            # of in_proj exist only for the checkpoint layout
            v = F.linear(kv_in, self.in_proj_weight[2 * D:],
                         self.in_proj_bias[2 * D:])
            return self.out_proj(v).expand(q_in.shape[0], q_in.shape[1], D)
        if not (causal or q_in is kv_in):
            raise NotImplementedError(
                "cross-attention over more than one key is not ported"
            )
        # self-attention: one packed projection; q, k, v are column views
        qkv = F.linear(q_in, self.in_proj_weight, self.in_proj_bias)
        out = fused_attention_btd(
            qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:],
            self.num_heads, causal=causal,
        )
        return self.out_proj(out)


class DecoderLayer(nn.Module):
    """Post-LN decoder: x = LN(x + SelfAttn(x)); x = LN(x + CrossAttn(x,
    memory)); x = LN(x + FF(x))."""

    def __init__(self, latent_dim: int, num_heads: int, ff_size: int,
                 activation: Callable):
        super().__init__()
        self.self_attn = MultiheadAttention(latent_dim, num_heads)
        self.multihead_attn = MultiheadAttention(latent_dim, num_heads)
        self.linear1 = nn.Linear(latent_dim, ff_size)
        self.linear2 = nn.Linear(ff_size, latent_dim)
        self.norm1 = nn.LayerNorm(latent_dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(latent_dim, eps=1e-5)
        self.norm3 = nn.LayerNorm(latent_dim, eps=1e-5)
        self.activation = activation

    def forward(self, x, memory, causal: bool = False):
        x = self.norm1(x + self.self_attn(x, x, causal=causal))
        x = self.norm2(x + self.multihead_attn(x, memory))
        ff = self.linear2(self.activation(self.linear1(x)))
        return self.norm3(x + ff)


class Decoder(nn.Module):
    def __init__(self, num_layers: int, latent_dim: int, num_heads: int,
                 ff_size: int, activation: Callable):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayer(latent_dim, num_heads, ff_size, activation)
            for _ in range(num_layers)
        )

    def forward(self, x, memory, causal: bool = False):
        for layer in self.layers:
            x = layer(x, memory, causal=causal)
        return x


def gelu_tanh(x):
    """'gelu': the tanh approximation (flax nn.gelu's default)."""
    return F.gelu(x, approximate="tanh")


def gelu_exact(x):
    """'gelu_exact': the erf form (torch F.gelu's default)."""
    return F.gelu(x)


ACTIVATIONS = {"gelu": gelu_tanh, "gelu_exact": gelu_exact, "relu": F.relu}


@functools.lru_cache(maxsize=8)
def _sinusoidal_numpy(max_len: int, d_model: int) -> np.ndarray:
    position = np.arange(max_len)[:, None].astype(np.float64)
    div_term = np.exp(
        np.arange(0, d_model, 2).astype(np.float64) * (-np.log(10000.0) / d_model)
    )
    pe = np.zeros((max_len, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    pe = pe.astype(np.float32)
    pe.setflags(write=False)
    return pe


def sinusoidal_table(max_len: int, d_model: int) -> torch.Tensor:
    """Sin/cos positional table [max_len, d_model], computed in float64 and
    stored as float32."""
    return torch.tensor(_sinusoidal_numpy(max_len, d_model))
