"""Transformer encoder and decoder blocks for the CMDM denoiser
(counterpart of regennet_tpu/models/transformer.py).

Post-LayerNorm layers (eps 1e-5) with the reference torch module and
parameter names (`self_attn`, `multihead_attn` with a packed
`in_proj_weight`, `linear1/2`, `norm1/2/3`), batch-first [B, T, D]. The
decoder's self-attention is causal, the encoder's non-causal with no key
mask (the port does not pad the sequence).
Self-attention goes through ops.attention: `fused_attention_btd` when
sampling, `fused_attention_btd_train` (attention-weight dropout, with a
gradient) in train mode, at every dropout rate, 0 included. Each is the
CUDA kernel on the GPU and its plain version on the CPU; the softmax runs
in the compute dtype (the JAX package's default bf16 softmax).

Train mode (`generator` given) applies the JAX package's dropouts:
attention weights, the feed-forward hidden layer, and each residual
branch, at the layer's rate, with every random draw taken from the
caller's torch.Generator.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from regennet_torch.ops.attention import fused_attention_btd, fused_attention_btd_train


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax nn.Dropout: keep each entry with probability 1 - rate and scale
    kept entries by 1/(1 - rate); identity without a generator (not
    training) or at rate 0."""
    if generator is None or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def row_seeds(batch: int, generator: torch.Generator, device) -> torch.Tensor:
    """Per-row int32 seeds [B, 2] of the training attention's dropout bits."""
    return torch.randint(-2 ** 31, 2 ** 31, (batch, 2), generator=generator,
                         device=device, dtype=torch.int32)


class MultiheadAttention(nn.Module):
    """Packed-QKV multi-head attention in the layout of torch's
    nn.MultiheadAttention (in_proj_weight [3D, D], in_proj_bias, out_proj)."""

    def __init__(self, latent_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * latent_dim, latent_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * latent_dim))
        self.out_proj = nn.Linear(latent_dim, latent_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, q_in, kv_in, causal: bool = False,
                generator: Optional[torch.Generator] = None):
        D = q_in.shape[-1]
        B, Tq = q_in.shape[:2]
        if kv_in.shape[1] == 1:
            # single-key cross-attention (the timestep/action token): a
            # softmax over one logit is exactly 1, so the output is
            # out_proj(v_proj(memory)) for every query; the q and k parts
            # of in_proj exist only for the checkpoint layout
            v = F.linear(kv_in, self.in_proj_weight[2 * D:],
                         self.in_proj_bias[2 * D:])
            if generator is None:
                return self.out_proj(v).expand(B, Tq, D)
            # training: the weight 1 of each (batch, head, query) goes
            # through the attention dropout, 1/(1 - rate) or 0
            H = self.num_heads
            w = dropout(torch.ones((B, H, Tq, 1), dtype=v.dtype, device=v.device),
                        self.dropout, generator)
            out = w * v.view(B, 1, H, D // H).transpose(1, 2)  # [B, H, Tq, hd]
            return self.out_proj(out.transpose(1, 2).reshape(B, Tq, D))
        if not (causal or q_in is kv_in):
            raise NotImplementedError(
                "cross-attention over more than one key is not ported"
            )
        # self-attention: one packed projection; q, k, v are column views
        qkv = F.linear(q_in, self.in_proj_weight, self.in_proj_bias)
        q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
        if generator is None:
            out = fused_attention_btd(q, k, v, self.num_heads, causal=causal)
        else:
            out = fused_attention_btd_train(
                q, k, v, self.num_heads, self.dropout,
                row_seeds(B, generator, q_in.device), causal=causal,
            )
        return self.out_proj(out)


class EncoderLayer(nn.Module):
    """Post-LN encoder: x = LN(x + SelfAttn(x)); x = LN(x + FF(x)), the
    self-attention non-causal over every token."""

    def __init__(self, latent_dim: int, num_heads: int, ff_size: int,
                 activation: Callable, dropout: float = 0.0):
        super().__init__()
        self.self_attn = MultiheadAttention(latent_dim, num_heads, dropout)
        self.linear1 = nn.Linear(latent_dim, ff_size)
        self.linear2 = nn.Linear(ff_size, latent_dim)
        self.norm1 = nn.LayerNorm(latent_dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(latent_dim, eps=1e-5)
        self.activation = activation
        self.dropout = dropout

    def forward(self, x, generator: Optional[torch.Generator] = None):
        def drop(h):
            return dropout(h, self.dropout, generator)

        x = self.norm1(x + drop(self.self_attn(x, x, False, generator)))
        ff = self.linear2(drop(self.activation(self.linear1(x))))
        return self.norm2(x + drop(ff))


class Encoder(nn.Module):
    def __init__(self, num_layers: int, latent_dim: int, num_heads: int,
                 ff_size: int, activation: Callable, dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(latent_dim, num_heads, ff_size, activation, dropout)
            for _ in range(num_layers)
        )

    def forward(self, x, generator: Optional[torch.Generator] = None):
        for layer in self.layers:
            x = layer(x, generator)
        return x


class DecoderLayer(nn.Module):
    """Post-LN decoder: x = LN(x + SelfAttn(x)); x = LN(x + CrossAttn(x,
    memory)); x = LN(x + FF(x))."""

    def __init__(self, latent_dim: int, num_heads: int, ff_size: int,
                 activation: Callable, dropout: float = 0.0):
        super().__init__()
        self.self_attn = MultiheadAttention(latent_dim, num_heads, dropout)
        self.multihead_attn = MultiheadAttention(latent_dim, num_heads, dropout)
        self.linear1 = nn.Linear(latent_dim, ff_size)
        self.linear2 = nn.Linear(ff_size, latent_dim)
        self.norm1 = nn.LayerNorm(latent_dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(latent_dim, eps=1e-5)
        self.norm3 = nn.LayerNorm(latent_dim, eps=1e-5)
        self.activation = activation
        self.dropout = dropout

    def forward(self, x, memory, causal: bool = False,
                generator: Optional[torch.Generator] = None):
        def drop(h):
            return dropout(h, self.dropout, generator)

        x = self.norm1(x + drop(self.self_attn(x, x, causal, generator)))
        x = self.norm2(x + drop(self.multihead_attn(x, memory, False, generator)))
        ff = self.linear2(drop(self.activation(self.linear1(x))))
        return self.norm3(x + drop(ff))


class Decoder(nn.Module):
    def __init__(self, num_layers: int, latent_dim: int, num_heads: int,
                 ff_size: int, activation: Callable, dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayer(latent_dim, num_heads, ff_size, activation, dropout)
            for _ in range(num_layers)
        )

    def forward(self, x, memory, causal: bool = False,
                generator: Optional[torch.Generator] = None):
        for layer in self.layers:
            x = layer(x, memory, causal, generator)
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
