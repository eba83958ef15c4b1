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
caller's torch.Generator (or a parallel.mesh.ShardedDraws over one, whose
draws are a sharded step's slices of the global batch's).

Tensor parallelism (`tp`, set by parallel.mesh.shard_model_): the
attention holds this rank's heads (a local in_proj of [3D/N, D] and
out_proj columns) and the feed-forward its linear1 rows and linear2
columns; the row-parallel outputs are all-reduced before their bias.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from regennet_torch.ops.attention import fused_attention_btd, fused_attention_btd_train
from regennet_torch.parallel.mesh import ShardedDraws


def draws(generator) -> ShardedDraws:
    """A ShardedDraws as it is; a torch.Generator as one process's."""
    return generator if isinstance(generator, ShardedDraws) else ShardedDraws(generator)


def uniform(shape, generator, device, shard_dim: Optional[int] = None) -> torch.Tensor:
    """U[0, 1) draws of `shape` from a torch.Generator or a ShardedDraws
    (shard_dim: the dim split over tensor-parallel ranks)."""
    return draws(generator).rand(shape, device, shard_dim)


def dropout(x: torch.Tensor, rate: float, generator,
            shard_dim: Optional[int] = None) -> torch.Tensor:
    """flax nn.Dropout: keep each entry with probability 1 - rate and scale
    kept entries by 1/(1 - rate); identity without a generator (not
    training) or at rate 0."""
    if generator is None or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = uniform(x.shape, generator, x.device, shard_dim) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def row_seeds(batch: int, generator, device, head0: Optional[int] = None) -> torch.Tensor:
    """Per-row int32 seeds [B, 2] of the training attention's dropout bits;
    [B, 3] with head0, the global index of the rank's first head."""
    seeds = draws(generator).randint(-2 ** 31, 2 ** 31, (batch, 2), device, torch.int32)
    if head0 is None:
        return seeds
    return torch.cat([seeds, torch.full((batch, 1), head0, dtype=torch.int32,
                                        device=device)], dim=1)


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
        self.tp = None  # parallel.mesh.TensorParallel under tensor parallelism
        nn.init.xavier_uniform_(self.in_proj_weight)

    def _out(self, x):
        """out_proj; row-parallel under tensor parallelism."""
        if self.tp is None:
            return self.out_proj(x)
        return self.tp.reduce(F.linear(x, self.out_proj.weight)) + self.out_proj.bias

    def forward(self, q_in, kv_in, causal: bool = False, generator=None):
        D = q_in.shape[-1]
        B, Tq = q_in.shape[:2]
        Dl = self.in_proj_weight.shape[0] // 3  # this rank's columns (D without tp)
        self_attention = q_in is kv_in
        if self.tp is not None:
            q_in = self.tp.copy(q_in)
            kv_in = q_in if self_attention else self.tp.copy(kv_in)
        if kv_in.shape[1] == 1:
            # single-key cross-attention (the timestep/action token): a
            # softmax over one logit is exactly 1, so the output is
            # out_proj(v_proj(memory)) for every query; the q and k parts
            # of in_proj exist only for the checkpoint layout
            v = F.linear(kv_in, self.in_proj_weight[2 * Dl:],
                         self.in_proj_bias[2 * Dl:])
            if generator is None:
                return self._out(v).expand(B, Tq, D)
            # training: the weight 1 of each (batch, head, query) goes
            # through the attention dropout, 1/(1 - rate) or 0
            H = self.num_heads
            w = dropout(torch.ones((B, H, Tq, 1), dtype=v.dtype, device=v.device),
                        self.dropout, generator, shard_dim=1)
            out = w * v.view(B, 1, H, Dl // H).transpose(1, 2)  # [B, H, Tq, hd]
            return self._out(out.transpose(1, 2).reshape(B, Tq, Dl))
        if not (causal or self_attention):
            raise NotImplementedError(
                "cross-attention over more than one key is not ported"
            )
        # self-attention: one packed projection; q, k, v are column views
        qkv = F.linear(q_in, self.in_proj_weight, self.in_proj_bias)
        q, k, v = qkv[..., :Dl], qkv[..., Dl:2 * Dl], qkv[..., 2 * Dl:]
        if generator is None:
            out = fused_attention_btd(q, k, v, self.num_heads, causal=causal)
        else:
            head0 = None if self.tp is None else self.tp.rank * self.num_heads
            out = fused_attention_btd_train(
                q, k, v, self.num_heads, self.dropout,
                row_seeds(B, generator, q_in.device, head0), causal=causal,
            )
        return self._out(out)


def feed_forward(layer, x, generator):
    """linear2(dropout(activation(linear1(x)))): linear1 column- and linear2
    row-parallel under tensor parallelism."""
    tp = layer.tp
    if tp is None:
        return layer.linear2(dropout(layer.activation(layer.linear1(x)), layer.dropout,
                                     generator))
    h = dropout(layer.activation(layer.linear1(tp.copy(x))), layer.dropout, generator,
                shard_dim=2)
    return tp.reduce(F.linear(h, layer.linear2.weight)) + layer.linear2.bias


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
        self.tp = None  # parallel.mesh.TensorParallel under tensor parallelism

    def forward(self, x, generator=None):
        def drop(h):
            return dropout(h, self.dropout, generator)

        x = self.norm1(x + drop(self.self_attn(x, x, False, generator)))
        return self.norm2(x + drop(feed_forward(self, x, generator)))


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
        self.tp = None  # parallel.mesh.TensorParallel under tensor parallelism

    def forward(self, x, memory, causal: bool = False, generator=None):
        def drop(h):
            return dropout(h, self.dropout, generator)

        x = self.norm1(x + drop(self.self_attn(x, x, causal, generator)))
        x = self.norm2(x + drop(self.multihead_attn(x, memory, False, generator)))
        return self.norm3(x + drop(feed_forward(self, x, generator)))


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
