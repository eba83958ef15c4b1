"""The frozen CLIP ViT-B/32 text tower as a torch module (counterpart of
regennet_tpu/models/clip_text_flax.py).

The reference conditions on `clip_model.encode_text(tokens)`: token and
learned positional embeddings, pre-LN residual blocks with causal
self-attention and quick-GELU MLPs, the final LayerNorm, pooling at the
EOT token (the argmax of the token ids: EOT has the largest id), and the
[width, proj] text projection. Everything runs in float32; the attention
is plain PyTorch (the JAX tower reaches no Pallas kernel either).

Parameter names are those of the OpenAI `ViT-B-32.pt` state dict
(`token_embedding`, `positional_embedding`,
`transformer.resblocks.{i}.{ln_1, attn.in_proj_*, attn.out_proj, ln_2,
mlp.c_fc, mlp.c_proj}`, `ln_final`, `text_projection` as a [D, P]
matrix), so the text keys of the released file load as they are;
`openai_text_state_dict` picks them out of a whole CLIP state dict, or
maps the HF `CLIPTextModelWithProjection` layout onto them.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import torch
from torch import nn

from regennet_torch.models import initializers

TEXT_PREFIXES = ("token_embedding.", "positional_embedding", "transformer.resblocks.",
                 "ln_final.", "text_projection")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CausalSelfAttention(nn.Module):
    """Multi-head causal self-attention with the packed `in_proj` of
    torch's MultiheadAttention: scores over sqrt(hd), masked to -1e9 above
    the diagonal, an f32 softmax."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape
        hd = D // self.heads
        qkv = torch.nn.functional.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (t.reshape(B, T, self.heads, hd).transpose(1, 2)
                   for t in qkv.split(D, dim=-1))
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
        scores = torch.where(causal, scores, torch.full_like(scores, -1e9))
        out = torch.softmax(scores, dim=-1) @ v
        return self.out_proj(out.transpose(1, 2).reshape(B, T, D))


class MLP(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.c_fc = nn.Linear(dim, 4 * dim)
        self.c_proj = nn.Linear(4 * dim, dim)

    def forward(self, x):
        return self.c_proj(quick_gelu(self.c_fc(x)))


class ResidualBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = CausalSelfAttention(dim, heads)
        self.ln_2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = MLP(dim)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, dim: int, heads: int, num_layers: int):
        super().__init__()
        self.resblocks = nn.Sequential(*(ResidualBlock(dim, heads) for _ in range(num_layers)))

    def forward(self, x):
        return self.resblocks(x)


class ClipTextTower(nn.Module):
    """tokens [B, context] integer -> projected text features [B, proj_dim]
    (CLIP.encode_text, float32). The defaults are ViT-B/32's text tower."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77, dim: int = 512,
                 heads: int = 8, num_layers: int = 12, proj_dim: int = 512):
        super().__init__()
        self.context_length = context_length
        self.token_embedding = nn.Embedding(vocab_size, dim)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, dim))
        self.transformer = Transformer(dim, heads, num_layers)
        self.ln_final = nn.LayerNorm(dim, eps=1e-5)
        self.text_projection = nn.Parameter(torch.empty(dim, proj_dim))
        random_init_(self, torch.Generator().manual_seed(0))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        T = tokens.shape[1]
        x = self.token_embedding(tokens) + self.positional_embedding[:T]
        x = self.ln_final(self.transformer(x))
        pooled = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
        return pooled @ self.text_projection


def random_init_(tower: ClipTextTower, generator: torch.Generator) -> ClipTextTower:
    """Draw a random tower from `generator` as the JAX package's Flax
    ClipTextTransformer is drawn (models/initializers): tokens from
    normal(0.02), positions from normal(0.01), the projection from
    normal(0.02), the attention and MLP kernels lecun-normal, biases zero,
    LayerNorms identity. A stand-in for tests and the card's smoke run;
    released weights replace it."""
    return initializers.init_params_(tower, generator, {
        "token_embedding.weight": 0.02, "positional_embedding": 0.01,
        "text_projection": 0.02})


def _hf_to_openai(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An HF `CLIPTextModelWithProjection` state dict in the OpenAI names:
    q/k/v packed into in_proj, the projection Linear's [P, D] weight
    transposed into the [D, P] matrix."""
    tm = "text_model."
    out = {
        "token_embedding.weight": sd[f"{tm}embeddings.token_embedding.weight"],
        "positional_embedding": sd[f"{tm}embeddings.position_embedding.weight"],
        "ln_final.weight": sd[f"{tm}final_layer_norm.weight"],
        "ln_final.bias": sd[f"{tm}final_layer_norm.bias"],
        "text_projection": sd["text_projection.weight"].t().contiguous(),
    }
    i = 0
    while f"{tm}encoder.layers.{i}.layer_norm1.weight" in sd:
        p, q = f"{tm}encoder.layers.{i}", f"transformer.resblocks.{i}"
        for kind in ("weight", "bias"):
            out[f"{q}.attn.in_proj_{kind}"] = torch.cat(
                [sd[f"{p}.self_attn.{n}_proj.{kind}"] for n in "qkv"])
            out[f"{q}.attn.out_proj.{kind}"] = sd[f"{p}.self_attn.out_proj.{kind}"]
            out[f"{q}.ln_1.{kind}"] = sd[f"{p}.layer_norm1.{kind}"]
            out[f"{q}.ln_2.{kind}"] = sd[f"{p}.layer_norm2.{kind}"]
            out[f"{q}.mlp.c_fc.{kind}"] = sd[f"{p}.mlp.fc1.{kind}"]
            out[f"{q}.mlp.c_proj.{kind}"] = sd[f"{p}.mlp.fc2.{kind}"]
        i += 1
    return out


def openai_text_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The text tower's entries of a CLIP state dict, in the OpenAI names:
    from the OpenAI layout (the vision tower and the scalars are dropped)
    or from the HF CLIPTextModelWithProjection layout."""
    if any(k.startswith("text_model.") for k in sd):
        return _hf_to_openai(sd)
    return {k: v for k, v in sd.items() if k.startswith(TEXT_PREFIXES)}


def tower_from_state_dict(sd: Mapping[str, torch.Tensor]) -> ClipTextTower:
    """A ClipTextTower shaped by, and loaded (strictly) with, the text
    entries of `sd` (either layout); 64-dim heads, the CLIP convention."""
    sd = openai_text_state_dict(sd)
    if "transformer.resblocks.0.ln_1.weight" not in sd:
        raise ValueError("no transformer blocks found in the CLIP state dict")
    vocab, dim = sd["token_embedding.weight"].shape
    layers = len({k.split(".")[2] for k in sd if k.startswith("transformer.resblocks.")})
    tower = ClipTextTower(vocab_size=vocab, context_length=sd["positional_embedding"].shape[0],
                          dim=dim, heads=max(1, dim // 64), num_layers=layers,
                          proj_dim=sd["text_projection"].shape[1])
    tower.load_state_dict({k: v.float() for k, v in sd.items()}, strict=True)
    return tower.eval()
