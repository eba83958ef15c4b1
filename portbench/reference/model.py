"""The plain CMDM denoiser: ReGenNet's conditional motion diffusion model
(MDM's transformer: post-LayerNorm layers, 4 heads, tanh GELU) written as
functions of a weight dict in the layout of the reference torch state
dict (`input_process.poseEmbedding.weight`, `seqTransDecoder.layers.{i}
.self_attn.in_proj_weight`, ...). It imports nothing of the program.

Two trunks: "trans_dec" or "online" (the online ReGenNet model: a causal decoder
whose cross-attention memory is the one timestep-and-condition token) and
"trans_enc" or "offline" (MDM: a non-causal encoder over that token followed by the
frames). Actor fusion "concat" projects [pose, actor] through
`fuse_process`; the attention has no key mask.

Training draws. The program draws every dropout mask from one
torch.Generator in a fixed order: per step the q_sample noise, then, in
the forward, the condition drop of each condition, the positional
dropout, and per layer the attention's row seeds [B, 2] int32, the
residual dropouts, the cross-attention weight dropout and the
feed-forward dropout. `Draws` replays that order on a generator seeded as
the program's is, so the reference sees the same masks without reading
any of the program's state. The attention-weight dropout keeps a weight
where its Philox bits (numerics.keep_mask) clear the rate's threshold.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from . import numerics

Weights = Dict[str, torch.Tensor]
DECODERS = ("online", "trans_dec")
ENCODERS = ("offline", "trans_enc")


class Draws:
    """The program's random draws, in its order, from `generator`."""

    def __init__(self, generator: torch.Generator, device):
        self.generator = generator
        self.device = device

    def rand(self, shape):
        return torch.rand(tuple(shape), generator=self.generator, device=self.device)

    def randn(self, shape):
        return torch.randn(tuple(shape), generator=self.generator, device=self.device,
                           dtype=torch.float32)

    def seeds(self, rows: int):
        return torch.randint(-2 ** 31, 2 ** 31, (rows, 2), generator=self.generator,
                             device=self.device, dtype=torch.int32)


def dropout(x, rate: float, draws: Optional[Draws]):
    if draws is None or rate == 0.0:
        return x
    keep = draws.rand(x.shape) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def layer_norm(x, w: Weights, name: str):
    return F.layer_norm(x, (x.shape[-1],), w[f"{name}.weight"], w[f"{name}.bias"], 1e-5)


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def attention(q, k, v, heads: int, causal: bool, rate: float, seeds, precision: str):
    """softmax(q k^T / sqrt(hd)) v per head on [B, T, D] inputs; with
    `seeds`, each weight dropped by its Philox bits and the kept ones
    scaled by 1 / (1 - rate)."""
    B, T, D = q.shape
    hd = D // heads

    def split(x):
        return x.reshape(B, T, heads, hd).transpose(1, 2)

    s = numerics.matmul(split(q) / math.sqrt(hd), split(k).transpose(-1, -2), precision)
    if causal:
        visible = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~visible, float("-inf"))
    p = torch.softmax(s, dim=-1)
    if seeds is not None and rate > 0.0:
        keep = numerics.keep_mask(seeds, heads, T, rate)
        p = torch.where(keep, p / (1.0 - rate), torch.zeros((), dtype=p.dtype, device=p.device))
    out = numerics.matmul(p, split(v), precision)
    return out.transpose(1, 2).reshape(B, T, D)


def self_attention(x, w: Weights, name: str, heads: int, causal: bool, rate: float,
                   draws: Optional[Draws], precision: str):
    qkv = numerics.linear(x, w[f"{name}.in_proj_weight"], w[f"{name}.in_proj_bias"], precision)
    q, k, v = qkv.chunk(3, dim=-1)
    seeds = draws.seeds(x.shape[0]) if draws is not None else None
    out = attention(q, k, v, heads, causal, rate, seeds, precision)
    return numerics.linear(out, w[f"{name}.out_proj.weight"], w[f"{name}.out_proj.bias"],
                           precision)


def memory_attention(x, memory, w: Weights, name: str, heads: int, rate: float,
                     draws: Optional[Draws], precision: str):
    """Cross-attention over the one memory token: its softmax weight is 1,
    so each query reads v(memory), through the weight's dropout in
    training."""
    B, T, D = x.shape
    wv = w[f"{name}.in_proj_weight"][2 * D:]
    bv = w[f"{name}.in_proj_bias"][2 * D:]
    v = numerics.linear(memory, wv, bv, precision)  # [B, 1, D]
    if draws is None or rate == 0.0:
        v = v.expand(B, T, D)
    else:
        weight = dropout(torch.ones((B, heads, T, 1), device=x.device), rate, draws)
        v = (weight * v.view(B, 1, heads, D // heads).transpose(1, 2)).transpose(1, 2)
        v = v.reshape(B, T, D)
    return numerics.linear(v, w[f"{name}.out_proj.weight"], w[f"{name}.out_proj.bias"],
                           precision)


def feed_forward(x, w: Weights, name: str, rate: float, draws, precision: str):
    h = gelu_tanh(numerics.linear(x, w[f"{name}.linear1.weight"], w[f"{name}.linear1.bias"],
                                  precision))
    h = dropout(h, rate, draws)
    return numerics.linear(h, w[f"{name}.linear2.weight"], w[f"{name}.linear2.bias"],
                           precision)


def to_seq(v):
    """[B, J, F, T] -> [B, T, J * F]."""
    B, J, Fe, T = v.shape
    return v.permute(0, 3, 1, 2).reshape(B, T, J * Fe)


def denoise(w: Weights, cfg: dict, x, t, cond: dict, draws: Optional[Draws] = None,
            precision: str = "float32"):
    """x0_hat [B, J, F, T] of x_t at timesteps t [B]. cond: 'cmotion' [B,
    J, F, T]; 'action' [B, 1] or 'text_emb' [B, 512]; optional 'uncond'
    [B] bool (the condition zeroed: classifier-free guidance). draws: the
    training forward's dropout draws (None: sampling)."""
    B, J, Fe, T = x.shape
    D, heads, rate = cfg["latent_dim"], cfg["num_heads"], cfg["dropout"]
    train_rate = rate if draws is not None else 0.0
    pe = numerics.sinusoidal(5000, D).to(x.device, x.dtype)

    emb = numerics.linear(pe[t], w["embed_timestep.time_embed.0.weight"],
                          w["embed_timestep.time_embed.0.bias"], precision)
    emb = numerics.linear(F.silu(emb), w["embed_timestep.time_embed.2.weight"],
                          w["embed_timestep.time_embed.2.bias"], precision)

    def masked(c):
        keep = torch.ones((B,), device=x.device)
        if draws is not None and cfg["cond_mask_prob"] > 0.0:
            keep = keep * (1.0 - (draws.rand((B,)) < cfg["cond_mask_prob"]).float())
        if cond.get("uncond") is not None:
            keep = keep * (1.0 - cond["uncond"].float())
        return c * keep[:, None]

    if cfg["cond_mode"] == "text":
        emb = emb + masked(numerics.linear(cond["text_emb"], w["embed_text.weight"],
                                           w["embed_text.bias"], precision))
    else:
        emb = emb + masked(w["embed_action.action_embedding"][cond["action"][:, 0].long()])

    xs = numerics.linear(to_seq(x), w["input_process.poseEmbedding.weight"],
                         w["input_process.poseEmbedding.bias"], precision)
    cm = numerics.linear(to_seq(cond["cmotion"]), w["cmo_process.poseEmbedding.weight"],
                         w["cmo_process.poseEmbedding.bias"], precision)
    xs = numerics.linear(torch.cat([xs, cm], dim=-1), w["fuse_process.weight"],
                         w["fuse_process.bias"], precision)
    memory = emb[:, None, :]
    if cfg["arch"] in DECODERS:
        h = dropout(xs + pe[:T], train_rate, draws)
        for i in range(cfg["layers"]):
            n = f"seqTransDecoder.layers.{i}"
            a = self_attention(h, w, f"{n}.self_attn", heads, True, train_rate, draws,
                               precision)
            h = layer_norm(h + dropout(a, train_rate, draws), w, f"{n}.norm1")
            a = memory_attention(h, memory, w, f"{n}.multihead_attn", heads, train_rate,
                                 draws, precision)
            h = layer_norm(h + dropout(a, train_rate, draws), w, f"{n}.norm2")
            a = feed_forward(h, w, n, train_rate, draws, precision)
            h = layer_norm(h + dropout(a, train_rate, draws), w, f"{n}.norm3")
    elif cfg["arch"] in ENCODERS:
        h = dropout(torch.cat([memory, xs], dim=1) + pe[:T + 1], train_rate, draws)
        for i in range(cfg["layers"]):
            n = f"seqTransEncoder.layers.{i}"
            a = self_attention(h, w, f"{n}.self_attn", heads, False, train_rate, draws,
                               precision)
            h = layer_norm(h + dropout(a, train_rate, draws), w, f"{n}.norm1")
            a = feed_forward(h, w, n, train_rate, draws, precision)
            h = layer_norm(h + dropout(a, train_rate, draws), w, f"{n}.norm2")
        h = h[:, 1:]
    else:
        raise ValueError(f"arch {cfg['arch']!r}")
    out = numerics.linear(h, w["output_process.poseFinal.weight"],
                          w["output_process.poseFinal.bias"], precision)
    return out.reshape(B, T, J, Fe).permute(0, 2, 3, 1)


def cfg_denoise(w: Weights, cfg: dict, x, t, cond: dict, scale: float,
                precision: str = "float32"):
    """Classifier-free guidance: uncond + scale * (cond - uncond)."""
    B = x.shape[0]
    both = {k: torch.cat([v, v]) for k, v in cond.items()}
    both["uncond"] = torch.cat([torch.zeros(B, dtype=torch.bool, device=x.device),
                                torch.ones(B, dtype=torch.bool, device=x.device)])
    out = denoise(w, cfg, torch.cat([x, x]), torch.cat([t, t]), both, None, precision)
    return out[B:] + scale * (out[:B] - out[B:])


# ---------------------------------------------------------------------------
# the CLIP ViT-B/32 text tower (OpenAI layout), float32
# ---------------------------------------------------------------------------

def clip_text(w: Weights, tokens: torch.Tensor, heads: int, layers: int,
              precision: str = "float32"):
    """CLIP.encode_text: token and position embeddings, pre-LN causal
    blocks with quick GELU, ln_final, the EOT token (the largest id)
    through text_projection."""
    B, T = tokens.shape
    x = w["token_embedding.weight"][tokens] + w["positional_embedding"][:T]
    D = x.shape[-1]
    hd = D // heads
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    for i in range(layers):
        n = f"transformer.resblocks.{i}"
        y = layer_norm(x, w, f"{n}.ln_1")
        qkv = numerics.linear(y, w[f"{n}.attn.in_proj_weight"], w[f"{n}.attn.in_proj_bias"],
                              precision)
        q, k, v = (z.reshape(B, T, heads, hd).transpose(1, 2) for z in qkv.chunk(3, dim=-1))
        s = numerics.matmul(q, k.transpose(-1, -2), precision) / math.sqrt(hd)
        s = s.masked_fill(~causal, float("-inf"))
        a = numerics.matmul(torch.softmax(s, dim=-1), v, precision)
        a = a.transpose(1, 2).reshape(B, T, D)
        x = x + numerics.linear(a, w[f"{n}.attn.out_proj.weight"],
                                w[f"{n}.attn.out_proj.bias"], precision)
        y = layer_norm(x, w, f"{n}.ln_2")
        y = numerics.linear(y, w[f"{n}.mlp.c_fc.weight"], w[f"{n}.mlp.c_fc.bias"], precision)
        y = y * torch.sigmoid(1.702 * y)
        x = x + numerics.linear(y, w[f"{n}.mlp.c_proj.weight"], w[f"{n}.mlp.c_proj.bias"],
                                precision)
    x = layer_norm(x, w, "ln_final")
    pooled = x[torch.arange(B, device=x.device), tokens.argmax(dim=-1)]
    return numerics.matmul(pooled, w["text_projection"], precision)
