"""The ACTOR conditional motion VAE, the generative baseline family
(counterpart of regennet_tpu/models/actor_cvae.py).

A class-conditional motion VAE: the transformer encoder reads the motion
behind learned per-action distribution tokens (mu and sigma queries), the
transformer decoder turns z plus a per-action bias into a motion through
queries of sinusoidal positions. `arch` recombines encoder and decoder
families as ACTOR does: 'transformer', 'fc', 'gru', 'grutrans' (gru
encoder, transformer decoder), 'transgru' and 'autotrans' (a transformer
encoder and a teacher-forced causal joeynmt decoder). `vae=False` is the
CAE: z is the encoder's mean, no reparameterisation.

Parameters carry the reference ACTOR torch names (`encoder.skelEmbedding`,
`encoder.muQuery`, `encoder.seqTransEncoder.layers.N.self_attn...`,
`decoder.actionBiases`, `decoder.finallayer`, `decoder.layers.N.trg_trg_att.q_layer`,
...), the layout regennet_tpu/convert/torch_ckpt.convert_actor_cvae reads.

The transformer families' self-attention goes through ops.attention as
the CMDM's does (models/transformer.py): B1 `fused_attention_btd`
non-causal when sampling, B2 `fused_attention_btd_train` in train mode; the
single-key cross-attention to the latent takes the out_proj(v_proj(z))
form. The autotrans layers (an explicit causal mask, cross-attention over
T keys) run plain attention, as the JAX package does. Train mode is a
`generator` given: it drives every dropout draw and, for the VAE, the
reparameterisation noise unless `eps` is handed in.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from regennet_torch.models import initializers
from regennet_torch.models import transformer as tfm
from regennet_torch.models.cmdm import _freeze_rz_grad

# the encoder and decoder family of each arch
ARCH_FAMILIES = {
    "transformer": ("transformer", "transformer"),
    "fc": ("fc", "fc"),
    "gru": ("gru", "gru"),
    "grutrans": ("gru", "transformer"),
    "transgru": ("transformer", "gru"),
    "autotrans": ("transformer", "autotrans"),
}


def _onehot(action, num_actions):
    return F.one_hot(action.long(), num_actions).float()


def _time_channel(B, T, device):
    """arange(T) / (T - 1) as [B, T, 1]: the time of each frame in [0, 1]."""
    t = torch.arange(T, dtype=torch.float32, device=device) / max(T - 1, 1)
    return t[None, :, None].expand(B, T, 1)


def _gru(in_features, latent_dim, num_layers):
    """A stacked GRU with flax's one bias per r and z gate: the r/z slices
    of each layer's bias_hh start at zero and take no gradient."""
    gru = nn.GRU(in_features, latent_dim, num_layers=num_layers, batch_first=True)
    with torch.no_grad():
        for i in range(num_layers):
            getattr(gru, f"bias_hh_l{i}")[: 2 * latent_dim] = 0
            getattr(gru, f"bias_hh_l{i}").register_hook(
                functools.partial(_freeze_rz_grad, latent_dim))
    return gru


def _positions(T, D, device):
    """The first T rows of the sinusoidal table [T, D]."""
    return tfm.sinusoidal_table(T, D).to(device)


def _seq(x):
    """[B, J, F, T] -> [B, T, J * F]."""
    B, J, Fe, T = x.shape
    return x.permute(0, 3, 1, 2).reshape(B, T, J * Fe)


def _motion(h, njoints, nfeats):
    """[B, T, J * F] -> [B, J, F, T]."""
    B, T = h.shape[:2]
    return h.reshape(B, T, njoints, nfeats).permute(0, 2, 3, 1)


class TransformerEncoder(nn.Module):
    def __init__(self, njoints, nfeats, num_actions, latent_dim, ff_size, num_layers,
                 num_heads, dropout):
        super().__init__()
        self.skelEmbedding = nn.Linear(njoints * nfeats, latent_dim)
        self.muQuery = nn.Parameter(0.02 * torch.randn(num_actions, latent_dim))
        self.sigmaQuery = nn.Parameter(0.02 * torch.randn(num_actions, latent_dim))
        self.seqTransEncoder = tfm.Encoder(num_layers, latent_dim, num_heads, ff_size,
                                           tfm.gelu_exact, dropout)

    def forward(self, x, action, generator=None):
        h = self.skelEmbedding(_seq(x))
        h = torch.cat([self.muQuery[action][:, None], self.sigmaQuery[action][:, None], h], 1)
        h = h + _positions(h.shape[1], h.shape[2], h.device)
        out = self.seqTransEncoder(h, generator)
        return out[:, 0], out[:, 1]


class FCEncoder(nn.Module):
    def __init__(self, njoints, nfeats, num_actions, latent_dim, num_frames):
        super().__init__()
        self.num_actions = num_actions
        self.fully_connected = nn.Sequential(
            nn.Linear(njoints * nfeats * num_frames + num_actions, 512), nn.GELU(),
            nn.Linear(512, 256), nn.GELU())
        self.mu = nn.Linear(256, latent_dim)
        self.var = nn.Linear(256, latent_dim)

    def forward(self, x, action, generator=None):
        h = torch.cat([x.reshape(x.shape[0], -1), _onehot(action, self.num_actions)], 1)
        h = self.fully_connected(h)
        return self.mu(h), self.var(h)


class GRUEncoder(nn.Module):
    def __init__(self, njoints, nfeats, num_actions, latent_dim, num_layers):
        super().__init__()
        self.num_actions = num_actions
        self.feats_embedding = nn.Linear(njoints * nfeats + num_actions + 1, latent_dim)
        self.gru = _gru(latent_dim, latent_dim, num_layers)
        self.mu = nn.Linear(latent_dim, latent_dim)
        self.var = nn.Linear(latent_dim, latent_dim)

    def forward(self, x, action, generator=None):
        seq = _seq(x)
        B, T = seq.shape[:2]
        onehot = _onehot(action, self.num_actions)[:, None].expand(B, T, self.num_actions)
        h = self.feats_embedding(torch.cat([seq, onehot, _time_channel(B, T, x.device)], 2))
        h = self.gru(h)[0][:, -1]  # the last frame (full-length windows)
        return self.mu(h), self.var(h)


class TransformerDecoder(nn.Module):
    def __init__(self, njoints, nfeats, num_actions, latent_dim, ff_size, num_layers,
                 num_heads, dropout):
        super().__init__()
        self.njoints, self.nfeats = njoints, nfeats
        self.actionBiases = nn.Parameter(0.02 * torch.randn(num_actions, latent_dim))
        self.seqTransDecoder = tfm.Decoder(num_layers, latent_dim, num_heads, ff_size,
                                           tfm.gelu_exact, dropout)
        self.finallayer = nn.Linear(latent_dim, njoints * nfeats)

    def forward(self, z, action, num_frames, generator=None, x_teacher=None):
        latent = z + self.actionBiases[action]
        B, D = latent.shape
        queries = _positions(num_frames, D, z.device).expand(B, -1, -1)
        out = self.seqTransDecoder(queries, latent[:, None], False, generator)
        return _motion(self.finallayer(out), self.njoints, self.nfeats)


class FCDecoder(nn.Module):
    def __init__(self, njoints, nfeats, num_actions, latent_dim, num_frames):
        super().__init__()
        self.shape = (njoints, nfeats, num_frames)
        self.num_actions = num_actions
        self.fully_connected = nn.Sequential(
            nn.Linear(latent_dim + num_actions, 256), nn.GELU(),
            nn.Linear(256, 512), nn.GELU(),
            nn.Linear(512, njoints * nfeats * num_frames), nn.GELU())

    def forward(self, z, action, num_frames, generator=None, x_teacher=None):
        h = self.fully_connected(torch.cat([z, _onehot(action, self.num_actions)], 1))
        return h.reshape(z.shape[0], *self.shape)


class GRUDecoder(nn.Module):
    def __init__(self, njoints, nfeats, num_actions, latent_dim, num_layers):
        super().__init__()
        self.njoints, self.nfeats, self.num_actions = njoints, nfeats, num_actions
        self.feats_embedding = nn.Linear(latent_dim + num_actions + 1, latent_dim)
        self.gru = _gru(latent_dim, latent_dim, num_layers)
        self.final_layer = nn.Linear(latent_dim, njoints * nfeats)

    def forward(self, z, action, num_frames, generator=None, x_teacher=None):
        B, T = z.shape[0], num_frames
        h = torch.cat([z, _onehot(action, self.num_actions)], 1)[:, None].expand(B, T, -1)
        h = self.feats_embedding(torch.cat([h, _time_channel(B, T, z.device)], 2))
        return _motion(self.final_layer(self.gru(h)[0]), self.njoints, self.nfeats)


class JoeynmtAttention(nn.Module):
    """joeynmt's multi-head attention: separate q, k, v and output linears,
    the scores divided by sqrt(head dim), an optional additive mask,
    dropout on the weights; plain PyTorch."""

    def __init__(self, num_heads, latent_dim, dropout):
        super().__init__()
        self.num_heads, self.dropout = num_heads, dropout
        self.q_layer = nn.Linear(latent_dim, latent_dim)
        self.k_layer = nn.Linear(latent_dim, latent_dim)
        self.v_layer = nn.Linear(latent_dim, latent_dim)
        self.output_layer = nn.Linear(latent_dim, latent_dim)

    def forward(self, q_in, kv_in, mask=None, generator=None):
        B, Tq, D = q_in.shape
        H = self.num_heads
        hd = D // H

        def heads(t):
            return t.reshape(B, t.shape[1], H, hd).transpose(1, 2)

        q, k, v = heads(self.q_layer(q_in)), heads(self.k_layer(kv_in)), heads(self.v_layer(kv_in))
        scores = q @ k.transpose(-1, -2) / math.sqrt(hd)
        if mask is not None:
            scores = scores + mask
        weights = tfm.dropout(torch.softmax(scores, dim=-1), self.dropout, generator)
        return self.output_layer((weights @ v).transpose(1, 2).reshape(B, Tq, D))


class PositionwiseFeedForward(nn.Module):
    """LayerNorm (eps 1e-6), Linear, ReLU, dropout, Linear, dropout, plus
    the residual."""

    def __init__(self, latent_dim, ff_size, dropout):
        super().__init__()
        self.dropout = dropout
        self.layer_norm = nn.LayerNorm(latent_dim, eps=1e-6)
        self.pwff_layer = nn.Sequential(nn.Linear(latent_dim, ff_size), nn.ReLU(),
                                        nn.Dropout(dropout), nn.Linear(ff_size, latent_dim),
                                        nn.Dropout(dropout))

    def forward(self, x, generator=None):
        lin1, _, _, lin2, _ = self.pwff_layer
        h = tfm.dropout(F.relu(lin1(self.layer_norm(x))), self.dropout, generator)
        return tfm.dropout(lin2(h), self.dropout, generator) + x


class JoeynmtDecoderLayer(nn.Module):
    """joeynmt's pre-norm transformer decoder layer (LayerNorms at eps 1e-6):
        h1  = dropout(self_attn(LN(x))) + x
        h2  = cross_attn(q=LN(h1), k=v=memory)
        out = FF(dropout(h2) + h1)"""

    def __init__(self, num_heads, latent_dim, ff_size, dropout):
        super().__init__()
        self.dropout = dropout
        self.x_layer_norm = nn.LayerNorm(latent_dim, eps=1e-6)
        self.trg_trg_att = JoeynmtAttention(num_heads, latent_dim, dropout)
        self.dec_layer_norm = nn.LayerNorm(latent_dim, eps=1e-6)
        self.src_trg_att = JoeynmtAttention(num_heads, latent_dim, dropout)
        self.feed_forward = PositionwiseFeedForward(latent_dim, ff_size, dropout)

    def forward(self, x, memory, tgt_mask=None, generator=None):
        xn = self.x_layer_norm(x)
        h1 = tfm.dropout(self.trg_trg_att(xn, xn, tgt_mask, generator), self.dropout,
                         generator) + x
        h2 = self.src_trg_att(self.dec_layer_norm(h1), memory, None, generator)
        return self.feed_forward(tfm.dropout(h2, self.dropout, generator) + h1, generator)


def causal_mask(T: int, device=None) -> torch.Tensor:
    """Additive [T, T] mask: 0 on and below the diagonal, -inf above."""
    i = torch.arange(T, device=device)
    return torch.where(i[None, :] <= i[:, None], 0.0, float("-inf"))


class AutotransDecoder(nn.Module):
    """z (with the class one-hot and the time channel) embedded per frame as
    the memory; the one-frame-shifted motion (zeros first) embedded as the
    target, through causal joeynmt layers; teacher-forced."""

    def __init__(self, njoints, nfeats, num_actions, latent_dim, ff_size, num_layers,
                 num_heads, dropout):
        super().__init__()
        self.njoints, self.nfeats, self.num_actions = njoints, nfeats, num_actions
        self.dropout = dropout
        self.embedding = nn.Linear(latent_dim + num_actions + 1, latent_dim)
        self.embedding_x = nn.Linear(njoints * nfeats + num_actions + 1, latent_dim)
        self.layers = nn.ModuleList(JoeynmtDecoderLayer(num_heads, latent_dim, ff_size, dropout)
                                    for _ in range(num_layers))
        self.layer_norm = nn.LayerNorm(latent_dim, eps=1e-6)
        self.output_layer = nn.Linear(latent_dim, njoints * nfeats, bias=False)

    def forward(self, z, action, num_frames, generator=None, x_teacher=None):
        B, T, D = z.shape[0], num_frames, z.shape[1]
        onehot = _onehot(action, self.num_actions)[:, None].expand(B, T, self.num_actions)
        time_ch = _time_channel(B, T, z.device)
        src = self.embedding(torch.cat([z[:, None].expand(B, T, D), onehot, time_ch], 2))
        feats = self.njoints * self.nfeats
        shifted = torch.zeros(B, T, feats, device=z.device)
        if x_teacher is not None:
            shifted[:, 1:] = _seq(x_teacher)[:, :-1]
        tgt = self.embedding_x(torch.cat([shifted, onehot, time_ch], 2))
        tgt = tgt + _positions(T, D, z.device)
        out = tfm.dropout(tgt, self.dropout, generator)
        mask = causal_mask(T, z.device)
        for layer in self.layers:
            out = layer(out, src, mask, generator)
        return _motion(self.output_layer(self.layer_norm(out)), self.njoints, self.nfeats)


class ActorCVAE(nn.Module):
    """arch picks the encoder and decoder families (ARCH_FAMILIES); fc and
    gru take fixed-length windows of num_frames."""

    def __init__(self, njoints: int, nfeats: int, num_actions: int, latent_dim: int = 256,
                 ff_size: int = 1024, num_layers: int = 4, num_heads: int = 4,
                 dropout: float = 0.1, arch: str = "transformer", num_frames: int = 60,
                 num_gru_layers: int = 4, vae: bool = True):
        super().__init__()
        self.njoints, self.nfeats, self.num_actions = njoints, nfeats, num_actions
        self.latent_dim, self.arch, self.vae = latent_dim, arch, vae
        self.enc_arch, self.dec_arch = ARCH_FAMILIES[arch]
        trans = (njoints, nfeats, num_actions, latent_dim, ff_size, num_layers, num_heads,
                 dropout)
        self.encoder = {
            "transformer": lambda: TransformerEncoder(*trans),
            "fc": lambda: FCEncoder(njoints, nfeats, num_actions, latent_dim, num_frames),
            "gru": lambda: GRUEncoder(njoints, nfeats, num_actions, latent_dim, num_gru_layers),
        }[self.enc_arch]()
        self.decoder = {
            "transformer": lambda: TransformerDecoder(*trans),
            "fc": lambda: FCDecoder(njoints, nfeats, num_actions, latent_dim, num_frames),
            "gru": lambda: GRUDecoder(njoints, nfeats, num_actions, latent_dim, num_gru_layers),
            "autotrans": lambda: AutotransDecoder(*trans),
        }[self.dec_arch]()

    def encode(self, x, action, generator: Optional[torch.Generator] = None):
        """x [B, J, F, T], action [B] -> (mu, logvar) [B, D]."""
        return self.encoder(x, action, generator)

    def decode(self, z, action, num_frames: int, generator: Optional[torch.Generator] = None,
               x_teacher=None):
        """z [B, D], action [B] -> [B, J, F, num_frames]; x_teacher [B, J, F,
        T] teacher-forces the autotrans decoder (the others ignore it)."""
        return self.decoder(z, action, num_frames, generator, x_teacher)

    def forward(self, x, action, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """{'output', 'mu', 'logvar', 'z'}. z is mu + exp(logvar / 2) eps for
        the VAE when eps is given or drawn (train mode), else mu."""
        mu, logvar = self.encode(x, action, generator)
        if self.vae and eps is None and generator is not None:
            eps = torch.randn(mu.shape, generator=generator, device=mu.device)
        z = mu if not self.vae or eps is None else mu + torch.exp(0.5 * logvar) * eps
        x_hat = self.decode(z, action, x.shape[-1], generator, x_teacher=x)
        return {"output": x_hat, "mu": mu, "logvar": logvar, "z": z}

    @torch.no_grad()
    def generate(self, action, num_frames: int, generator: Optional[torch.Generator] = None,
                 z: Optional[torch.Tensor] = None):
        """Motions [B, J, F, num_frames] of the classes `action` [B] from z
        [B, D] (drawn from N(0, I) by generator when None)."""
        if z is None:
            z = torch.randn((action.shape[0], self.latent_dim), generator=generator,
                            device=action.device)
        if self.dec_arch == "autotrans":
            return self.generate_autoregressive(z, action, num_frames)
        return self.decode(z, action, num_frames)

    @torch.no_grad()
    def generate_autoregressive(self, z, action, num_frames: int):
        """Frame by frame: each step decodes the prefix generated so far
        (causal: later frames do not reach frame i) and keeps frame i."""
        x_buf = torch.zeros(z.shape[0], self.njoints, self.nfeats, num_frames,
                            device=z.device)
        for i in range(num_frames):
            x_buf[..., i] = self.decode(z, action, num_frames, x_teacher=x_buf)[..., i]
        return x_buf


def random_init_(model: ActorCVAE, generator: torch.Generator) -> ActorCVAE:
    """Draw a fresh CVAE from `generator` as the JAX package's Flax
    ActorCVAE is drawn (models/initializers): lecun-normal kernels, zero
    biases, orthogonal GRU gates, the mu and sigma queries and the action
    biases from normal(0.02)."""
    return initializers.init_params_(
        model, generator, {"muQuery": 0.02, "sigmaQuery": 0.02, "actionBiases": 0.02})


def cvae_losses(out: Dict, x: torch.Tensor, mask=None,
                lambda_kl: float = 1e-5) -> Dict[str, torch.Tensor]:
    """Reconstruction (masked MSE over frames) plus KL toward N(0, I)."""
    diff = (out["output"] - x) ** 2
    if mask is not None:
        m = mask.to(diff.dtype)
        rec = torch.sum(diff * m) / torch.clamp(torch.sum(m) * x.shape[1] * x.shape[2],
                                                min=1.0)
    else:
        rec = torch.mean(diff)
    kl = -0.5 * torch.mean(1 + out["logvar"] - out["mu"] ** 2 - torch.exp(out["logvar"]))
    return {"rec": rec, "kl": kl, "loss": rec + lambda_kl * kl}
