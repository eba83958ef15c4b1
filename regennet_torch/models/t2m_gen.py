"""The comp_v6 text-to-motion generator (Guo et al.), in PyTorch (the port's
counterpart of regennet_tpu/models/t2m_gen.py; reference:
data_loaders/humanml/networks/modules.py:62-309 and trainers.py
CompTrainerV6).

A snippet-autoregressive text-to-motion VAE: a BiGRU text encoder gives
per-word hiddens, a scalar attention over them conditions each step,
prior and posterior GRU cells emit a latent per snippet of `unit_length`
frames with a time-to-arrival positional code, a GRU decoder predicts the
next movement snippet, and the movement decoder maps the snippets back to
pose features. The movement encoder (from train_t2m_eval's decomp stage)
stays outside the generator: the caller passes its encodings.

Module names are the reference's, so a released CompTrainerV6 `latest.tar`
({"text_enc", "seq_pri", "seq_post", "seq_dec", "att_layer", "mov_enc",
"mov_dec"}) loads as it is (`load_comp_v6`, which drops only the
positional tables' `.pe` buffers), and regennet_tpu/convert/torch_ckpt's
convert_comp_v6 reads the port's state dicts.

Kept as the JAX package has them:
- the backward text stream is flipped within each caption's length and
  zeroed past it, as the reference's pad_packed_sequence and per-row flip
  give it;
- the attention runs over the first max(cap_lens) word positions of the
  batch: the zero hiddens between a row's length and that maximum take
  part at logit 0 with W_v's bias as value;
- the time-to-arrival index is clipped at 0 (where the reference wraps
  negative indices into the positional table);
- every layer of the prior and posterior cells reads the same embedded
  input (a reference quirk); the decoder cell chains its layers;
- the GRU cells' r and z hidden biases are held still in training, so Adam
  follows flax's one bias per gate (models/cmdm._freeze_rz_grad);
- the leaky ReLUs take flax's derivative of 1 at 0 (t2m_eval.LeakyReLU).
The reparameterisation noise is an argument (`eps_pri`, `eps_post`, each
[mov_len, B, dim_z]; None means z = mu), so the caller owns the stream.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from regennet_torch.models.cmdm import _freeze_rz_grad
from regennet_torch.models.t2m_eval import LeakyReLU, MovementConvDecoder, _BiGRU
from regennet_torch.models.transformer import sinusoidal_table

T2M_GEN_OPT = dict(
    dim_word=300, dim_pos_ohot=15, dim_text_hidden=512, dim_att_vec=512,
    dim_z=128, dim_pri_hidden=1024, dim_pos_hidden=1024, dim_dec_hidden=1024,
    n_layers_pri=1, n_layers_pos=1, n_layers_dec=1, dim_movement_latent=512,
    unit_length=4,
)
# the CompTrainerV6.save networks, in its order
NETWORKS = ("text_enc", "seq_pri", "seq_post", "seq_dec", "att_layer", "mov_enc", "mov_dec")


class TextEncoderBiGRU(_BiGRU):
    """word + POS inputs -> per-word BiGRU hiddens [B, L, 2H] and the two
    directions' final states [B, 2H]."""

    def __init__(self, word_size: int = 300, pos_size: int = 15, hidden_size: int = 512):
        super().__init__(word_size, hidden_size)
        self.pos_emb = nn.Linear(pos_size, word_size)

    def forward(self, word_embs, pos_onehot, cap_lens):
        B, L = word_embs.shape[:2]
        lengths = torch.as_tensor(cap_lens).to("cpu", torch.int64)
        x = self.input_emb(word_embs + self.pos_emb(pos_onehot))
        packed = pack_padded_sequence(x, lengths, batch_first=True, enforce_sorted=False)
        h0 = self.hidden.expand(-1, B, -1).contiguous()
        seq, last = self.gru(packed, h0)
        seq = pad_packed_sequence(seq, batch_first=True, total_length=L)[0]  # zero past len
        H = self.gru.hidden_size
        # output position i carries the backward hidden of position len-1-i
        idx = torch.arange(L)[None, :]
        flip = torch.where(idx < lengths[:, None], lengths[:, None] - 1 - idx, idx)
        backward = torch.gather(seq[..., H:], 1, flip.to(x.device)[..., None].expand(B, L, H))
        return torch.cat([seq[..., :H], backward], dim=-1), torch.cat([last[0], last[1]], -1)


class AttLayer(nn.Module):
    """Scalar dot attention of a query over every position of `key_mat`."""

    def __init__(self, query_dim: int, key_dim: int, value_dim: int):
        super().__init__()
        self.W_q = nn.Linear(query_dim, value_dim)
        self.W_k = nn.Linear(key_dim, value_dim, bias=False)
        self.W_v = nn.Linear(key_dim, value_dim)
        self.dim = value_dim

    def forward(self, query, key_mat):
        """query [B, Q], key_mat [B, L, K] -> (attended values [B, V],
        weights [B, L, 1])."""
        q, k, v = self.W_q(query), self.W_k(key_mat), self.W_v(key_mat)
        weights = torch.einsum("blv,bv->bl", k, q) / math.sqrt(self.dim)
        co = torch.softmax(weights, dim=1)[..., None]
        return (v * co).sum(1), co


def _emb(input_size: int, hidden_size: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(input_size, hidden_size), nn.LayerNorm(hidden_size),
                         LeakyReLU(0.2))


class _SeqCell(nn.Module):
    """The prior/posterior/decoder cells' common part: z2init from the text
    state, the input embedding, the stacked GRUCells and the time-to-arrival
    code."""

    def __init__(self, text_size: int, input_size: int, hidden_size: int, n_layers: int):
        super().__init__()
        self.hidden_size, self.n_layers = hidden_size, n_layers
        self.emb = _emb(input_size, hidden_size)
        self.z2init = nn.Linear(text_size, hidden_size * n_layers)
        self.gru = nn.ModuleList([nn.GRUCell(hidden_size, hidden_size)
                                  for _ in range(n_layers)])
        for cell in self.gru:
            cell.bias_hh.register_hook(functools.partial(_freeze_rz_grad, hidden_size))
        self.register_buffer("pos_table", sinusoidal_table(5000, hidden_size),
                             persistent=False)

    def get_init_hidden(self, latent) -> List[torch.Tensor]:
        return list(torch.split(self.z2init(latent), self.hidden_size, dim=-1))

    def embed(self, inputs, tta):
        """The embedded input plus the code of tta (clipped at 0)."""
        tta = torch.as_tensor(tta, device=inputs.device).clamp_min(0)
        return self.emb(inputs) + self.pos_table[tta]


class TextDecoderCell(_SeqCell):
    """The prior/posterior cell: emb -> stacked GRUCells -> z, mu, logvar."""

    def __init__(self, text_size: int, input_size: int, output_size: int = 128,
                 hidden_size: int = 1024, n_layers: int = 1):
        super().__init__(text_size, input_size, hidden_size, n_layers)
        self.mu_net = nn.Linear(hidden_size, output_size)
        self.logvar_net = nn.Linear(hidden_size, output_size)

    def forward(self, inputs, hidden, tta, eps: Optional[torch.Tensor]):
        x = self.embed(inputs, tta)
        # every layer reads the same x (the reference's loop never rebinds it)
        hidden = [cell(x, h) for cell, h in zip(self.gru, hidden)]
        mu, logvar = self.mu_net(hidden[-1]), self.logvar_net(hidden[-1])
        z = mu if eps is None else mu + torch.exp(0.5 * logvar) * eps
        return z, mu, logvar, hidden


class TextVAEDecoderCell(_SeqCell):
    """The snippet decoder cell: emb -> chained GRUCells -> output MLP."""

    def __init__(self, text_size: int, input_size: int, output_size: int = 512,
                 hidden_size: int = 1024, n_layers: int = 1):
        super().__init__(text_size, input_size, hidden_size, n_layers)
        self.output = nn.Sequential(nn.Linear(hidden_size, hidden_size),
                                    nn.LayerNorm(hidden_size), LeakyReLU(0.2),
                                    nn.Linear(hidden_size, output_size))

    def forward(self, inputs, hidden, tta):
        x = self.embed(inputs, tta)
        new_hidden = []
        for cell, h in zip(self.gru, hidden):
            x = cell(x, h)
            new_hidden.append(x)
        return self.output(x), new_hidden


class CompV6Generator(nn.Module):
    """CompTrainerV6's network set without the frozen movement encoder.

    `forward` is the training forward (posterior latents, teacher forcing
    or not); `generate` samples from the prior. Both take movement-space
    tensors: `movements` [B, M, mov_latent] (the targets, training only)
    and `mov_in0` [B, mov_latent] (the encoded zero snippet, the start
    token). Outputs: fake_motions [B, M * unit, dim_pose], fake_movements
    [B, M, mov_latent], and mus/logvars of the prior (and posterior),
    each [M * B, dim_z], snippet-major."""

    def __init__(self, dim_pose: int = 263, dim_word: int = 300, dim_pos_ohot: int = 15,
                 text_hidden: int = 512, att_vec: int = 512, dim_z: int = 128,
                 pri_hidden: int = 1024, dec_hidden: int = 1024, n_layers: int = 1,
                 mov_latent: int = 512):
        super().__init__()
        th2 = 2 * text_hidden
        self.dim_z = dim_z
        self.text_enc = TextEncoderBiGRU(dim_word, dim_pos_ohot, text_hidden)
        self.att_layer = AttLayer(dec_hidden, th2, att_vec)
        self.seq_pri = TextDecoderCell(th2, mov_latent + att_vec, dim_z, pri_hidden, n_layers)
        self.seq_post = TextDecoderCell(th2, 2 * mov_latent + att_vec, dim_z, pri_hidden,
                                        n_layers)
        self.seq_dec = TextVAEDecoderCell(th2, mov_latent + att_vec + dim_z, mov_latent,
                                          dec_hidden, n_layers)
        self.mov_dec = MovementConvDecoder(mov_latent, mov_latent, dim_pose)

    def _loop(self, word_embs, pos_ohot, cap_lens, m_lens, mov_in0, mov_len: int,
              unit_length: int, eps_pri=None, eps_post=None, movements=None,
              teacher_force: bool = False) -> Dict[str, torch.Tensor]:
        word_hids, hidden = self.text_enc(word_embs, pos_ohot, cap_lens)
        word_hids = word_hids[:, :int(torch.as_tensor(cap_lens).max())]  # the attention's span
        posterior = movements is not None
        h_pri = self.seq_pri.get_init_hidden(hidden)
        h_dec = self.seq_dec.get_init_hidden(hidden)
        h_post = self.seq_post.get_init_hidden(hidden) if posterior else None
        m_units = torch.as_tensor(m_lens, device=mov_in0.device) // unit_length
        mov_in = mov_in0
        out = {k: [] for k in ("mus_pri", "logvars_pri", "mus_post", "logvars_post", "fakes")}
        for i in range(mov_len):
            att_vec, _ = self.att_layer(h_dec[-1], word_hids)
            tta = m_units - i
            z, mu, logvar, h_pri = self.seq_pri(
                torch.cat([mov_in, att_vec], -1), h_pri, tta,
                None if eps_pri is None else eps_pri[i])
            out["mus_pri"].append(mu)
            out["logvars_pri"].append(logvar)
            if posterior:
                z, mu, logvar, h_post = self.seq_post(
                    torch.cat([mov_in, movements[:, i], att_vec], -1), h_post, tta,
                    None if eps_post is None else eps_post[i])
                out["mus_post"].append(mu)
                out["logvars_post"].append(logvar)
            fake_mov, h_dec = self.seq_dec(torch.cat([mov_in, att_vec, z], -1), h_dec, tta)
            out["fakes"].append(fake_mov)
            mov_in = (movements[:, i] if posterior and teacher_force else fake_mov).detach()
        fake_movements = torch.stack(out.pop("fakes"), dim=1)
        result = {"fake_motions": self.mov_dec(fake_movements),
                  "fake_movements": fake_movements}
        result.update({k: torch.cat(v, 0) for k, v in out.items() if v})
        return result

    def forward(self, word_embs, pos_ohot, cap_lens, movements, m_lens, mov_in0,
                teacher_force: bool, eps_pri=None, eps_post=None, unit_length: int = 4):
        """The training forward: the posterior's latents drive the decoder;
        teacher_force feeds the ground-truth snippet as the next input,
        else the predicted one (detached either way)."""
        return self._loop(word_embs, pos_ohot, cap_lens, m_lens, mov_in0, movements.shape[1],
                          unit_length, eps_pri, eps_post, movements, bool(teacher_force))

    def generate(self, word_embs, pos_ohot, cap_lens, m_lens, mov_in0, mov_len: int,
                 eps_pri=None, unit_length: int = 4):
        """Prior sampling over mov_len snippets."""
        return self._loop(word_embs, pos_ohot, cap_lens, m_lens, mov_in0, mov_len,
                          unit_length, eps_pri)


def prior_noise(generator: torch.Generator, mov_len: int, B: int, dim_z: int, device):
    """The sampling CLIs' eps_pri [mov_len, B, dim_z], drawn from `generator`."""
    return torch.randn((mov_len, B, dim_z), generator=generator, device=device)


def training_noise(generator: torch.Generator, mov_len: int, B: int, dim_z: int, device):
    """The trainer's (eps_pri, eps_post), each [mov_len, B, dim_z], drawn
    from `generator` in that order."""
    return tuple(torch.randn((mov_len, B, dim_z), generator=generator, device=device)
                 for _ in range(2))


def smooth_l1(pred, target):
    """torch SmoothL1Loss (beta 1), the mean."""
    return F.smooth_l1_loss(pred, target)


def kl_criterion(mu1, logvar1, mu2, logvar2):
    """KL(N(mu1, var1) || N(mu2, var2)), summed, over mu1's rows (M * B)."""
    kld = (0.5 * (logvar2 - logvar1)
           + (torch.exp(logvar1) + (mu1 - mu2) ** 2) / (2 * torch.exp(logvar2)) - 0.5)
    return kld.sum() / mu1.shape[0]


def comp_v6_losses(out: Dict, motions, movements, lambda_rec_mov=1.0, lambda_rec_mot=1.0,
                   lambda_kld=0.005) -> Dict[str, torch.Tensor]:
    """The reference's backward_G, its swap of the two reconstruction
    lambdas kept (motion term x lambda_rec_mov, movement term x
    lambda_rec_mot)."""
    loss_mot_rec = smooth_l1(out["fake_motions"], motions)
    loss_mov_rec = smooth_l1(out["fake_movements"], movements)
    loss_kld = kl_criterion(out["mus_post"], out["logvars_post"], out["mus_pri"],
                            out["logvars_pri"])
    loss = loss_mot_rec * lambda_rec_mov + loss_mov_rec * lambda_rec_mot + loss_kld * lambda_kld
    return {"loss_gen": loss, "loss_mot_rec": loss_mot_rec, "loss_mov_rec": loss_mov_rec,
            "loss_kld": loss_kld}


def networks(gen: CompV6Generator, mov_enc: Optional[nn.Module]) -> Dict[str, nn.Module]:
    """The networks of the released layout by name: all seven, or the
    generator's six when mov_enc is None."""
    nets = {name: getattr(gen, name) for name in NETWORKS if name != "mov_enc"}
    if mov_enc is not None:
        nets["mov_enc"] = mov_enc
    return nets


def generator_state(gen: CompV6Generator, mov_enc: nn.Module) -> Dict[str, Dict]:
    """The seven state dicts of CompTrainerV6.save, on the CPU."""
    return {name: {k: v.detach().cpu() for k, v in net.state_dict().items()}
            for name, net in networks(gen, mov_enc).items()}


def load_comp_v6(gen: CompV6Generator, mov_enc: Optional[nn.Module], state: Mapping) -> None:
    """Load a released-layout state (a CompTrainerV6 latest.tar or the port's
    train_t2m_gen .pt) strictly, the positional tables' `.pe` buffers
    dropped; mov_enc None leaves the movement encoder out."""
    for name, net in networks(gen, mov_enc).items():
        sd = {k: v if torch.is_tensor(v) else torch.tensor(np.asarray(v))
              for k, v in state[name].items() if not (k == "pe" or k.endswith(".pe"))}
        net.load_state_dict(sd)
