"""Text-to-motion matching evaluators (Guo et al. "t2m"; the port's copy of
regennet_tpu/models/t2m_eval.py; reference:
data_loaders/humanml/networks/modules.py and evaluator_wrapper.py).

A strided-conv movement encoder, a BiGRU text tower over GloVe and
part-of-speech inputs, and a BiGRU motion tower over the movement latents
project text and motion into one space, where R-precision, the matching
score and FID are read. The length estimator maps a prompt's word inputs
to logits over motion-length bins of `unit_length` frames.

Parameter names are the reference torch modules', so a released
`finest.tar` ({"movement_encoder", "text_encoder", "motion_encoder"}) and
a released length estimator ({"estimator": ...}) load as they are, and
regennet_tpu/convert/torch_ckpt reads the port's state dicts. The movement
encoder's Dropout slots (`main.1`, `main.4`) hold identities: the JAX
package trains without them, and evaluation runs without them.

The leaky ReLUs and the trainer's L1 terms (`jax_abs`) take JAX's
derivative at 0 (1, where torch's LeakyReLU gives its slope and
torch.abs 0): zero-padded frames through zero biases (the JAX init) meet
exact zeros, and the JAX trainer's gradient is the one to follow.

Each tower takes every sequence's last state at its own length: the
sequences are packed (`enforce_sorted=False`) and the final states come
back in batch order, as flax's `seq_lengths` gives them. The GRUs' r and z
hidden biases are held still in training, as the CMDM's GRU trunk holds
them (models/cmdm._freeze_rz_grad), so Adam follows flax's one bias per
gate.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence

from regennet_torch.models import initializers
from regennet_torch.models.cmdm import _freeze_rz_grad

T2M_OPT = dict(
    dim_word=300, dim_pos_ohot=15, dim_text_hidden=512, dim_coemb_hidden=512,
    dim_motion_hidden=1024, dim_movement_enc_hidden=512,
    dim_movement_latent=512, unit_length=4, max_text_len=20,
)
FOOT_FEATS = 4  # trailing foot-contact features, left out of the movement encoder


class LeakyReLU(nn.Module):
    """x if x >= 0 else slope * x, with flax's gradient of 1 at 0."""

    def __init__(self, slope: float = 0.2):
        super().__init__()
        self.slope = slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.slope * x)


def jax_abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with jnp.abs's gradient: +1 at 0."""
    return torch.where(x >= 0, x, -x)


def dim_pose(dataset_name: str) -> int:
    return 263 if dataset_name == "humanml" else 251


class MovementConvEncoder(nn.Module):
    """Two stride-2 convolutions over time (a unit of 4 frames) and a linear."""

    def __init__(self, input_size: int = 259, hidden_size: int = 512,
                 output_size: int = 512):
        super().__init__()
        self.main = nn.Sequential(
            nn.Conv1d(input_size, hidden_size, 4, 2, 1), nn.Identity(),
            LeakyReLU(0.2), nn.Conv1d(hidden_size, output_size, 4, 2, 1),
            nn.Identity(), LeakyReLU(0.2))
        self.out_net = nn.Linear(output_size, output_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, F] -> [B, T/4, out]
        return self.out_net(self.main(x.transpose(1, 2)).transpose(1, 2))


class MovementConvDecoder(nn.Module):
    """Two stride-2 transposed convolutions and a linear, inverting the encoder."""

    def __init__(self, input_size: int = 512, hidden_size: int = 512,
                 output_size: int = 263):
        super().__init__()
        self.main = nn.Sequential(
            nn.ConvTranspose1d(input_size, hidden_size, 4, 2, 1), LeakyReLU(0.2),
            nn.ConvTranspose1d(hidden_size, output_size, 4, 2, 1), LeakyReLU(0.2))
        self.out_net = nn.Linear(output_size, output_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, T/4, in] -> [B, T, out]
        return self.out_net(self.main(x.transpose(1, 2)).transpose(1, 2))


def contrastive_loss(x, y, label, margin: float = 10.0) -> torch.Tensor:
    """Hadsell-Chopra-LeCun contrastive loss: label 0 pulls a pair together
    (d^2), label 1 pushes it past the margin (max(0, margin - d)^2)."""
    d = torch.sqrt(torch.sum((x - y) ** 2, dim=-1) + 1e-12)
    label = torch.as_tensor(label, dtype=d.dtype, device=d.device)
    return torch.mean((1 - label) * d ** 2 + label * torch.clamp(margin - d, min=0.0) ** 2)


class _BiGRU(nn.Module):
    """input_emb, a bidirectional GRU from the learned initial state
    `hidden`, and the two directions' final states concatenated."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.input_emb = nn.Linear(input_size, hidden_size)
        self.gru = nn.GRU(hidden_size, hidden_size, batch_first=True, bidirectional=True)
        self.hidden = nn.Parameter(torch.randn(2, 1, hidden_size))
        for name in ("bias_hh_l0", "bias_hh_l0_reverse"):
            getattr(self.gru, name).register_hook(
                functools.partial(_freeze_rz_grad, hidden_size))

    def final_states(self, x: torch.Tensor, lengths) -> torch.Tensor:
        """x [B, T, input_size], lengths [B] (each in [1, T]) -> [B, 2H]."""
        lengths = torch.as_tensor(lengths).to("cpu", torch.int64)
        packed = pack_padded_sequence(self.input_emb(x), lengths, batch_first=True,
                                      enforce_sorted=False)
        h0 = self.hidden.expand(-1, x.shape[0], -1).contiguous()
        _, last = self.gru(packed, h0)  # [2, B, H], batch order kept
        return torch.cat([last[0], last[1]], dim=-1)


def _head(hidden_size: int, output_size: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(2 * hidden_size, hidden_size), nn.LayerNorm(hidden_size),
                         LeakyReLU(0.2), nn.Linear(hidden_size, output_size))


class TextEncoderBiGRUCo(_BiGRU):
    def __init__(self, word_size: int = 300, pos_size: int = 15, hidden_size: int = 512,
                 output_size: int = 512):
        super().__init__(word_size, hidden_size)
        self.pos_emb = nn.Linear(pos_size, word_size)
        self.output_net = _head(hidden_size, output_size)

    def forward(self, word_embs, pos_onehot, cap_lens) -> torch.Tensor:
        return self.output_net(self.final_states(word_embs + self.pos_emb(pos_onehot),
                                                 cap_lens))


class MotionEncoderBiGRUCo(_BiGRU):
    def __init__(self, input_size: int = 512, hidden_size: int = 1024,
                 output_size: int = 512):
        super().__init__(input_size, hidden_size)
        self.output_net = _head(hidden_size, output_size)

    def forward(self, movements, m_lens) -> torch.Tensor:
        return self.output_net(self.final_states(movements, m_lens))


class MotionLenEstimatorBiGRU(_BiGRU):
    """Text -> logits over motion-length bins: the word and POS inputs
    through a BiGRU, then a 512 -> 256 -> 128 LayerNorm/LeakyReLU head."""

    def __init__(self, word_size: int = 300, pos_size: int = 15, hidden_size: int = 512,
                 output_size: int = 50):
        super().__init__(word_size, hidden_size)
        self.pos_emb = nn.Linear(pos_size, word_size)
        nd = 512
        layers = []
        for width_in, width in ((2 * hidden_size, nd), (nd, nd // 2), (nd // 2, nd // 4)):
            layers += [nn.Linear(width_in, width), nn.LayerNorm(width), LeakyReLU(0.2)]
        self.output = nn.Sequential(*layers, nn.Linear(nd // 4, output_size))

    def forward(self, word_embs, pos_onehot, cap_lens) -> torch.Tensor:
        return self.output(self.final_states(word_embs + self.pos_emb(pos_onehot), cap_lens))


def networks(dim_pose: int, *names: str, length_bins: int = 50):
    """The named networks at T2M_OPT's widths, as read when called:
    "movement_enc", "movement_dec", "text_encoder", "motion_encoder", and
    "estimator" (the length estimator over `length_bins` bins)."""
    opt = T2M_OPT
    build = {
        "movement_enc": lambda: MovementConvEncoder(
            dim_pose - FOOT_FEATS, opt["dim_movement_enc_hidden"], opt["dim_movement_latent"]),
        "movement_dec": lambda: MovementConvDecoder(
            opt["dim_movement_latent"], opt["dim_movement_enc_hidden"], dim_pose),
        "text_encoder": lambda: TextEncoderBiGRUCo(
            opt["dim_word"], opt["dim_pos_ohot"], opt["dim_text_hidden"],
            opt["dim_coemb_hidden"]),
        "motion_encoder": lambda: MotionEncoderBiGRUCo(
            opt["dim_movement_latent"], opt["dim_motion_hidden"], opt["dim_coemb_hidden"]),
        "estimator": lambda: MotionLenEstimatorBiGRU(output_size=length_bins),
    }
    return [build[name]() for name in names]


def random_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw a fresh evaluator network or comp_v6 generator from
    `generator` as the JAX package's Flax modules are drawn
    (models/initializers): lecun-normal linear and convolution kernels
    (a transposed convolution's fan-in is its input channels times its
    width), each GRU gate's recurrent kernel orthogonal, zero biases,
    LayerNorm at one and zero, a tower's `hidden` from normal(1)."""
    return initializers.init_params_(module, generator, {"hidden": 1.0})


def load_torch_file(path: Union[str, os.PathLike]) -> Dict:
    """A released `.tar` or the port's `.pt` (a dict of state dicts)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_state(module: nn.Module, sd: Mapping) -> None:
    module.load_state_dict({k: v if torch.is_tensor(v) else torch.tensor(np.asarray(v))
                            for k, v in sd.items()})


def evaluator_state(wrapper: "T2MEvaluatorWrapper") -> Dict[str, Dict[str, torch.Tensor]]:
    """The three networks' state dicts in the released finest.tar layout."""
    return {key: {k: v.detach().cpu() for k, v in getattr(wrapper, name).state_dict().items()}
            for key, name in (("movement_encoder", "movement_enc"),
                              ("text_encoder", "text_enc"), ("motion_encoder", "motion_enc"))}


def load_length_estimator(path: str, device="cpu") -> MotionLenEstimatorBiGRU:
    """A trained estimator: the port's `.pt` (train_t2m_eval --stage length)
    or a released `length_est_bigru latest.tar` (under "estimator"); its
    bin count is read from the state."""
    state = load_torch_file(path)
    sd = state.get("estimator", state)
    est = MotionLenEstimatorBiGRU(output_size=int(sd["output.9.weight"].shape[0]))
    load_state(est, sd)
    return est.to(device).eval()


class T2MEvaluatorWrapper:
    """The co-embedding interface (reference: EvaluatorMDMWrapper's
    get_co_embeddings and get_motion_embeddings) on `device`, returning
    numpy. `state`: a finest.tar-layout dict of state dicts, or a path to
    one (a released `.tar`, the port's `.pt`); None draws the three
    networks from torch.Generator(seed), in the order movement, text,
    motion."""

    def __init__(self, dataset_name: str = "humanml",
                 state: Optional[Union[str, os.PathLike, Mapping]] = None,
                 device="cpu", seed: int = 0):
        self.opt = dict(T2M_OPT, dim_pose=dim_pose(dataset_name))
        self.device = torch.device(device)
        nets = networks(self.opt["dim_pose"], "movement_enc", "text_encoder", "motion_encoder")
        self.movement_enc, self.text_enc, self.motion_enc = nets
        if state is None:
            generator = torch.Generator().manual_seed(int(seed))
            for net in nets:
                random_init_(net, generator)
        else:
            if not isinstance(state, Mapping):
                state = load_torch_file(state)
            for key, net in zip(("movement_encoder", "text_encoder", "motion_encoder"), nets):
                load_state(net, state[key])
        for net in nets:
            net.to(self.device).eval()

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    @torch.no_grad()
    def get_motion_embeddings(self, motions, m_lens) -> np.ndarray:
        movements = self.movement_enc(self._tensor(motions)[..., :-FOOT_FEATS])
        lengths = np.asarray(m_lens, np.int64) // self.opt["unit_length"]
        return self.motion_enc(movements, lengths).cpu().numpy()

    @torch.no_grad()
    def get_co_embeddings(self, word_embs, pos_ohot, cap_lens, motions, m_lens):
        text = self.text_enc(self._tensor(word_embs), self._tensor(pos_ohot),
                             np.asarray(cap_lens, np.int64)).cpu().numpy()
        return text, self.get_motion_embeddings(motions, m_lens)
