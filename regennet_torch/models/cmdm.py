"""CMDM, the conditional motion diffusion denoiser (counterpart of
regennet_tpu/models/cmdm.py): the online / trans_dec trunk (a causal
decoder, the timestep-and-action embedding as its cross-attention memory),
the offline / trans_enc trunk (a non-causal encoder over the embedding
token followed by the frames), the gru trunk (stacked GRU layers over
time, the embedding concatenated to every frame's pose features) and the
mlp trunk (DiffMLP blocks mixing over frames and channels, the embedding
added in every block).

Tensors are batch-first [B, T, D] inside and [B, njoints, nfeats, T] at
the API, as in the JAX package. Module and parameter names are those of
the reference torch checkpoints (`input_process.poseEmbedding`,
`embed_timestep.time_embed.{0,2}`, `seqTransDecoder.layers.{i}...` or
`seqTransEncoder.layers.{i}...`, `gru.weight_ih_l{i}...`,
`mlp.motion_mlp.mlps.{i}...`), so a released state dict loads with
`load_state_dict` once its frozen CLIP, body-model and positional-table
keys are stripped (train/checkpoint.py).
The model computes in the dtype of its parameters: `.to(torch.bfloat16)`
gives the bf16 sampler, and the trainer runs it on bf16 copies of its
float32 parameters (`torch.func.functional_call`).
cond_mode "text" (HumanML3D, KIT) adds `embed_text`, a Linear from the
CLIP embedding cond['text_emb'] [B, 512] to the latent, to the timestep
embedding, through the same condition masking as the action embedding.
`forward(..., train=True, generator=g)` is the training forward: condition
dropout, positional, residual and attention dropout, each drawn from the
torch.Generator `g`.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
from torch import nn

from regennet_torch.models import initializers
from regennet_torch.models import transformer as tfm
from regennet_torch.utils import profiling

DECODER_ARCHS = ("online", "trans_dec")
TRANSFORMER_ARCHS = DECODER_ARCHS + ("offline", "trans_enc")
PORTED_ARCHS = TRANSFORMER_ARCHS + ("gru", "mlp")
CLIP_DIM = 512  # the CLIP ViT-B/32 text embedding cond['text_emb']


class TimestepEmbedder(nn.Module):
    """Sinusoidal table row -> Linear, SiLU, Linear."""

    def __init__(self, latent_dim: int, max_len: int = 5000):
        super().__init__()
        self.time_embed = nn.Sequential(
            nn.Linear(latent_dim, latent_dim), nn.SiLU(),
            nn.Linear(latent_dim, latent_dim),
        )
        self.register_buffer("pe", tfm.sinusoidal_table(max_len, latent_dim),
                             persistent=False)

    def forward(self, timesteps):
        # the f32 table's rows rounded to the compute dtype, as the JAX
        # package rounds them (a no-op once the module is cast)
        return self.time_embed(self.pe[timesteps].to(self.time_embed[0].weight.dtype))


class EmbedAction(nn.Module):
    def __init__(self, num_actions: int, latent_dim: int):
        super().__init__()
        self.action_embedding = nn.Parameter(torch.randn(num_actions, latent_dim))


class PoseEmbedding(nn.Module):
    """The reference's InputProcess: one Linear named poseEmbedding."""

    def __init__(self, in_features: int, latent_dim: int):
        super().__init__()
        self.poseEmbedding = nn.Linear(in_features, latent_dim)


class OutputProcess(nn.Module):
    def __init__(self, latent_dim: int, out_features: int):
        super().__init__()
        self.poseFinal = nn.Linear(latent_dim, out_features)


def _freeze_rz_grad(latent_dim: int, grad: torch.Tensor) -> torch.Tensor:
    """Gradient hook of each GRU layer's bias_hh: zero its r and z slices.

    Flax's GRUCell has one bias per r and z gate; torch's GRU has two,
    b_ih and b_hh, that only ever appear summed, so both get the same
    gradient. Adam normalises each separately, so trained as they are the
    sum would move about twice as far per step as the flax bias does.
    With the r/z slices of b_hh held still, b_ih alone carries the flax
    bias and AdamW follows the JAX train step; weight decay and the EMA are
    linear, so they keep the sum equal to the flax update as well. The
    n-gate slice trains: flax keeps that hidden bias separate (`hn`)."""
    grad = grad.clone()
    grad[: 2 * latent_dim] = 0
    return grad


class MLPBlock(nn.Module):
    """DiffMLP residual block (the reference's MLPblock): time mixing (a
    1x1 convolution with the frames as channels, `fc0`) and channel mixing
    (`fc1`), each after a LayerNorm and added through SiLU, the embedding
    added first through `emb_fc`; block 0 first projects the concatenated
    streams [2D] -> [D] (`conct`)."""

    def __init__(self, latent_dim: int, seq_len: int, first: bool):
        super().__init__()
        if first:
            self.conct = nn.Linear(2 * latent_dim, latent_dim)
        self.emb_fc = nn.Linear(latent_dim, latent_dim)
        self.norm0 = nn.LayerNorm(latent_dim, eps=1e-5)
        self.fc0 = nn.Conv1d(seq_len, seq_len, 1)
        self.norm1 = nn.LayerNorm(latent_dim, eps=1e-5)
        self.fc1 = nn.Linear(latent_dim, latent_dim)

    def forward(self, x, emb):
        """x [B, T, D (2D in block 0)], emb [B, D] -> [B, T, D]."""
        if hasattr(self, "conct"):
            x = self.conct(x)
        x = x + self.emb_fc(torch.nn.functional.silu(emb))[:, None, :]
        x = x + torch.nn.functional.silu(self.fc0(self.norm0(x)))
        return x + torch.nn.functional.silu(self.fc1(self.norm1(x)))


class DiffMLP(nn.Module):
    """The DiffMLP blocks, `mlps.{i}`."""

    def __init__(self, num_layers: int, latent_dim: int, seq_len: int):
        super().__init__()
        self.mlps = nn.ModuleList(
            MLPBlock(latent_dim, seq_len, first=i == 0) for i in range(num_layers))

    def forward(self, x, emb):
        for block in self.mlps:
            x = block(x, emb)
        return x


class CMDM(nn.Module):
    """Conditional (actor -> reactor) motion denoiser.

    forward(x [B, J, F, T], t [B], cond) -> x0_hat [B, J, F, T] (float32).
    cond keys: 'cmotion' [B, J, F, T], 'action' [B, 1] int, 'text_emb'
    [B, CLIP_DIM] (cond_mode text), 'uncond' bool
    scalar or [B] (zero the condition embedding: CFG), and the
    loop-invariant 'cond_emb_seq' / 'fold_in_kernel' from `prepare_cond`.
    """

    def __init__(self, njoints: int, nfeats: int, num_actions: int,
                 num_frames: int = 60, latent_dim: int = 512,
                 ff_size: int = 1024, num_layers: int = 8, num_heads: int = 4,
                 dropout: float = 0.1, activation: str = "gelu",
                 arch: str = "online", cm_mode: str = "add",
                 cond_mode: str = "action", cond_mask_prob: float = 0.0,
                 wo_pos_emb: bool = False, emb_trans_dec: bool = False,
                 data_rep: str = "rot6d"):
        super().__init__()
        if arch not in PORTED_ARCHS:
            raise ValueError(f"arch={arch!r}: choose one of {PORTED_ARCHS}")
        if cm_mode not in ("add", "concat"):
            raise NotImplementedError(f"cm_mode={cm_mode!r}")
        if arch == "gru" and cm_mode != "add":
            raise NotImplementedError(f"the gru trunk takes cm_mode 'add', not {cm_mode!r}")
        self.njoints, self.nfeats = njoints, nfeats
        self.num_frames = num_frames
        self.latent_dim = latent_dim
        self.arch, self.cm_mode, self.cond_mode = arch, cm_mode, cond_mode
        self.cond_mask_prob = cond_mask_prob
        self.wo_pos_emb, self.emb_trans_dec = wo_pos_emb, emb_trans_dec
        self.data_rep = data_rep
        self.dropout = dropout  # training only; sampling never drops
        input_feats = njoints * nfeats
        # the gru trunk concatenates the embedding to every frame's features
        proc_feats = input_feats + (latent_dim if arch == "gru" else 0)

        self.input_process = PoseEmbedding(proc_feats, latent_dim)
        self.cmo_process = PoseEmbedding(proc_feats, latent_dim)
        if cm_mode == "concat" and arch in TRANSFORMER_ARCHS:
            self.fuse_process = nn.Linear(2 * latent_dim, latent_dim)
        self.embed_timestep = TimestepEmbedder(latent_dim)
        if "text" in cond_mode:
            self.embed_text = nn.Linear(CLIP_DIM, latent_dim)
        if "action" in cond_mode:
            self.embed_action = EmbedAction(num_actions, latent_dim)
        trunk_args = (num_layers, latent_dim, num_heads, ff_size,
                      tfm.ACTIVATIONS[activation], dropout)
        if arch in DECODER_ARCHS:
            self.seqTransDecoder = tfm.Decoder(*trunk_args)
        elif arch == "gru":
            # one cuDNN GRU over time for all layers, zero initial state
            self.gru = nn.GRU(latent_dim, latent_dim, num_layers=num_layers,
                              batch_first=True)
            for i in range(num_layers):
                bias_hh = getattr(self.gru, f"bias_hh_l{i}")
                with torch.no_grad():
                    bias_hh[: 2 * latent_dim].zero_()
                bias_hh.register_hook(functools.partial(_freeze_rz_grad, latent_dim))
        elif arch == "mlp":
            # the reference's module path mlp.motion_mlp; its time mixing
            # is shaped by the frame count
            self.mlp = nn.ModuleDict(
                {"motion_mlp": DiffMLP(num_layers, latent_dim, num_frames)})
        else:
            self.seqTransEncoder = tfm.Encoder(*trunk_args)
        self.output_process = OutputProcess(latent_dim, input_feats)
        self.register_buffer("pos_table", tfm.sinusoidal_table(5000, latent_dim),
                             persistent=False)

    @property
    def dtype(self) -> torch.dtype:
        return self.output_process.poseFinal.weight.dtype

    @staticmethod
    def _to_seq(v):
        """[B, J, F, T] -> [B, T, J*F]."""
        B, J, F, T = v.shape
        return v.permute(0, 3, 1, 2).reshape(B, T, J * F)

    def _mask_cond(self, cond_emb, uncond, generator=None):
        """Zero the condition embedding of unconditioned examples (CFG);
        in training (`generator` given) each example is also dropped with
        probability cond_mask_prob."""
        B = cond_emb.shape[0]
        keep = torch.ones((B,), dtype=cond_emb.dtype, device=cond_emb.device)
        if generator is not None and self.cond_mask_prob > 0.0:
            drop = tfm.uniform((B,), generator, cond_emb.device) < self.cond_mask_prob
            keep = keep * (1.0 - drop.to(cond_emb.dtype))
        if uncond is not None:
            forced = torch.as_tensor(uncond, device=cond_emb.device).expand(B)
            keep = keep * (1.0 - forced.to(cond_emb.dtype))
        return cond_emb * keep[:, None]

    def prepare_cond(self, cond: Optional[Dict]) -> Optional[Dict]:
        """Precompute the loop-invariant actor conditioning once per sampling
        loop: the cmo_process projection, and for cm_mode='concat' the
        bottom half of the fuse matmul plus input_process folded into its
        top half (x @ W_in + b_in) @ F_top == x @ (W_in F_top) + b_in F_top,
        accumulated in f32. forward() reads 'cond_emb_seq' and
        'fold_in_kernel' when present. The gru and mlp trunks take cond
        unchanged."""
        if (self.arch not in TRANSFORMER_ARCHS or cond is None
                or "cmotion" not in cond or "cond_emb_seq" in cond):
            return cond
        dtype = self.dtype
        cmx = self.cmo_process.poseEmbedding(self._to_seq(cond["cmotion"]).to(dtype))
        new_cond = dict(cond)
        if self.cm_mode == "add":
            new_cond["cond_emb_seq"] = cmx
            return new_cond
        D = self.latent_dim
        fuse_w = self.fuse_process.weight.float()  # [D, 2D]: [x half | cmotion half]
        top_t = fuse_w[:, :D].t()
        emb = cmx.float() @ fuse_w[:, D:].t() + self.fuse_process.bias.float()
        w_in = self.input_process.poseEmbedding.weight.float()  # [D, J*F]
        new_cond["fold_in_kernel"] = (w_in.t() @ top_t).to(dtype)  # [J*F, D]
        emb = emb + self.input_process.poseEmbedding.bias.float() @ top_t
        new_cond["cond_emb_seq"] = emb
        return new_cond

    def _fuse(self, x_feats, cond):
        """Actor/reactor fusion -> [B, T, D] in the compute dtype."""
        pre_emb = cond.get("cond_emb_seq")
        if pre_emb is not None and self.cm_mode == "concat":
            # accumulated in f32 and rounded once, as the JAX package's
            # dot_general with an f32 result: the operands widened to f32
            # are exact, and f32 matmuls run without TF32
            top = torch.matmul(x_feats.float(), cond["fold_in_kernel"].float())
            return (top + pre_emb).to(x_feats.dtype)
        x_seq = self.input_process.poseEmbedding(x_feats)
        if pre_emb is not None:  # add
            return x_seq + pre_emb.to(x_seq.dtype)
        cmx_seq = self.cmo_process.poseEmbedding(self._cmotion_feats(cond, x_feats.dtype))
        if self.cm_mode == "add":
            return x_seq + cmx_seq
        return self.fuse_process(torch.cat([x_seq, cmx_seq], dim=-1))

    def _add_pos(self, xseq, generator):
        pos = self.pos_table[: xseq.shape[1]].to(xseq.dtype)
        return tfm.dropout(xseq + pos, self.dropout, generator)

    def forward(self, x, timesteps, cond: Optional[Dict] = None,
                train: bool = False, generator: Optional[torch.Generator] = None):
        """train=True needs `generator`, the source of every dropout draw;
        it uses no prepare_cond fold (the weights change every step). The
        forward runs in a `denoiser` span (utils/profiling)."""
        with profiling.span("denoiser"):
            cond = cond or {}
            if train:
                if generator is None:
                    raise ValueError("the training forward needs a torch.Generator")
                cond = {k: v for k, v in cond.items()
                        if k not in ("cond_emb_seq", "fold_in_kernel")}
            else:
                generator = None
            B, J, F, T = x.shape
            dtype = self.dtype
            emb = self.embed_timestep(timesteps)  # [B, D]
            if "text" in self.cond_mode:
                text_emb = self.embed_text(cond["text_emb"].to(dtype))
                emb = emb + self._mask_cond(text_emb, cond.get("uncond"), generator)
            if "action" in self.cond_mode:
                idx = cond["action"][:, 0].long()
                action_emb = self.embed_action.action_embedding[idx]
                emb = emb + self._mask_cond(action_emb, cond.get("uncond"), generator)

            x_feats = self._to_seq(x).to(dtype)
            if self.arch == "gru":
                out = self._gru(x_feats, cond, emb, generator)
            elif self.arch == "mlp":
                out = self._mlp(x_feats, cond, emb)
            else:
                out = self._transformer(x_feats, cond, emb, generator)
            out = self.output_process.poseFinal(out).float()
            return out.reshape(B, T, J, F).permute(0, 2, 3, 1)

    def _cmotion_feats(self, cond, dtype):
        return self._to_seq(cond["cmotion"]).to(dtype)

    def _gru(self, x_feats, cond, emb, generator):
        """Both streams take the embedding after their pose features; their
        sum, with positions and dropout, runs through the GRU layers."""
        emb_rep = emb[:, None, :].expand(-1, x_feats.shape[1], -1)
        x_seq = self.input_process.poseEmbedding(torch.cat([x_feats, emb_rep], -1))
        cmx_seq = self.cmo_process.poseEmbedding(
            torch.cat([self._cmotion_feats(cond, x_feats.dtype), emb_rep], -1))
        out, _ = self.gru(self._add_pos(x_seq + cmx_seq, generator))
        return out

    def _mlp(self, x_feats, cond, emb):
        """The streams concatenated actor first, through the DiffMLP blocks
        (no positions, no dropout)."""
        if x_feats.shape[1] != self.num_frames:
            raise ValueError(f"the mlp trunk is built for {self.num_frames} frames, "
                             f"not {x_feats.shape[1]}")
        x_seq = self.input_process.poseEmbedding(x_feats)
        cmx_seq = self.cmo_process.poseEmbedding(self._cmotion_feats(cond, x_feats.dtype))
        return self.mlp["motion_mlp"](torch.cat([cmx_seq, x_seq], -1), emb)

    def _transformer(self, x_feats, cond, emb, generator):
        xseq = self._fuse(x_feats, cond)
        memory = emb[:, None, :]  # the single conditioning token
        if self.arch in DECODER_ARCHS:
            if self.emb_trans_dec:
                xseq = torch.cat([memory, xseq], dim=1)
            if not self.wo_pos_emb:
                xseq = self._add_pos(xseq, generator)
            out = self.seqTransDecoder(xseq, memory, True, generator)
            if self.emb_trans_dec:
                out = out[:, 1:]
        else:
            # the embedding token first, positions on every token, and the
            # token's output dropped (the encoder ignores wo_pos_emb)
            xseq = self._add_pos(torch.cat([memory, xseq], dim=1), generator)
            out = self.seqTransEncoder(xseq, generator)[:, 1:]
        return out


def random_init_(model: CMDM, generator: torch.Generator) -> CMDM:
    """Draw a fresh CMDM from `generator` as the JAX package's Flax CMDM
    is drawn (models/initializers): lecun-normal kernels (the packed
    attention projections and the mlp trunk's time mixing included), zero
    biases, each GRU gate's recurrent kernel orthogonal, LayerNorms at one
    and zero, the action embedding from normal(1)."""
    return initializers.init_params_(model, generator, {"action_embedding": 1.0})


def make_model_fn(model: CMDM):
    """Bind the model into the diffusion ModelFn contract, with `prepare`."""

    @torch.no_grad()
    def model_fn(x, t, cond):
        return model(x, t, cond)

    model_fn.prepare = torch.no_grad()(model.prepare_cond)
    return model_fn


def make_cfg_model_fn(model: CMDM, guidance_scale: float):
    """Classifier-free guidance as ONE 2B-batched forward:
    uncond + s * (cond - uncond), where the second half of the batch has
    its condition embedding zeroed."""
    if not model.cond_mask_prob > 0:
        raise ValueError(
            "Classifier-free guidance requires a model trained with "
            "condition dropout (cond_mask_prob > 0); this model has "
            f"cond_mask_prob={model.cond_mask_prob}. Use guidance_scale=1 "
            "with make_model_fn instead."
        )

    @torch.no_grad()
    def model_fn(x, t, cond):
        B = x.shape[0]
        cond2 = {"uncond": torch.cat([
            torch.zeros(B, dtype=torch.bool, device=x.device),
            torch.ones(B, dtype=torch.bool, device=x.device),
        ])}
        if "fold_in_kernel" in cond:
            cond2["fold_in_kernel"] = cond["fold_in_kernel"]
        # the per-example inputs the network reads
        actor = "cond_emb_seq" if "cond_emb_seq" in cond else "cmotion"
        for key in ("action", "text_emb", actor):
            if key in cond:
                cond2[key] = torch.cat([cond[key], cond[key]])
        out = model(torch.cat([x, x]), torch.cat([t, t]), cond2)
        out_cond, out_uncond = out[:B], out[B:]
        return out_uncond + guidance_scale * (out_cond - out_uncond)

    model_fn.prepare = torch.no_grad()(model.prepare_cond)
    return model_fn
