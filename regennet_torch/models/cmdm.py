"""CMDM, the conditional motion diffusion denoiser (counterpart of
regennet_tpu/models/cmdm.py): the online / trans_dec trunk (a causal
decoder, the timestep-and-action embedding as its cross-attention memory)
and the offline / trans_enc trunk (a non-causal encoder over the
embedding token followed by the frames).

Tensors are batch-first [B, T, D] inside and [B, njoints, nfeats, T] at
the API, as in the JAX package. Module and parameter names are those of
the reference torch checkpoints (`input_process.poseEmbedding`,
`embed_timestep.time_embed.{0,2}`, `seqTransDecoder.layers.{i}...` or
`seqTransEncoder.layers.{i}...`), so a released state dict loads with
`load_state_dict` once its frozen CLIP, body-model and positional-table
keys are stripped (train/checkpoint.py).
The model computes in the dtype of its parameters: `.to(torch.bfloat16)`
gives the bf16 sampler. `forward(..., train=True, generator=g)` is the
training forward: condition dropout, positional, residual and attention
dropout, each drawn from the torch.Generator `g`.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from regennet_torch.models import transformer as tfm

PORTED_ARCHS = ("online", "trans_dec", "offline", "trans_enc")
DECODER_ARCHS = ("online", "trans_dec")


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
        return self.time_embed(self.pe[timesteps])


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


class CMDM(nn.Module):
    """Conditional (actor -> reactor) motion denoiser.

    forward(x [B, J, F, T], t [B], cond) -> x0_hat [B, J, F, T] (float32).
    cond keys: 'cmotion' [B, J, F, T], 'action' [B, 1] int, 'uncond' bool
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
            raise NotImplementedError(
                f"arch={arch!r} is not ported yet (ported: {PORTED_ARCHS})"
            )
        if cm_mode not in ("add", "concat"):
            raise NotImplementedError(f"cm_mode={cm_mode!r}")
        if "text" in cond_mode:
            raise NotImplementedError("text conditioning is not ported yet")
        self.njoints, self.nfeats = njoints, nfeats
        self.num_frames = num_frames
        self.latent_dim = latent_dim
        self.arch, self.cm_mode, self.cond_mode = arch, cm_mode, cond_mode
        self.cond_mask_prob = cond_mask_prob
        self.wo_pos_emb, self.emb_trans_dec = wo_pos_emb, emb_trans_dec
        self.data_rep = data_rep
        self.dropout = dropout  # training only; sampling never drops
        input_feats = njoints * nfeats

        self.input_process = PoseEmbedding(input_feats, latent_dim)
        self.cmo_process = PoseEmbedding(input_feats, latent_dim)
        if cm_mode == "concat":
            self.fuse_process = nn.Linear(2 * latent_dim, latent_dim)
        self.embed_timestep = TimestepEmbedder(latent_dim)
        if "action" in cond_mode:
            self.embed_action = EmbedAction(num_actions, latent_dim)
        trunk_args = (num_layers, latent_dim, num_heads, ff_size,
                      tfm.ACTIVATIONS[activation], dropout)
        if arch in DECODER_ARCHS:
            self.seqTransDecoder = tfm.Decoder(*trunk_args)
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
            drop = torch.rand((B,), generator=generator,
                              device=cond_emb.device) < self.cond_mask_prob
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
        'fold_in_kernel' when present."""
        if cond is None or "cmotion" not in cond or "cond_emb_seq" in cond:
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
        cmx_seq = self.cmo_process.poseEmbedding(
            self._to_seq(cond["cmotion"]).to(x_feats.dtype)
        )
        if self.cm_mode == "add":
            return x_seq + cmx_seq
        return self.fuse_process(torch.cat([x_seq, cmx_seq], dim=-1))

    def _add_pos(self, xseq, generator):
        pos = self.pos_table[: xseq.shape[1]].to(xseq.dtype)
        return tfm.dropout(xseq + pos, self.dropout, generator)

    def forward(self, x, timesteps, cond: Optional[Dict] = None,
                train: bool = False, generator: Optional[torch.Generator] = None):
        """train=True needs `generator`, the source of every dropout draw;
        it uses no prepare_cond fold (the weights change every step)."""
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
        if "action" in self.cond_mode:
            idx = cond["action"][:, 0].long()
            action_emb = self.embed_action.action_embedding[idx]
            emb = emb + self._mask_cond(action_emb, cond.get("uncond"), generator)

        xseq = self._fuse(self._to_seq(x).to(dtype), cond)
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
        out = self.output_process.poseFinal(out).float()
        return out.reshape(B, T, J, F).permute(0, 2, 3, 1)


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
        for key in ("action", actor):
            if key in cond:
                cond2[key] = torch.cat([cond[key], cond[key]])
        out = model(torch.cat([x, x]), torch.cat([t, t]), cond2)
        out_cond, out_uncond = out[:B], out[B:]
        return out_uncond + guidance_scale * (out_cond - out_uncond)

    model_fn.prepare = torch.no_grad()(model.prepare_cond)
    return model_fn
