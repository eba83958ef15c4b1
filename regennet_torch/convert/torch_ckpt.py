"""Layout check of torch checkpoints (counterpart of
regennet_tpu/convert/torch_ckpt.py's `--check` CLI):

    python -m regennet_torch.convert.torch_ckpt --check FILE [--kind auto|
        cmdm/{online,offline,gru,mlp}|stgcn|gru|t2m|comp_v6|length_est|
        clip_text|actor/{transformer,fc,gru,grutrans,transgru,autotrans}]

The kind is read from the file's key fingerprint (`detect_kind`, a copy
of the JAX package's). The file's tensors are then loaded, strictly, into
the port's own module for that kind, built at the sizes its shapes give:
a missing or an unconsumed key raises. The keys every loader of the port
leaves out (a frozen CLIP tower or a body model riding in a CMDM file,
positional-table buffers, BatchNorm's counters, an ST-GCN's adjacency, a
full CLIP file's vision tower) are left out here too. Runs on the CPU: it
loads no kernel.
"""

from __future__ import annotations

import argparse
import re
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_IGNORABLE_PREFIXES = ("clip_model.", "rot2xyz.")
_IGNORABLE_SUFFIXES = ("num_batches_tracked", "sequence_pos_encoder.pe", ".pe")
_IGNORABLE_EXACT = ("A", "pe")


def detect_kind(obj) -> str:
    """Guess which converter a loaded checkpoint object belongs to from its
    key fingerprint. `obj` is the raw torch.load result (dict)."""
    if not isinstance(obj, dict):
        raise ValueError(f"unsupported checkpoint object: {type(obj)}")
    if "movement_encoder" in obj:
        return "t2m"
    if "text_enc" in obj and "mov_dec" in obj:
        return "comp_v6"
    if "estimator" in obj:
        return "length_est"
    if any(
        k.startswith(("transformer.resblocks.", "text_model.encoder."))
        for k in obj.get("state_dict", obj)
    ):
        return "clip_text"
    inner = obj.get("model") if isinstance(obj.get("model"), dict) else None
    keys = set(obj.get("state_dict", inner if inner is not None else obj))
    if any(k.startswith("st_gcn_networks.") for k in keys):
        return "stgcn"
    if any(k.startswith("recurrent.weight_ih_l") for k in keys):
        return "gru"
    if "input_process.poseEmbedding.weight" in keys:
        if any(k.startswith("seqTransDecoder.") for k in keys):
            return "cmdm/online"
        if any(k.startswith("seqTransEncoder.") for k in keys):
            return "cmdm/offline"
        if any(k.startswith("gru.weight_ih_l") for k in keys):
            return "cmdm/gru"
        if any(k.startswith("mlp.motion_mlp.") for k in keys):
            return "cmdm/mlp"
        return "cmdm/offline"
    if any(k.startswith(("encoder.", "decoder.")) for k in keys):
        # ACTOR CVAE/CAE family: pick the arch from the half fingerprints
        enc = (
            "fc" if "encoder.fully_connected.0.weight" in keys
            else "gru" if "encoder.feats_embedding.weight" in keys
            else "transformer" if "encoder.skelEmbedding.weight" in keys
            else None
        )
        dec = (
            "fc" if "decoder.fully_connected.0.weight" in keys
            else "gru" if "decoder.feats_embedding.weight" in keys
            else "transformer" if "decoder.finallayer.weight" in keys
            else "autotrans" if "decoder.embedding_x.weight" in keys
            else None
        )
        pair_to_arch = {
            ("transformer", "transformer"): "transformer",
            ("fc", "fc"): "fc",
            ("gru", "gru"): "gru",
            ("gru", "transformer"): "grutrans",
            ("transformer", "gru"): "transgru",
            ("transformer", "autotrans"): "autotrans",
        }
        if (enc, dec) in pair_to_arch:
            return f"actor/{pair_to_arch[(enc, dec)]}"
    raise ValueError(
        "could not identify checkpoint kind from keys: "
        f"{sorted(keys)[:8]} ..."
    )


# ---------------------------------------------------------------------------
# state dicts and strict loading
# ---------------------------------------------------------------------------

def _ignorable(key: str) -> bool:
    return (key.startswith(_IGNORABLE_PREFIXES) or key.endswith(_IGNORABLE_SUFFIXES)
            or key in _IGNORABLE_EXACT)


def _tensors(sd: Mapping, ignorable: bool = True) -> Dict[str, torch.Tensor]:
    """The tensors of a state dict (numpy arrays converted), the keys every
    loader of the port leaves out dropped."""
    out = {}
    for k, v in sd.items():
        if ignorable and _ignorable(k):
            continue
        out[k] = v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
    return out


def _load_strict(module: nn.Module, sd: Mapping[str, torch.Tensor], what: str) -> int:
    """Load `sd` into `module`; raises on a missing, unconsumed or
    misshapen key. Returns the number of tensors loaded."""
    expected = {k for k in module.state_dict() if not _ignorable(k)}
    missing = sorted(expected - set(sd))
    unconsumed = sorted(set(sd) - set(module.state_dict()))
    if missing or unconsumed:
        raise ValueError(f"{what}: {len(missing)} keys missing {missing[:10]}, "
                         f"{len(unconsumed)} unconsumed {unconsumed[:10]}")
    try:
        module.load_state_dict(dict(sd), strict=False)
    except RuntimeError as e:  # a shape that the sizes read from the file do not give
        raise ValueError(f"{what}: {e}") from None
    return len(sd)


def _count(sd: Mapping, pattern: str) -> int:
    """The number of distinct indices i for which `pattern` with {} replaced
    by i starts a key."""
    rx = re.compile(re.escape(pattern).replace(r"\{\}", r"(\d+)"))
    return len({m.group(1) for k in sd for m in [rx.match(k)] if m})


def _heads(dim: int) -> int:
    """A head count dividing `dim` (the checkpoint's shapes do not hold it)."""
    return next(h for h in (4, 2, 1) if dim % h == 0)


# ---------------------------------------------------------------------------
# a module per kind, at the sizes the shapes give
# ---------------------------------------------------------------------------

def _cmdm(sd, arch: str) -> nn.Module:
    from regennet_torch.models.cmdm import CMDM

    latent = sd["input_process.poseEmbedding.weight"].shape[0]
    feats = sd["output_process.poseFinal.weight"].shape[0]
    cond = [m for m, key in (("text", "embed_text.weight"),
                             ("action", "embed_action.action_embedding")) if key in sd]
    kw = dict(njoints=feats, nfeats=1, latent_dim=latent, arch=arch,
              cm_mode="concat" if "fuse_process.weight" in sd else "add",
              cond_mode="_".join(cond) or "no_cond", num_heads=_heads(latent),
              num_actions=(sd["embed_action.action_embedding"].shape[0]
                           if "action" in cond else 1))
    if arch in ("online", "offline"):
        trunk = "seqTransDecoder" if arch == "online" else "seqTransEncoder"
        kw["num_layers"] = _count(sd, trunk + ".layers.{}.")
        kw["ff_size"] = sd[f"{trunk}.layers.0.linear1.weight"].shape[0]
    elif arch == "gru":
        kw["num_layers"] = _count(sd, "gru.weight_ih_l{}")
    else:
        kw["num_layers"] = _count(sd, "mlp.motion_mlp.mlps.{}.")
        kw["num_frames"] = sd["mlp.motion_mlp.mlps.0.fc0.weight"].shape[0]
    return CMDM(**kw)


def _stgcn(sd) -> nn.Module:
    from regennet_torch.models.stgcn import STGCN

    K, V = sd["edge_importance.0"].shape[:2]
    layout = {56: "smplx", 25: "smpl", 23: "smpl_noglobal", 24: "ntu_edge",
              15: "openpose"}.get(int(V))
    if layout is None:
        raise ValueError(f"STGCN: no graph layout of {V} nodes")
    in_channels = sd["data_bn.weight"].shape[0] // V
    c_in = sd["st_gcn_networks.0.gcn.conv.weight"].shape[1]
    channels, strides, prev = [], [], c_in
    for i in range(_count(sd, "st_gcn_networks.{}.")):
        c = sd[f"st_gcn_networks.{i}.tcn.0.weight"].shape[0]
        # a residual convolution between equal widths means a stride
        strides.append(2 if f"st_gcn_networks.{i}.residual.0.weight" in sd and prev == c
                       else 1)
        channels.append(c)
        prev = c
    return STGCN(in_channels=in_channels, num_class=sd["fcn.weight"].shape[0],
                 num_person=in_channels // c_in, layout=layout, channels=channels,
                 strides=strides)


def _gru_classifier(sd) -> nn.Module:
    from regennet_torch.models.gru_classifier import MotionDiscriminator

    return MotionDiscriminator(sd["recurrent.weight_ih_l0"].shape[1],
                               sd["recurrent.weight_hh_l0"].shape[1],
                               _count(sd, "recurrent.weight_ih_l{}"),
                               sd["linear2.weight"].shape[0])


def _actor(sd, arch: str) -> nn.Module:
    from regennet_torch.models.actor_cvae import ARCH_FAMILIES, ActorCVAE

    enc, dec = ARCH_FAMILIES[arch]
    kw = dict(arch=arch, nfeats=1, num_frames=1)
    if enc == "transformer":
        actions, latent = sd["encoder.muQuery"].shape
        feats = sd["encoder.skelEmbedding.weight"].shape[1]
        kw.update(num_layers=_count(sd, "encoder.seqTransEncoder.layers.{}."),
                  ff_size=sd["encoder.seqTransEncoder.layers.0.linear1.weight"].shape[0])
    elif enc == "gru":
        latent = sd["encoder.mu.weight"].shape[0]
        feats = sd["decoder.final_layer.weight"].shape[0] if dec == "gru" else \
            sd["decoder.finallayer.weight"].shape[0]
        actions = sd["encoder.feats_embedding.weight"].shape[1] - feats - 1  # a time channel
        kw["num_gru_layers"] = _count(sd, "encoder.gru.weight_ih_l{}")
    else:  # fc: the frame count folds into the feature width
        latent = sd["encoder.mu.weight"].shape[0]
        feats = sd["decoder.fully_connected.4.weight"].shape[0]
        actions = sd["encoder.fully_connected.0.weight"].shape[1] - feats
    if dec == "transformer":
        kw.update(num_layers=_count(sd, "decoder.seqTransDecoder.layers.{}."),
                  ff_size=sd["decoder.seqTransDecoder.layers.0.linear1.weight"].shape[0])
    elif dec == "gru":
        kw["num_gru_layers"] = _count(sd, "decoder.gru.weight_ih_l{}")
    elif dec == "autotrans":
        kw["ff_size"] = sd["decoder.layers.0.feed_forward.pwff_layer.0.weight"].shape[0]
    return ActorCVAE(njoints=feats, num_actions=actions, latent_dim=latent,
                     num_heads=_heads(latent), **kw)


def _movement_encoder(sd) -> nn.Module:
    from regennet_torch.models.t2m_eval import MovementConvEncoder

    hidden, width = sd["main.0.weight"].shape[:2]
    return MovementConvEncoder(width, hidden, sd["out_net.weight"].shape[0])


def _t2m_networks(obj) -> List[Tuple[str, nn.Module, Mapping]]:
    from regennet_torch.models import t2m_eval

    text, motion = obj["text_encoder"], obj["motion_encoder"]
    nets = [_movement_encoder(obj["movement_encoder"]),
            t2m_eval.TextEncoderBiGRUCo(
                text["input_emb.weight"].shape[1], text["pos_emb.weight"].shape[1],
                text["input_emb.weight"].shape[0], text["output_net.3.weight"].shape[0]),
            t2m_eval.MotionEncoderBiGRUCo(*motion["input_emb.weight"].shape[::-1],
                                          motion["output_net.3.weight"].shape[0])]
    return [(key, net, obj[key]) for key, net in
            zip(("movement_encoder", "text_encoder", "motion_encoder"), nets)]


def _comp_v6_networks(obj) -> List[Tuple[str, nn.Module, Mapping]]:
    from regennet_torch.models import t2m_gen

    pri, dec = obj["seq_pri"], obj["seq_dec"]
    gen = t2m_gen.CompV6Generator(
        dim_pose=obj["mov_dec"]["out_net.weight"].shape[0],
        dim_word=obj["text_enc"]["input_emb.weight"].shape[1],
        dim_pos_ohot=obj["text_enc"]["pos_emb.weight"].shape[1],
        text_hidden=obj["text_enc"]["input_emb.weight"].shape[0],
        att_vec=obj["att_layer"]["W_q.weight"].shape[0], dim_z=pri["mu_net.weight"].shape[0],
        pri_hidden=pri["mu_net.weight"].shape[1], dec_hidden=dec["emb.0.weight"].shape[0],
        n_layers=_count(pri, "gru.{}.weight_ih"),
        mov_latent=dec["output.3.weight"].shape[0])
    mov_enc = _movement_encoder(obj["mov_enc"])
    return [(name, net, obj[name]) for name, net in t2m_gen.networks(gen, mov_enc).items()]


def _length_estimator(sd) -> nn.Module:
    from regennet_torch.models.t2m_eval import MotionLenEstimatorBiGRU

    return MotionLenEstimatorBiGRU(sd["input_emb.weight"].shape[1], sd["pos_emb.weight"].shape[1],
                                   sd["input_emb.weight"].shape[0], sd["output.9.weight"].shape[0])


def _clip_text(sd) -> Tuple[nn.Module, Dict[str, torch.Tensor]]:
    """The text tower and the entries it consumes: the text keys of either
    layout; a full CLIP file's vision tower, its scalars and HF's
    position_ids are not the text tower's."""
    from regennet_torch.models import clip_text_tower as ctt

    if any(k.startswith("text_model.") for k in sd):
        sd = {k: v for k, v in sd.items() if "position_ids" not in k}
        extra = sorted(k for k in sd if not k.startswith(("text_model.", "text_projection")))
    else:
        extra = sorted(k for k in sd if not k.startswith(ctt.TEXT_PREFIXES)
                       and not k.startswith("visual.")
                       and k not in ("logit_scale", "input_resolution", "context_length",
                                     "vocab_size"))
    if extra:
        raise ValueError(f"CLIP text: {len(extra)} unconsumed keys {extra[:10]}")
    text = ctt.openai_text_state_dict(sd)
    tower = ctt.tower_from_state_dict(sd)
    return tower, {k: v.float() for k, v in text.items()}


def check_checkpoint(path: str, kind: str = "auto") -> Dict[str, object]:
    """Validate a torch checkpoint's layout against the port's modules:
    load, detect the kind, build the module at the file's sizes and load
    it strictly. Returns {"kind", "arrays", "parameters"}; raises on a
    missing or unconsumed key."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if kind == "auto":
        kind = detect_kind(obj)
    try:
        loads = _modules(obj, kind)
    except KeyError as e:  # a key the sizes are read from
        raise ValueError(f"{kind}: key {e} missing") from None
    arrays = sum(_load_strict(net, sd, what) for what, net, sd in loads)
    parameters = sum(int(v.numel()) for _, _, sd in loads for v in sd.values())
    return {"kind": kind, "arrays": arrays, "parameters": parameters}


def _modules(obj, kind: str) -> List[Tuple[str, nn.Module, Mapping]]:
    """(what, the port's module at the file's sizes, its state dict) of
    each network a checkpoint of `kind` holds."""
    if kind == "t2m":
        loads = [(f"t2m evaluator {k}", net, _tensors(sd)) for k, net, sd in _t2m_networks(obj)]
    elif kind == "comp_v6":
        loads = [(f"comp_v6 {k}", net, _tensors(sd)) for k, net, sd in _comp_v6_networks(obj)]
    elif kind == "length_est":
        sd = _tensors(obj.get("estimator", obj))
        loads = [("length estimator", _length_estimator(sd), sd)]
    elif kind == "clip_text":
        tower, sd = _clip_text(_tensors(obj.get("state_dict", obj), ignorable=False))
        loads = [("CLIP text", tower, sd)]
    elif kind == "gru":
        sd = _tensors(obj.get("model", obj))
        loads = [("GRU classifier", _gru_classifier(sd), sd)]
    elif kind == "stgcn":
        sd = _tensors(obj.get("state_dict", obj.get("model", obj)))
        loads = [("STGCN", _stgcn(sd), sd)]
    elif kind.startswith("actor"):
        arch = kind.split("/", 1)[1] if "/" in kind else "transformer"
        sd = _tensors(obj.get("state_dict", obj.get("model", obj)))
        loads = [(f"ACTOR {arch} CVAE", _actor(sd, arch), sd)]
    elif kind.startswith("cmdm"):
        arch = kind.split("/", 1)[1] if "/" in kind else "online"
        sd = _tensors(obj.get("state_dict", obj))
        loads = [("CMDM", _cmdm(sd, arch), sd)]
    else:
        raise ValueError(f"unknown kind {kind!r}")
    return loads


def main(argv=None):
    """CLI: `python -m regennet_torch.convert.torch_ckpt --check file.pt
    [--kind auto|cmdm/{online,offline,gru,mlp}|stgcn|gru|t2m|comp_v6|length_est|
    clip_text|actor/{transformer,fc,gru,grutrans,transgru,autotrans}]`:
    loads the checkpoint into the port's module for its kind (fails
    loudly on unconsumed or missing keys)."""
    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--check", required=True, metavar="FILE",
                   help="torch checkpoint to validate")
    p.add_argument("--kind", default="auto")
    args = p.parse_args(argv)
    summary = check_checkpoint(args.check, args.kind)
    print(
        f"OK: {args.check} is a valid {summary['kind']} checkpoint "
        f"({summary['arrays']} arrays, {summary['parameters']:,} parameters, "
        "all keys consumed)"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
