"""Flax CMDM params -> the port's (reference torch) state dict.

The inverse of regennet_tpu/convert/torch_ckpt.convert_cmdm for the
online / trans_dec trunk. It takes the param tree as nested dicts of
numpy arrays (no JAX import), so weights of a model trained by the JAX
package load into regennet_torch.models.cmdm.CMDM with `load_state_dict`.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np


def _linear(sd, prefix, dense):
    sd[f"{prefix}.weight"] = np.ascontiguousarray(np.asarray(dense["kernel"]).T)
    sd[f"{prefix}.bias"] = np.asarray(dense["bias"])


def _layernorm(sd, prefix, ln):
    sd[f"{prefix}.weight"] = np.asarray(ln["scale"])
    sd[f"{prefix}.bias"] = np.asarray(ln["bias"])


def _mha(sd, prefix, attn):
    """q/k/v/out Dense params -> packed in_proj + out_proj."""
    names = ("q_proj", "k_proj", "v_proj")
    sd[f"{prefix}.in_proj_weight"] = np.ascontiguousarray(
        np.concatenate([np.asarray(attn[n]["kernel"]).T for n in names], axis=0)
    )
    sd[f"{prefix}.in_proj_bias"] = np.concatenate(
        [np.asarray(attn[n]["bias"]) for n in names]
    )
    _linear(sd, f"{prefix}.out_proj", attn["out_proj"])


def cmdm_state_dict_from_flax(params: Mapping) -> Dict[str, np.ndarray]:
    """Flax CMDM params (online trunk) -> reference-layout state dict."""
    if "decoder" not in params:
        raise NotImplementedError(
            "only the online/trans_dec trunk (params['decoder']) is ported"
        )
    sd: Dict[str, np.ndarray] = {}
    _linear(sd, "input_process.poseEmbedding", params["input_process"])
    _linear(sd, "cmo_process.poseEmbedding", params["cmo_process"])
    if "fuse_process" in params:
        _linear(sd, "fuse_process", params["fuse_process"])
    _linear(sd, "embed_timestep.time_embed.0", params["embed_timestep"]["fc1"])
    _linear(sd, "embed_timestep.time_embed.2", params["embed_timestep"]["fc2"])
    if "action_embedding" in params:
        sd["embed_action.action_embedding"] = np.asarray(params["action_embedding"])
    _linear(sd, "output_process.poseFinal", params["output_process"])
    layers = params["decoder"]
    for i in range(len(layers)):
        layer = layers[f"layer_{i}"]
        p = f"seqTransDecoder.layers.{i}"
        _mha(sd, f"{p}.self_attn", layer["self_attn"])
        _mha(sd, f"{p}.multihead_attn", layer["cross_attn"])
        _linear(sd, f"{p}.linear1", layer["ff"]["linear1"])
        _linear(sd, f"{p}.linear2", layer["ff"]["linear2"])
        for n in ("norm1", "norm2", "norm3"):
            _layernorm(sd, f"{p}.{n}", layer[n])
    return sd
