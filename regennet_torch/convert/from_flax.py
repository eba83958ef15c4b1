"""Flax CMDM params -> the port's (reference torch) state dict, and a
JAX train state -> the port's training state.

The inverse of regennet_tpu/convert/torch_ckpt.convert_cmdm for every
trunk (online / trans_dec, offline / trans_enc, gru, mlp), of
::convert_stgcn for the ST-GCN classifiers (two-person, single-person and
the unconstrained openpose one), and of ::convert_gru_classifier for the
a2m GRU classifier. It takes the param tree as
nested dicts of numpy arrays (no JAX import), so weights of a model
trained by the JAX package load into regennet_torch.models.cmdm.CMDM with
`load_state_dict`.
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


def _gru_layer(sd, prefix, layer, cell):
    """Flax GRUCell {ir, iz, in, hr, hz, hn} -> layer `layer` of the torch
    GRU `prefix` (gate order r, z, n). Flax's one r/z bias goes into
    bias_ih and the r/z slices of bias_hh are zero (the CMDM's trunk holds
    them there in training); the n gate keeps its input bias in bias_ih
    and its hidden bias in bias_hh."""
    def kernel(name):
        return np.asarray(cell[name]["kernel"]).T

    def bias(name):
        return np.asarray(cell[name]["bias"])

    sd[f"{prefix}.weight_ih_l{layer}"] = np.ascontiguousarray(
        np.concatenate([kernel(n) for n in ("ir", "iz", "in")], axis=0))
    sd[f"{prefix}.weight_hh_l{layer}"] = np.ascontiguousarray(
        np.concatenate([kernel(n) for n in ("hr", "hz", "hn")], axis=0))
    sd[f"{prefix}.bias_ih_l{layer}"] = np.concatenate([bias(n) for n in ("ir", "iz", "in")])
    hn = bias("hn")
    sd[f"{prefix}.bias_hh_l{layer}"] = np.concatenate([np.zeros_like(hn), np.zeros_like(hn), hn])


def _mlp_block(sd, prefix, block):
    """Flax MLPBlock -> the reference MLPblock; time_mix's [T, T] kernel
    is the transpose of fc0's Conv1d(T, T, 1) weight."""
    _linear(sd, f"{prefix}.emb_fc", block["emb_fc"])
    _linear(sd, f"{prefix}.fc1", block["fc1"])
    _layernorm(sd, f"{prefix}.norm0", block["norm0"])
    _layernorm(sd, f"{prefix}.norm1", block["norm1"])
    mix = block["time_mix"]
    sd[f"{prefix}.fc0.weight"] = np.ascontiguousarray(np.asarray(mix["kernel"]).T[:, :, None])
    sd[f"{prefix}.fc0.bias"] = np.asarray(mix["bias"])
    if "concat_proj" in block:
        _linear(sd, f"{prefix}.conct", block["concat_proj"])


def cmdm_state_dict_from_flax(params: Mapping) -> Dict[str, np.ndarray]:
    """Flax CMDM params (any trunk) -> reference-layout state dict."""
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
    if "GRUCell_0" in params:
        i = 0
        while f"GRUCell_{i}" in params:
            _gru_layer(sd, "gru", i, params[f"GRUCell_{i}"])
            i += 1
        return sd
    if "mlp_0" in params:
        i = 0
        while f"mlp_{i}" in params:
            _mlp_block(sd, f"mlp.motion_mlp.mlps.{i}", params[f"mlp_{i}"])
            i += 1
        return sd
    if "decoder" not in params and "encoder" not in params:
        raise ValueError("no trunk (decoder, encoder, GRUCell_0, mlp_0) in the params")
    decoder = "decoder" in params
    layers = params["decoder" if decoder else "encoder"]
    trunk = "seqTransDecoder" if decoder else "seqTransEncoder"
    for i in range(len(layers)):
        layer = layers[f"layer_{i}"]
        p = f"{trunk}.layers.{i}"
        _mha(sd, f"{p}.self_attn", layer["self_attn"])
        if decoder:
            _mha(sd, f"{p}.multihead_attn", layer["cross_attn"])
        _linear(sd, f"{p}.linear1", layer["ff"]["linear1"])
        _linear(sd, f"{p}.linear2", layer["ff"]["linear2"])
        for n in ("norm1", "norm2", "norm3") if decoder else ("norm1", "norm2"):
            _layernorm(sd, f"{p}.{n}", layer[n])
    return sd


def _conv(sd, prefix, conv):
    """flax conv kernel [kH, kW, C_in, C_out] -> torch [C_out, C_in, kH, kW]."""
    sd[f"{prefix}.weight"] = np.ascontiguousarray(
        np.transpose(np.asarray(conv["kernel"]), (3, 2, 0, 1)))
    sd[f"{prefix}.bias"] = np.asarray(conv["bias"])


def _batchnorm(sd, prefix, params, stats):
    sd[f"{prefix}.weight"] = np.asarray(params["scale"])
    sd[f"{prefix}.bias"] = np.asarray(params["bias"])
    sd[f"{prefix}.running_mean"] = np.asarray(stats["mean"])
    sd[f"{prefix}.running_var"] = np.asarray(stats["var"])


def stgcn_state_dict_from_flax(variables: Mapping) -> Dict[str, np.ndarray]:
    """Flax STGCN {"params", "batch_stats"} -> the reference recognition
    classifier's state dict (`data_bn`, `st_gcn_networks.i.{gcn.conv,
    tcn.0, tcn.2, tcn.3, residual.0, residual.1}`, `edge_importance.i`,
    `fcn`), which regennet_torch.models.stgcn.STGCN loads."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, np.ndarray] = {}
    _batchnorm(sd, "data_bn", params["data_bn"], stats["data_bn"])
    i = 0
    while f"st_gcn_{i}" in params:
        blk_p, blk_s = params[f"st_gcn_{i}"], stats[f"st_gcn_{i}"]
        pre = f"st_gcn_networks.{i}"
        _conv(sd, f"{pre}.gcn.conv", blk_p["gcn"]["conv"])
        _batchnorm(sd, f"{pre}.tcn.0", blk_p["tcn_bn0"], blk_s["tcn_bn0"])
        _conv(sd, f"{pre}.tcn.2", blk_p["tcn_conv"])
        _batchnorm(sd, f"{pre}.tcn.3", blk_p["tcn_bn1"], blk_s["tcn_bn1"])
        if "res_conv" in blk_p:
            _conv(sd, f"{pre}.residual.0", blk_p["res_conv"])
            _batchnorm(sd, f"{pre}.residual.1", blk_p["res_bn"], blk_s["res_bn"])
        i += 1
    j = 0
    while f"edge_importance_{j}" in params:
        sd[f"edge_importance.{j}"] = np.asarray(params[f"edge_importance_{j}"])
        j += 1
    _conv(sd, "fcn", params["fcn"])
    return sd


def gru_classifier_state_dict_from_flax(variables: Mapping) -> Dict[str, np.ndarray]:
    """Flax MotionDiscriminator {"params": {GRUCell_i, linear1, linear2}}
    (or its params) -> the reference classifier's state dict
    (`recurrent.*_l{i}`, `linear1`, `linear2`), which
    regennet_torch.models.gru_classifier.MotionDiscriminator loads."""
    params = variables.get("params", variables)
    sd: Dict[str, np.ndarray] = {}
    i = 0
    while f"GRUCell_{i}" in params:
        _gru_layer(sd, "recurrent", i, params[f"GRUCell_{i}"])
        i += 1
    _linear(sd, "linear1", params["linear1"])
    _linear(sd, "linear2", params["linear2"])
    return sd


def _adam_state(opt_state):
    """(count, mu, nu) of optax's scale_by_adam inside an adamw chain state
    (nested tuples of named tuples, or dicts), or None."""
    if isinstance(opt_state, Mapping):
        if {"count", "mu", "nu"} <= set(opt_state):
            return opt_state["count"], opt_state["mu"], opt_state["nu"]
        children = list(opt_state.values())
    elif all(hasattr(opt_state, k) for k in ("count", "mu", "nu")):
        return opt_state.count, opt_state.mu, opt_state.nu
    elif isinstance(opt_state, (tuple, list)):
        children = opt_state
    else:
        return None
    for child in children:
        found = _adam_state(child)
        if found is not None:
            return found
    return None


def train_state_from_flax(state: Mapping) -> Dict:
    """A JAX train state {params, ema_params, opt_state (optax adamw), step}
    as numpy trees -> the port's training state:
      {"model": state dict, "ema": state dict, "exp_avg": state dict,
       "exp_avg_sq": state dict, "adam_step": int, "step": int}.
    The AdamW moments are param-shaped trees, so they go through the same
    mapping as the parameters (zeros in a GRU's frozen bias_hh r/z
    slices). `training_loop.load_train_state` puts the
    result into a model, its AdamW optimizer and an EMA dict."""
    adam = _adam_state(state["opt_state"])
    if adam is None:
        raise ValueError("opt_state holds no optax scale_by_adam state")
    count, mu, nu = adam
    return {
        "model": cmdm_state_dict_from_flax(state["params"]),
        "ema": cmdm_state_dict_from_flax(state["ema_params"]),
        "exp_avg": cmdm_state_dict_from_flax(mu),
        "exp_avg_sq": cmdm_state_dict_from_flax(nu),
        "adam_step": int(np.asarray(count)),
        "step": int(np.asarray(state["step"])),
    }
