"""Flax CMDM params -> the port's (reference torch) state dict, and a
JAX train state -> the port's training state.

The inverse of regennet_tpu/convert/torch_ckpt.convert_cmdm for every
trunk (online / trans_dec, offline / trans_enc, gru, mlp), of
::convert_stgcn for the ST-GCN classifiers (two-person, single-person and
the unconstrained openpose one), of ::convert_gru_classifier for the
a2m GRU classifier, of ::convert_clip_text for the CLIP text tower
(into the OpenAI ViT-B-32.pt names that models/clip_text_tower.py
loads), of ::convert_t2m_evaluator and ::convert_length_estimator for the
text-to-motion evaluators (models/t2m_eval.py), of the movement
autoencoder that train_t2m_eval's decomp stage trains, and of
::convert_comp_v6 for the comp_v6 generator (models/t2m_gen.py) and its
trainer's state, and of ::convert_actor_cvae for the ACTOR CVAE and CAE
(models/actor_cvae.py); and the GAN's generator and discriminator
(models/actor_gan.py), which have no reference torch layout, into the
port's module names. It takes the param tree as nested dicts of numpy arrays
(no JAX import), so weights of a model trained by the JAX package load
into regennet_torch.models.cmdm.CMDM with `load_state_dict`.
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


def _gru_layer(sd, prefix, layer, cell, suffix=""):
    """Flax GRUCell {ir, iz, in, hr, hz, hn} -> layer `layer` of the torch
    GRU `prefix` (gate order r, z, n; `suffix` "_reverse" for the second
    direction of a bidirectional GRU). Flax's one r/z bias goes into
    bias_ih and the r/z slices of bias_hh are zero (the CMDM's trunk holds
    them there in training); the n gate keeps its input bias in bias_ih
    and its hidden bias in bias_hh."""
    def kernel(name):
        return np.asarray(cell[name]["kernel"]).T

    def bias(name):
        return np.asarray(cell[name]["bias"])

    key = f"l{layer}{suffix}"
    sd[f"{prefix}.weight_ih_{key}"] = np.ascontiguousarray(
        np.concatenate([kernel(n) for n in ("ir", "iz", "in")], axis=0))
    sd[f"{prefix}.weight_hh_{key}"] = np.ascontiguousarray(
        np.concatenate([kernel(n) for n in ("hr", "hz", "hn")], axis=0))
    sd[f"{prefix}.bias_ih_{key}"] = np.concatenate([bias(n) for n in ("ir", "iz", "in")])
    hn = bias("hn")
    sd[f"{prefix}.bias_hh_{key}"] = np.concatenate([np.zeros_like(hn), np.zeros_like(hn), hn])


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


def _transformer_layers(sd, trunk, layers, decoder):
    """Flax Encoder/Decoder `layer_N` params -> `{trunk}.layers.N` of the
    post-LN torch layers (cross-attention `multihead_attn` and norm3 in a
    decoder)."""
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
    if "embed_text" in params:
        _linear(sd, "embed_text", params["embed_text"])
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
    _transformer_layers(sd, "seqTransDecoder" if decoder else "seqTransEncoder",
                        params["decoder" if decoder else "encoder"], decoder)
    return sd


def _gru_stack(sd, prefix, params, side):
    i = 0
    while f"{side}_gru_{i}" in params:
        _gru_layer(sd, prefix, i, params[f"{side}_gru_{i}"]["cell"])
        i += 1


def actor_cvae_state_dict_from_flax(params: Mapping) -> Dict[str, np.ndarray]:
    """Flax ActorCVAE params (any arch, CVAE or CAE) -> the reference ACTOR
    state dict that regennet_torch.models.actor_cvae.ActorCVAE loads: the
    inverse of regennet_tpu/convert/torch_ckpt.convert_actor_cvae."""
    sd: Dict[str, np.ndarray] = {}
    if "enc_fc1" in params:
        _linear(sd, "encoder.fully_connected.0", params["enc_fc1"])
        _linear(sd, "encoder.fully_connected.2", params["enc_fc2"])
    elif "enc_embed" in params:
        _linear(sd, "encoder.feats_embedding", params["enc_embed"])
        _gru_stack(sd, "encoder.gru", params, "enc")
    else:
        _linear(sd, "encoder.skelEmbedding", params["skel_embedding"])
        sd["encoder.muQuery"] = np.asarray(params["mu_query"])
        sd["encoder.sigmaQuery"] = np.asarray(params["sigma_query"])
        _transformer_layers(sd, "encoder.seqTransEncoder", params["encoder"], False)
    if "enc_mu" in params:
        _linear(sd, "encoder.mu", params["enc_mu"])
        _linear(sd, "encoder.var", params["enc_var"])

    if "dec_fc1" in params:
        for i, name in enumerate(("dec_fc1", "dec_fc2", "dec_out")):
            _linear(sd, f"decoder.fully_connected.{2 * i}", params[name])
    elif "dec_embed" in params:
        _linear(sd, "decoder.feats_embedding", params["dec_embed"])
        _gru_stack(sd, "decoder.gru", params, "dec")
        _linear(sd, "decoder.final_layer", params["dec_out"])
    elif "at_src_embedding" in params:
        _linear(sd, "decoder.embedding", params["at_src_embedding"])
        _linear(sd, "decoder.embedding_x", params["at_x_embedding"])
        _layernorm(sd, "decoder.layer_norm", params["at_norm"])
        sd["decoder.output_layer.weight"] = np.ascontiguousarray(
            np.asarray(params["at_out"]["kernel"]).T)
        i = 0
        while f"at_layer_{i}" in params:
            layer, p = params[f"at_layer_{i}"], f"decoder.layers.{i}"
            _layernorm(sd, f"{p}.x_layer_norm", layer["x_layer_norm"])
            _layernorm(sd, f"{p}.dec_layer_norm", layer["dec_layer_norm"])
            _layernorm(sd, f"{p}.feed_forward.layer_norm", layer["ff_layer_norm"])
            for att in ("trg_trg_att", "src_trg_att"):
                for flax_name, name in (("q_proj", "q_layer"), ("k_proj", "k_layer"),
                                        ("v_proj", "v_layer"), ("out_proj", "output_layer")):
                    _linear(sd, f"{p}.{att}.{name}", layer[att][flax_name])
            _linear(sd, f"{p}.feed_forward.pwff_layer.0", layer["pwff1"])
            _linear(sd, f"{p}.feed_forward.pwff_layer.3", layer["pwff2"])
            i += 1
    else:
        sd["decoder.actionBiases"] = np.asarray(params["action_biases"])
        _transformer_layers(sd, "decoder.seqTransDecoder", params["decoder"], True)
        _linear(sd, "decoder.finallayer", params["final_layer"])
    return sd


def actor_gan_state_dict_from_flax(params: Mapping) -> Dict[str, np.ndarray]:
    """Flax actor_gan Generator or Discriminator params -> the state dict of
    regennet_torch.models.actor_gan.Generator or .Discriminator. No torch
    reference layout exists for these classes, so the names are the port's
    modules: the Flax Dense layers under their own names, the `encoder`
    layers as `_transformer_layers` maps them."""
    sd: Dict[str, np.ndarray] = {}
    for name in ("noise_embed", "output_head", "frame_embed", "psi"):
        if name in params:
            _linear(sd, name, params[name])
    for name in ("label_embedding", "label_projection"):
        if name in params:
            sd[name] = np.asarray(params[name])
    _transformer_layers(sd, "encoder", params["encoder"], False)
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


def clip_text_state_dict_from_flax(variables: Mapping) -> Dict[str, np.ndarray]:
    """Flax ClipTextTransformer params {token_embedding, positional_embedding,
    block_i: {ln_1, q/k/v/out_proj, ln_2, fc1, fc2}, ln_final,
    text_projection} (or {"params": ...}) -> the OpenAI ViT-B-32.pt text
    tower state dict (`transformer.resblocks.{i}.attn.in_proj_*`,
    `mlp.c_fc`, `mlp.c_proj`, `text_projection` as the [D, P] matrix)."""
    params = variables.get("params", variables)
    sd: Dict[str, np.ndarray] = {
        "token_embedding.weight": np.asarray(params["token_embedding"]),
        "positional_embedding": np.asarray(params["positional_embedding"]),
        "text_projection": np.asarray(params["text_projection"]),
    }
    i = 0
    while f"block_{i}" in params:
        block, p = params[f"block_{i}"], f"transformer.resblocks.{i}"
        _mha(sd, f"{p}.attn", block)
        _layernorm(sd, f"{p}.ln_1", block["ln_1"])
        _layernorm(sd, f"{p}.ln_2", block["ln_2"])
        _linear(sd, f"{p}.mlp.c_fc", block["fc1"])
        _linear(sd, f"{p}.mlp.c_proj", block["fc2"])
        i += 1
    _layernorm(sd, "ln_final", params["ln_final"])
    return sd


def _conv1d(sd, prefix, conv):
    """flax Conv kernel [k, C_in, C_out] -> torch Conv1d [C_out, C_in, k]."""
    sd[f"{prefix}.weight"] = np.ascontiguousarray(
        np.transpose(np.asarray(conv["kernel"]), (2, 1, 0)))
    sd[f"{prefix}.bias"] = np.asarray(conv["bias"])


def _conv_transpose1d(sd, prefix, conv):
    """flax ConvTranspose kernel [k, C_in, C_out] ("SAME" padding) -> torch
    ConvTranspose1d(k=4, s=2, p=1) [C_in, C_out, k], the spatial axis
    flipped back (the inverse of torch_ckpt._conv_transpose1d)."""
    sd[f"{prefix}.weight"] = np.ascontiguousarray(
        np.transpose(np.asarray(conv["kernel"])[::-1], (1, 2, 0)))
    sd[f"{prefix}.bias"] = np.asarray(conv["bias"])


def _bigru(sd, p, pos_emb=None):
    """The BiGRU towers' common part: input_emb, the two directions, hidden."""
    _linear(sd, "input_emb", p["input_emb"])
    if pos_emb is not None:
        _linear(sd, "pos_emb", pos_emb)
    sd["hidden"] = np.asarray(p["hidden"])
    _gru_layer(sd, "gru", 0, p["fwd_cell"])
    _gru_layer(sd, "gru", 0, p["bwd_cell"], "_reverse")


def movement_encoder_state_dict_from_flax(params: Mapping) -> Dict[str, np.ndarray]:
    """Flax MovementConvEncoder {conv1, conv2, out_net} -> `main.0`, `main.3`,
    `out_net`."""
    sd: Dict[str, np.ndarray] = {}
    _conv1d(sd, "main.0", params["conv1"])
    _conv1d(sd, "main.3", params["conv2"])
    _linear(sd, "out_net", params["out_net"])
    return sd


def movement_decoder_state_dict_from_flax(params: Mapping) -> Dict[str, np.ndarray]:
    """Flax MovementConvDecoder {deconv1, deconv2, out_net} -> `main.0`,
    `main.2`, `out_net`."""
    sd: Dict[str, np.ndarray] = {}
    _conv_transpose1d(sd, "main.0", params["deconv1"])
    _conv_transpose1d(sd, "main.2", params["deconv2"])
    _linear(sd, "out_net", params["out_net"])
    return sd


def _bigru_co(params: Mapping, pos_emb=None) -> Dict[str, np.ndarray]:
    trunk = params["bigru"]
    sd: Dict[str, np.ndarray] = {}
    _bigru(sd, {**trunk, "input_emb": params["input_emb"]}, pos_emb)
    _linear(sd, "output_net.0", trunk["out1"])
    _layernorm(sd, "output_net.1", trunk["out_ln"])
    _linear(sd, "output_net.3", trunk["out2"])
    return sd


def t2m_evaluator_state_from_flax(variables: Mapping) -> Dict[str, Dict[str, np.ndarray]]:
    """T2MEvaluatorWrapper variables {movement, text, motion} -> the released
    finest.tar layout {movement_encoder, text_encoder, motion_encoder} (the
    inverse of torch_ckpt.convert_t2m_evaluator)."""
    return {
        "movement_encoder": movement_encoder_state_dict_from_flax(variables["movement"]),
        "text_encoder": _bigru_co(variables["text"], variables["text"]["pos_emb"]),
        "motion_encoder": _bigru_co(variables["motion"]),
    }


def length_estimator_state_dict_from_flax(variables: Mapping) -> Dict[str, np.ndarray]:
    """Flax MotionLenEstimatorBiGRU params (or {"params": ...}) -> the
    reference estimator's state dict (`pos_emb`, `input_emb`, `gru`,
    `hidden`, `output.0` ... `output.9`; the inverse of
    torch_ckpt.convert_length_estimator)."""
    params = variables.get("params", variables)
    sd: Dict[str, np.ndarray] = {}
    _bigru(sd, params, params["pos_emb"])
    for i in range(3):
        _linear(sd, f"output.{3 * i}", params[f"head_{i}"])
        _layernorm(sd, f"output.{3 * i + 1}", params[f"head_ln_{i}"])
    _linear(sd, "output.9", params["head_out"])
    return sd


def decomp_state_from_flax(params: Mapping) -> Dict[str, Dict[str, np.ndarray]]:
    """train_t2m_eval's decomp params {movement_enc, movement_dec} -> the
    movement autoencoder's two state dicts under the same keys."""
    return {"movement_enc": movement_encoder_state_dict_from_flax(params["movement_enc"]),
            "movement_dec": movement_decoder_state_dict_from_flax(params["movement_dec"])}


def _gru_cell(sd, prefix, cell):
    """Flax GRUCell -> torch nn.GRUCell `prefix` (keys without the _l0 of
    nn.GRU), flax's one r/z bias in bias_ih as _gru_layer puts it."""
    layer: Dict[str, np.ndarray] = {}
    _gru_layer(layer, prefix, 0, cell)
    sd.update({k[:-len("_l0")]: v for k, v in layer.items()})


def _seq_cell(p: Mapping) -> Dict[str, np.ndarray]:
    """A comp_v6 prior/posterior (mu_net, logvar_net) or decoder (out1,
    out_ln, out2) cell -> `z2init`, `emb.{0,1}`, `gru.{i}` and `mu_net`,
    `logvar_net` or `output.{0,1,3}` (the inverse of torch_ckpt._comp_seq_cell)."""
    sd: Dict[str, np.ndarray] = {}
    _linear(sd, "z2init", p["z2init"])
    _linear(sd, "emb.0", p["emb_dense"])
    _layernorm(sd, "emb.1", p["emb_ln"])
    i = 0
    while f"gru_{i}" in p:
        _gru_cell(sd, f"gru.{i}", p[f"gru_{i}"])
        i += 1
    if "mu_net" in p:
        _linear(sd, "mu_net", p["mu_net"])
        _linear(sd, "logvar_net", p["logvar_net"])
    else:
        _linear(sd, "output.0", p["out1"])
        _layernorm(sd, "output.1", p["out_ln"])
        _linear(sd, "output.3", p["out2"])
    return sd


def comp_v6_state_from_flax(params: Mapping) -> Dict[str, Dict[str, np.ndarray]]:
    """Flax CompV6Generator params -> the released CompTrainerV6 layout of
    its six networks {text_enc, seq_pri, seq_post, seq_dec, att_layer,
    mov_dec} (the inverse of torch_ckpt.convert_comp_v6, without mov_enc:
    movement_encoder_state_dict_from_flax gives that one)."""
    text: Dict[str, np.ndarray] = {}
    _bigru(text, params["text_enc"], params["text_enc"]["pos_emb"])
    att = params["att_layer"]
    att_sd: Dict[str, np.ndarray] = {}
    _linear(att_sd, "W_q", att["W_q"])
    att_sd["W_k.weight"] = np.ascontiguousarray(np.asarray(att["W_k"]["kernel"]).T)
    _linear(att_sd, "W_v", att["W_v"])
    return {"text_enc": text, "seq_pri": _seq_cell(params["seq_pri"]),
            "seq_post": _seq_cell(params["seq_post"]), "seq_dec": _seq_cell(params["seq_dec"]),
            "att_layer": att_sd, "mov_dec": movement_decoder_state_dict_from_flax(
                params["mov_dec"])}


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


def comp_v6_train_state_from_flax(state: Mapping) -> Dict:
    """A train_t2m_gen state of the JAX package {params, opt_state (optax
    clip_by_global_norm then adam), movement_enc} as numpy trees, with
    `epoch` -> the port's train_t2m_gen checkpoint: the seven released
    state dicts and {"opt": {"step", "exp_avg", "exp_avg_sq"}, "epoch"},
    the moments by network and parameter name as the parameters (zeros in
    the GRU cells' frozen bias_hh r/z slices)."""
    adam = _adam_state(state["opt_state"])
    if adam is None:
        raise ValueError("opt_state holds no optax scale_by_adam state")
    count, mu, nu = adam
    return {**comp_v6_state_from_flax(state["params"]),
            "mov_enc": movement_encoder_state_dict_from_flax(state["movement_enc"]),
            "opt": {"step": int(np.asarray(count)),
                    "exp_avg": comp_v6_state_from_flax(mu),
                    "exp_avg_sq": comp_v6_state_from_flax(nu)},
            "epoch": int(state["epoch"])}
