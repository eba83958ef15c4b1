"""regennet_torch CMDM against the JAX package's Flax CMDM on shared weights.

Weights are made by the Flax init, carried to the port with
cmdm_state_dict_from_flax, and both models run the same numpy inputs at
f32. The JAX side runs its self-attention through the Pallas kernel in
interpret mode (REGENNET_PALLAS_ATTN=1), the numerics the port's
attention follows. Tolerance 2e-5 (f32, different matmul sum orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regennet_tpu.convert.torch_ckpt import convert_cmdm
from regennet_tpu.models import cmdm as jcmdm
from regennet_torch.convert.from_flax import cmdm_state_dict_from_flax
from regennet_torch.models import cmdm
from regennet_torch.train import checkpoint

B, J, F, T = 3, 56, 6, 20
ATOL = 2e-5


def _kwargs(**over):
    kw = dict(njoints=J, nfeats=F, num_actions=8, num_frames=T, latent_dim=64,
              ff_size=128, num_layers=2, num_heads=4, arch="online",
              cm_mode="concat", cond_mode="action", cond_mask_prob=0.1)
    kw.update(over)
    return kw


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, J, F, T)).astype(np.float32)
    cmotion = (rng.normal(size=(B, J, F, T)) * 0.5).astype(np.float32)
    t = np.array([3, 500, 999])
    action = np.array([[1], [5], [7]])
    return x, t, cmotion, action


def _pair(monkeypatch, **over):
    """(flax model, flax params, port model) on the same weights."""
    monkeypatch.setenv("REGENNET_PALLAS_ATTN", "1")
    jm = jcmdm.CMDM(**_kwargs(**over))
    x, t, cmotion, action = _inputs()
    params = jm.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
        {"cmotion": jnp.asarray(cmotion), "action": jnp.asarray(action)},
    )["params"]
    sd = cmdm_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params))
    tm = cmdm.CMDM(**_kwargs(**over)).eval()
    tm.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    return jm, params, tm


def _jcond(cmotion, action, **extra):
    return {"cmotion": jnp.asarray(cmotion), "action": jnp.asarray(action), **extra}


def _tcond(cmotion, action, **extra):
    return {"cmotion": torch.tensor(cmotion), "action": torch.tensor(action), **extra}


@pytest.mark.parametrize("cm_mode", ["concat", "add"])
def test_state_dict_round_trips_through_convert_cmdm(cm_mode):
    jm = jcmdm.CMDM(**_kwargs(cm_mode=cm_mode))
    x, t, cmotion, action = _inputs()
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(t),
                     _jcond(cmotion, action))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    sd = cmdm_state_dict_from_flax(params)
    back = convert_cmdm(dict(sd), arch="online")
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    # and the dict is exactly the port module's state dict layout
    port = cmdm.CMDM(**_kwargs(cm_mode=cm_mode))
    assert set(sd) == set(port.state_dict())
    assert ("fuse_process.weight" in sd) == (cm_mode == "concat")


@pytest.mark.parametrize("activation", ["gelu", "gelu_exact"])
def test_forward_matches_flax(monkeypatch, activation):
    jm, params, tm = _pair(monkeypatch, activation=activation)
    x, t, cmotion, action = _inputs(1)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                              _jcond(cmotion, action)))
    with torch.no_grad():
        ours = tm(torch.tensor(x), torch.tensor(t), _tcond(cmotion, action))
    assert ours.dtype == torch.float32 and ours.shape == (B, J, F, T)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=ATOL)


def test_gelu_forms_differ():
    """'gelu' is the tanh form, 'gelu_exact' the erf form."""
    from regennet_torch.models.transformer import ACTIVATIONS

    x = torch.linspace(-4, 4, 101)
    tanh_form = 0.5 * x * (1 + torch.tanh(0.7978845608028654 * (x + 0.044715 * x**3)))
    torch.testing.assert_close(ACTIVATIONS["gelu"](x), tanh_form)
    torch.testing.assert_close(
        ACTIVATIONS["gelu_exact"](x), 0.5 * x * (1 + torch.erf(x / 2**0.5))
    )
    assert (ACTIVATIONS["gelu"](x) - ACTIVATIONS["gelu_exact"](x)).abs().max() > 1e-4


@pytest.mark.parametrize("uncond", [True, np.array([True, False, True])])
def test_uncond_matches_flax(monkeypatch, uncond):
    jm, params, tm = _pair(monkeypatch)
    x, t, cmotion, action = _inputs(2)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                              _jcond(cmotion, action, uncond=jnp.asarray(uncond))))
    with torch.no_grad():
        ours = tm(torch.tensor(x), torch.tensor(t),
                  _tcond(cmotion, action, uncond=torch.tensor(uncond)))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("cm_mode", ["concat", "add"])
def test_prepare_cond_matches_flax(monkeypatch, cm_mode):
    """The prepared (folded) conditioning gives the model_fn the same
    outputs as the Flax model_fn with its own prepare."""
    jm, params, tm = _pair(monkeypatch, cm_mode=cm_mode)
    x, t, cmotion, action = _inputs(3)
    jfn = jcmdm.make_model_fn(jm, params)
    ref = np.asarray(jfn(jnp.asarray(x), jnp.asarray(t),
                         jfn.prepare(_jcond(cmotion, action))))
    fn = cmdm.make_model_fn(tm)
    prepared = fn.prepare(_tcond(cmotion, action))
    assert "cond_emb_seq" in prepared
    assert ("fold_in_kernel" in prepared) == (cm_mode == "concat")
    np.testing.assert_allclose(
        fn(torch.tensor(x), torch.tensor(t), prepared).numpy(), ref,
        rtol=0, atol=ATOL,
    )
    if cm_mode == "concat":
        jprep = jfn.prepare(_jcond(cmotion, action))
        np.testing.assert_allclose(prepared["fold_in_kernel"].numpy(),
                                   np.asarray(jprep["fold_in_kernel"]),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(prepared["cond_emb_seq"].numpy(),
                                   np.asarray(jprep["cond_emb_seq"]),
                                   rtol=0, atol=1e-5)


def test_cfg_model_fn_matches_flax(monkeypatch):
    jm, params, tm = _pair(monkeypatch)
    x, t, cmotion, action = _inputs(4)
    jfn = jcmdm.make_cfg_model_fn(jm, params, 2.5)
    ref = np.asarray(jfn(jnp.asarray(x), jnp.asarray(t),
                         jfn.prepare(_jcond(cmotion, action))))
    fn = cmdm.make_cfg_model_fn(tm, 2.5)
    ours = fn(torch.tensor(x), torch.tensor(t), fn.prepare(_tcond(cmotion, action)))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=ATOL * 4)
    # unprepared cond: same function
    ours2 = fn(torch.tensor(x), torch.tensor(t), _tcond(cmotion, action))
    np.testing.assert_allclose(ours2.numpy(), ref, rtol=0, atol=ATOL * 4)


def test_cfg_requires_condition_dropout():
    tm = cmdm.CMDM(**_kwargs(cond_mask_prob=0.0))
    with pytest.raises(ValueError, match="cond_mask_prob"):
        cmdm.make_cfg_model_fn(tm, 2.5)


@pytest.mark.parametrize("arch", ["gru", "mlp"])
def test_unported_trunks_raise(arch):
    with pytest.raises(NotImplementedError, match="not ported"):
        cmdm.CMDM(**_kwargs(arch=arch))


def test_reference_checkpoint_file_loads(tmp_path):
    """A released-style .pt file (extra CLIP, body-model and positional
    table keys) loads strictly into the port."""
    src = cmdm.CMDM(**_kwargs())
    sd = dict(src.state_dict())
    sd["clip_model.token_embedding.weight"] = torch.zeros(3, 2)
    sd["rot2xyz.smpl_model.v_template"] = torch.zeros(5, 3)
    sd["sequence_pos_encoder.pe"] = torch.zeros(10, 1, 64)
    sd["embed_timestep.sequence_pos_encoder.pe"] = torch.zeros(10, 1, 64)
    path = tmp_path / "model000000100.pt"
    torch.save(sd, path)
    dst = checkpoint.load_model(cmdm.CMDM(**_kwargs()), str(path))
    for k, v in src.state_dict().items():
        torch.testing.assert_close(dst.state_dict()[k], v, rtol=0, atol=0)
    with pytest.raises(ValueError, match="state dict file"):
        checkpoint.load_model(cmdm.CMDM(**_kwargs()), str(tmp_path))


def test_bf16_prepared_fold_rounds_once_as_jax(monkeypatch):
    """bf16 forward with prepare_cond: x_feats @ fold_in_kernel accumulates
    in f32 and is rounded to bf16 once, after adding cond_emb_seq, as the
    JAX package's dot_general with an f32 result. The decoder's input
    (fused sequence plus positional table, bf16) agrees with the JAX
    package's within one bf16 ulp of each element."""
    import flax.linen as fnn

    from regennet_tpu.models import transformer as jtfm

    monkeypatch.setenv("REGENNET_PALLAS_ATTN", "1")
    Bb, Tt = 4, 12
    kw = _kwargs(num_frames=Tt)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(Bb, J, F, Tt)).astype(np.float32)
    cm = (rng.normal(size=(Bb, J, F, Tt)) * 0.5).astype(np.float32)
    t, action = np.array([3, 250, 600, 999]), np.array([[1], [5], [7], [0]])
    jm = jcmdm.CMDM(**kw, dtype=jnp.bfloat16)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(t),
                     _jcond(cm, action))["params"]
    sd = cmdm_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params))
    tm = cmdm.CMDM(**kw)
    tm.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    tm = tm.to(torch.bfloat16).eval()

    captured = {}

    def intercept(next_fun, args, kwargs, context):
        if isinstance(context.module, jtfm.Decoder):
            captured["jax"] = np.asarray(args[0].astype(jnp.float32))
        return next_fun(*args, **kwargs)

    jfn = jcmdm.make_model_fn(jm, params)
    with fnn.intercept_methods(intercept):
        jfn(jnp.asarray(x), jnp.asarray(t), jfn.prepare(_jcond(cm, action)))
    tm.seqTransDecoder.register_forward_pre_hook(
        lambda mod, args: captured.__setitem__("port", args[0].float().numpy()))
    fn = cmdm.make_model_fn(tm)
    fn(torch.tensor(x), torch.tensor(t), fn.prepare(_tcond(cm, action)))

    ref = captured["jax"][:, :Tt]  # the JAX trunk pads T to the bf16 tile
    ours = captured["port"]
    assert ours.shape == ref.shape == (Bb, Tt, 64)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126))) - 7)
    assert (np.abs(ours - ref) <= ulp).all(), float(np.max(np.abs(ours - ref) / ulp))
