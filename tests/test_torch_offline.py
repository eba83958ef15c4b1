"""The offline / trans_enc CMDM trunk of regennet_torch against the JAX
package's CMDM(arch="offline") on shared weights (carried over with
cmdm_state_dict_from_flax), at 2 layers and latent 64.

The JAX trunk pads its token count to the sublane tile and masks the
padded keys; the port runs the real tokens only, so the two agree on the
real frames. The JAX side runs its self-attention through the Pallas
kernel in interpret mode (REGENNET_PALLAS_ATTN=1). Tolerances: f32 2e-5
x max(1, max|jax|) (sums in other orders, some set by the thread count,
through 21 non-causal tokens; outputs reach |4|); at bf16 the encoder's
input within one bf16 ulp of each element, as tests/test_torch_cmdm.py
holds the online trunk's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regennet_tpu.convert.torch_ckpt import convert_cmdm
from regennet_tpu.diffusion import losses as jlosses
from regennet_tpu.diffusion.schedule import DiffusionConfig as JConfig
from regennet_tpu.diffusion.schedule import make_schedule as jmake_schedule
from regennet_tpu.models import cmdm as jcmdm
from regennet_tpu.ops import body_model as jbm
from regennet_tpu.ops import pose_decode as jpd
from regennet_tpu.train import training_loop as jtl
from regennet_torch.convert.from_flax import cmdm_state_dict_from_flax, train_state_from_flax
from regennet_torch.diffusion.schedule import DiffusionConfig, make_schedule
from regennet_torch.models import cmdm
from regennet_torch.ops import body_model as bm
from regennet_torch.ops import pose_decode as pd
from regennet_torch.train import training_loop

B, J, F, T = 3, 56, 6, 20


def _atol(ref):
    return 2e-5 * max(1.0, float(np.abs(ref).max()))


def _kwargs(**over):
    kw = dict(njoints=J, nfeats=F, num_actions=8, num_frames=T, latent_dim=64,
              ff_size=128, num_layers=2, num_heads=4, arch="offline",
              cm_mode="concat", cond_mode="action", cond_mask_prob=0.1)
    kw.update(over)
    return kw


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, J, F, T)).astype(np.float32)
    cmotion = (rng.normal(size=(B, J, F, T)) * 0.5).astype(np.float32)
    return x, np.array([3, 500, 999]), cmotion, np.array([[1], [5], [7]])


def _jcond(cmotion, action):
    return {"cmotion": jnp.asarray(cmotion), "action": jnp.asarray(action)}


def _tcond(cmotion, action):
    return {"cmotion": torch.tensor(cmotion), "action": torch.tensor(action)}


def _pair(monkeypatch, dtype=jnp.float32, **over):
    """(flax model, flax params, port model) on the same weights."""
    monkeypatch.setenv("REGENNET_PALLAS_ATTN", "1")
    jm = jcmdm.CMDM(**_kwargs(**over), dtype=dtype)
    x, t, cmotion, action = _inputs()
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                     _jcond(cmotion, action))["params"]
    sd = cmdm_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params))
    tm = cmdm.CMDM(**_kwargs(**over))
    tm.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    return jm, params, tm.eval()


@pytest.mark.parametrize("arch", ["offline", "trans_enc"])
def test_state_dict_round_trips_through_convert_cmdm(arch):
    jm = jcmdm.CMDM(**_kwargs(arch=arch))
    x, t, cmotion, action = _inputs()
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(t),
                     _jcond(cmotion, action))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    sd = cmdm_state_dict_from_flax(params)
    back = convert_cmdm(dict(sd), arch=arch)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    port = cmdm.CMDM(**_kwargs(arch=arch))
    assert set(sd) == set(port.state_dict())
    assert "seqTransEncoder.layers.1.norm2.weight" in sd
    assert not any(k.startswith("seqTransDecoder") for k in sd)


@pytest.mark.parametrize("prepared", [False, True])
def test_forward_matches_flax(monkeypatch, prepared):
    jm, params, tm = _pair(monkeypatch)
    x, t, cmotion, action = _inputs(1)
    jfn = jcmdm.make_model_fn(jm, params)
    fn = cmdm.make_model_fn(tm)
    jcond, tcond = _jcond(cmotion, action), _tcond(cmotion, action)
    if prepared:
        jcond, tcond = jfn.prepare(jcond), fn.prepare(tcond)
    ref = np.asarray(jfn(jnp.asarray(x), jnp.asarray(t), jcond))
    ours = fn(torch.tensor(x), torch.tensor(t), tcond)
    assert ours.dtype == torch.float32 and ours.shape == (B, J, F, T)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=_atol(ref))


def test_cfg_model_fn_matches_flax(monkeypatch):
    jm, params, tm = _pair(monkeypatch)
    x, t, cmotion, action = _inputs(4)
    jfn = jcmdm.make_cfg_model_fn(jm, params, 2.5)
    ref = np.asarray(jfn(jnp.asarray(x), jnp.asarray(t),
                         jfn.prepare(_jcond(cmotion, action))))
    fn = cmdm.make_cfg_model_fn(tm, 2.5)
    ours = fn(torch.tensor(x), torch.tensor(t), fn.prepare(_tcond(cmotion, action)))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=_atol(ref) * 4)


def test_train_forward_at_dropout_0_matches_flax(monkeypatch):
    jm, params, tm = _pair(monkeypatch, dropout=0.0, cond_mask_prob=0.0)
    x, t, cmotion, action = _inputs(2)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                              _jcond(cmotion, action), train=True,
                              rngs={"dropout": jax.random.PRNGKey(3),
                                    "cond_mask": jax.random.PRNGKey(4)}))
    tm.train()
    ours = tm(torch.tensor(x), torch.tensor(t), _tcond(cmotion, action), train=True,
              generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(ours.detach().numpy(), ref, rtol=0, atol=_atol(ref))


def test_bf16_encoder_input_within_one_ulp_of_jax(monkeypatch):
    """bf16 forward with prepare_cond: the encoder's input, bf16. The fused
    frames plus positions within one bf16 ulp of each element of the JAX
    package's; the embedding token (two bf16 Linear layers around a SiLU,
    which the frameworks round at other points) within one bf16 ulp of
    its largest element. The bf16 output finite."""
    import flax.linen as fnn

    from regennet_tpu.models import transformer as jtfm

    jm, params, tm = _pair(monkeypatch, dtype=jnp.bfloat16)
    tm = tm.to(torch.bfloat16)
    x, t, cmotion, action = _inputs(5)
    captured = {}

    def intercept(next_fun, args, kwargs, context):
        if isinstance(context.module, jtfm.Encoder):
            captured["jax"] = np.asarray(args[0].astype(jnp.float32))
        return next_fun(*args, **kwargs)

    jfn = jcmdm.make_model_fn(jm, params)
    with fnn.intercept_methods(intercept):
        jfn(jnp.asarray(x), jnp.asarray(t), jfn.prepare(_jcond(cmotion, action)))
    tm.seqTransEncoder.register_forward_pre_hook(
        lambda mod, args: captured.__setitem__("port", args[0].float().numpy()))
    fn = cmdm.make_model_fn(tm)
    out = fn(torch.tensor(x), torch.tensor(t), fn.prepare(_tcond(cmotion, action)))
    ref = captured["jax"][:, :T + 1]  # the JAX trunk pads the tokens to the bf16 tile
    ours = captured["port"]
    assert ours.shape == ref.shape == (B, T + 1, 64)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126))) - 7)
    err = np.abs(ours - ref)
    assert (err[:, 1:] <= ulp[:, 1:]).all(), float(np.max(err[:, 1:] / ulp[:, 1:]))
    token_ulp = 2.0 ** (np.floor(np.log2(np.abs(ref[:, 0]).max())) - 7)
    assert err[:, 0].max() <= token_ulp, (err[:, 0].max(), token_ulp)
    assert out.shape == (B, J, F, T) and torch.isfinite(out).all()


def test_train_step_matches_jax():
    """One make_train_step step at dropout 0 from the same initial state:
    loss terms, gradients and the updated parameters. The orient, body and
    transl terms (the joint decode) are off: tests/test_torch_training.py
    holds them on the online trunk, and the trunk is what differs here."""
    lambdas = dict(lambda_vel=1.0)
    model_kw = _kwargs(dropout=0.0, cond_mask_prob=0.0, num_frames=16, num_heads=2)
    Tb, lr = 16, 1e-3
    rng_np = np.random.default_rng(6)
    batch = {
        "motion": rng_np.normal(size=(B, J, F, Tb)).astype(np.float32),
        "t": np.array([7, 420, 990], np.int32),
        "weights": np.array([1.0, 0.7, 1.3], np.float32),
        "cond": {"mask": np.ones((B, 1, 1, Tb), bool),
                 "cmotion": rng_np.normal(size=(B, J, F, Tb)).astype(np.float32),
                 "action": np.array([[1], [4], [6]])},
    }
    dec = dict(pose_rep="rot6d", jointstype="smplx", translation=True, glob=True,
               vertstrans=False, num_person=1)
    jm = jcmdm.CMDM(**model_kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(batch["motion"]),
                     jnp.asarray(batch["t"]),
                     {k: jnp.asarray(v) for k, v in batch["cond"].items()})["params"]
    opt = jtl.make_optimizer(lr, 0.0, 0)
    jdec = jpd.make_rot2xyz(jbm.synthetic("smplx", num_vertices=24), **dec)
    step_fn = jax.jit(jtl.make_train_step(jm, jmake_schedule("cosine", 1000),
                                          JConfig(**lambdas), opt, jdec))
    state0 = dict(params=params, opt_state=opt.init(params),
                  ema_params=jax.tree_util.tree_map(jnp.array, params),
                  step=jnp.zeros((), jnp.int32))
    rng = jax.random.PRNGKey(7)
    state1, jmetrics = step_fn(state0, batch, rng)
    # the step's gradients and noise, as make_train_step derives them
    drng, crng, nrng = jax.random.split(jax.random.fold_in(rng, 0), 3)
    noise = np.asarray(jax.random.normal(nrng, batch["motion"].shape, jnp.float32))

    def jloss(p):
        def model_fn(x, t, cond):
            return jm.apply({"params": p}, x, t, cond, train=True,
                            rngs={"dropout": drng, "cond_mask": crng})
        terms = jlosses.training_losses(jmake_schedule("cosine", 1000), JConfig(**lambdas),
                                        model_fn, batch["motion"], batch["t"],
                                        batch["cond"], nrng, rot2xyz_fn=jdec)
        return jnp.mean(terms["loss"] * batch["weights"])

    jgrads = cmdm_state_dict_from_flax(jax.device_get(jax.jit(jax.grad(jloss))(params)))

    model = cmdm.CMDM(**model_kw)
    optimizer = training_loop.make_optimizer(model.parameters(), lr, 0.0)
    ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    training_loop.load_train_state(model, optimizer, ema,
                                   train_state_from_flax(jax.device_get(state0)))
    step = training_loop.make_train_step(
        model, make_schedule("cosine", 1000), DiffusionConfig(**lambdas), optimizer,
        pd.make_rot2xyz(bm.synthetic("smplx", num_vertices=24), **dec), ema)
    tbatch = {"motion": torch.tensor(batch["motion"]), "t": torch.tensor(batch["t"]).long(),
              "weights": torch.tensor(batch["weights"]),
              "cond": {k: torch.tensor(v) for k, v in batch["cond"].items()}}
    metrics = step(tbatch, torch.Generator().manual_seed(0), 0, noise=torch.tensor(noise))

    for name, ref in jax.device_get(jmetrics).items():
        if name != "loss_per_elem":
            np.testing.assert_allclose(float(metrics[name]), float(ref), rtol=1e-5,
                                       err_msg=name)
    want = cmdm_state_dict_from_flax(jax.device_get(state1["params"]))
    for name, p in model.named_parameters():
        g, jg = p.grad.numpy(), jgrads[name]
        np.testing.assert_allclose(g, jg, rtol=0, atol=2e-5 * max(1.0, np.abs(jg).max()),
                                   err_msg=name)
        # Adam's first step moves each entry by lr * g / (|g| + eps). Where
        # the gradient is below 1e-5 of the tensor's largest entry, its f32
        # sums carry a relative error that moves that step by more than 1e-6,
        # or flip its sign (each self-attention's key bias, whose true
        # gradient is 0): there the two steps may differ by up to 2 lr
        diff = np.abs(p.detach().numpy() - want[name])
        noise_level = np.abs(jg) < 1e-5 * np.abs(jg).max()
        assert (diff[~noise_level] <= 1e-6).all(), name
        assert (diff <= 2 * lr * 1.01).all(), name


def test_train_and_sample_with_the_default_arch(tmp_path):
    """train_mdm and cgenerate with no --arch: the CLIs' default trans_enc."""
    from regennet_torch.data import synthetic
    from regennet_torch.data.feeder import Feeder
    from regennet_torch.data.get_data import BatchLoader, get_collate_fn
    from regennet_torch.sample import cgenerate
    from regennet_torch.train import train_mdm
    from regennet_torch.utils import parser_util

    Tc = 16
    save = tmp_path / "save"
    args = parser_util.train_args([
        "--save_dir", str(save), "--dataset", "chi3d", "--num_person", "2",
        "--body_model", "smplx", "--setting", "cmdm", "--layers", "2",
        "--latent_dim", "32", "--batch_size", "4", "--num_frames", str(Tc),
        "--num_steps", "2", "--steps_per_call", "2", "--save_interval", "2",
        "--log_interval", "1", "--diffusion_steps", "100", "--seed", "3",
    ])
    assert args.arch == "trans_enc"
    feeder = Feeder(clips=synthetic.make_clips("chi3d", "train", num_clips=12,
                                               min_len=Tc + 4, max_len=2 * Tc),
                    dataname="chi3d", split="train", num_frames=Tc, num_person=2)
    loop = train_mdm.main(args, device="cpu",
                          data=BatchLoader(feeder, 4, get_collate_fn("chi3d", "cmdm")))
    assert loop.state_step == 2 and hasattr(loop.model, "seqTransEncoder")
    ckpt = save / "model000000002.pt"
    sample_args = parser_util.cgenerate_args([
        "--model_path", str(ckpt), "--output_dir", str(tmp_path / "samples"),
        "--dataset", "chi3d", "--num_person", "2", "--body_model", "smplx",
        "--num_samples", "2", "--num_repetitions", "1", "--use_ddim",
        "--timestep_respacing", "ddim5",
    ])
    assert sample_args.arch == "trans_enc"
    sample_args.num_frames = Tc
    res = np.load(cgenerate.main(sample_args, device="cpu", data=feeder),
                  allow_pickle=True).item()
    assert res["output"].shape == (2, J, F, Tc) and np.isfinite(res["motion"]).all()


def test_unported_cross_attention_still_raises():
    """The encoder's self-attention is the only non-causal attention the
    port runs: cross-attention over several keys stays unported."""
    layer = cmdm.CMDM(**_kwargs()).seqTransEncoder.layers[0].self_attn
    x, memory = torch.randn(2, 5, 64), torch.randn(2, 3, 64)
    with pytest.raises(NotImplementedError, match="cross-attention"):
        layer(x, memory)
