"""regennet_torch's gru and mlp CMDM trunks against the JAX package's.

Weights are made by the Flax init and carried to the port with
cmdm_state_dict_from_flax; both models run the same numpy inputs.
Tolerances, each scaled by max(1, max|JAX output|):
* f32 forward: 1e-5 (rtol 1e-5 as well): f32 matmul sums in other orders;
* bf16 forward: 2^-6, two bf16 ulps of the largest output: torch's GRU and
  LayerNorm keep some intermediates in f32 where XLA rounds them to bf16,
  and the rounding differences reach the output through the trunk.
The train steps compare as tests/test_torch_training.py does, over two
steps from the same initial state, so that a GRU bias trained twice over
(torch's b_ih and b_hh against flax's single r/z bias) shows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regennet_tpu.convert.torch_ckpt import convert_cmdm
from regennet_tpu.diffusion.schedule import DiffusionConfig as JConfig
from regennet_tpu.diffusion.schedule import make_schedule as jmake_schedule
from regennet_tpu.models import cmdm as jcmdm
from regennet_tpu.train import training_loop as jtl
from regennet_torch.convert.from_flax import cmdm_state_dict_from_flax, train_state_from_flax
from regennet_torch.diffusion.schedule import DiffusionConfig, make_schedule
from regennet_torch.models import cmdm
from regennet_torch.train import training_loop
from tests.test_torch_training import _cli_args, _decoder, _loader

B, J, F, T = 3, 56, 6, 12
D = 64
ARCHS = ["gru", "mlp"]
LR, WD, EMA = 1e-3, 0.1, 0.99
# the velocity term on, the joint-decode terms off: the decode is the
# trunks' common tail, which tests/test_torch_training.py holds
LAMBDAS = dict(lambda_rcxyz=0.0, lambda_vel=1.0, lambda_fc=0.0, lambda_orient=0.0,
               lambda_body=0.0, lambda_transl=0.0)


def _kwargs(arch, **over):
    kw = dict(njoints=J, nfeats=F, num_actions=8, num_frames=T, latent_dim=D,
              ff_size=128, num_layers=2, num_heads=4, arch=arch, cm_mode="add",
              cond_mode="action", cond_mask_prob=0.1)
    kw.update(over)
    return kw


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, J, F, T)).astype(np.float32)
    cmotion = (rng.normal(size=(B, J, F, T)) * 0.5).astype(np.float32)
    return x, np.array([3, 500, 999]), cmotion, np.array([[1], [5], [7]])


def _jcond(cmotion, action, **extra):
    return {"cmotion": jnp.asarray(cmotion), "action": jnp.asarray(action), **extra}


def _tcond(cmotion, action, **extra):
    return {"cmotion": torch.tensor(cmotion), "action": torch.tensor(action), **extra}


def _init(jm, seed=0):
    x, t, cmotion, action = _inputs()
    return jm.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(t),
                   _jcond(cmotion, action))["params"]


def _port(params, **kw):
    sd = cmdm_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params))
    tm = cmdm.CMDM(**kw)
    tm.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    return tm


def _hold(ours, ref, tol):
    np.testing.assert_allclose(ours, ref, rtol=tol, atol=tol * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_flax(arch, dtype):
    jm = jcmdm.CMDM(**_kwargs(arch), dtype=getattr(jnp, dtype))
    params = _init(jm)
    tm = _port(params, **_kwargs(arch)).to(getattr(torch, dtype)).eval()
    x, t, cmotion, action = _inputs(1)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                              _jcond(cmotion, action)))
    with torch.no_grad():
        ours = tm(torch.tensor(x), torch.tensor(t), _tcond(cmotion, action))
    assert ours.dtype == torch.float32 and ours.shape == (B, J, F, T)
    _hold(ours.numpy(), ref, 1e-5 if dtype == "float32" else 2.0 ** -6)


@pytest.mark.parametrize("arch", ARCHS)
def test_cfg_model_fn_matches_flax(arch):
    """CFG's 2B forward, and prepare_cond, which leaves these trunks' cond
    as it is."""
    jm = jcmdm.CMDM(**_kwargs(arch))
    params = _init(jm)
    tm = _port(params, **_kwargs(arch)).eval()
    x, t, cmotion, action = _inputs(2)
    jfn = jcmdm.make_cfg_model_fn(jm, params, 2.5)
    ref = np.asarray(jfn(jnp.asarray(x), jnp.asarray(t), jfn.prepare(_jcond(cmotion, action))))
    fn = cmdm.make_cfg_model_fn(tm, 2.5)
    cond = _tcond(cmotion, action)
    assert fn.prepare(cond) is cond
    _hold(fn(torch.tensor(x), torch.tensor(t), cond).numpy(), ref, 4e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_state_dict_round_trips_through_convert_cmdm(arch):
    params = jax.tree_util.tree_map(np.asarray, _init(jcmdm.CMDM(**_kwargs(arch)), 1))
    sd = cmdm_state_dict_from_flax(params)
    back = convert_cmdm(dict(sd), arch=arch)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    assert set(sd) == set(cmdm.CMDM(**_kwargs(arch)).state_dict())
    if arch == "gru":  # flax's r/z bias lives in bias_ih
        for i in range(2):
            assert not sd[f"gru.bias_hh_l{i}"][: 2 * D].any()
            np.testing.assert_array_equal(sd[f"gru.bias_hh_l{i}"][2 * D:],
                                          params[f"GRUCell_{i}"]["hn"]["bias"])
    else:
        assert sd["mlp.motion_mlp.mlps.0.fc0.weight"].shape == (T, T, 1)
        assert "mlp.motion_mlp.mlps.0.conct.weight" in sd
        assert "mlp.motion_mlp.mlps.1.conct.weight" not in sd


def _batch(seed):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, 1, 1, T), bool)
    mask[2, ..., 9:] = False
    return {
        "motion": rng.normal(size=(B, J, F, T)).astype(np.float32),
        "t": np.array([7, 420, 990], np.int32),
        "weights": np.array([1.0, 0.7, 1.3], np.float32),
        "cond": {"mask": mask,
                 "cmotion": rng.normal(size=(B, J, F, T)).astype(np.float32),
                 "action": np.array([[1], [4], [6]])},
    }


def _torch_batch(batch):
    return {"motion": torch.tensor(batch["motion"]), "t": torch.tensor(batch["t"]).long(),
            "weights": torch.tensor(batch["weights"]),
            "cond": {k: torch.tensor(v) for k, v in batch["cond"].items()}}


@pytest.mark.parametrize("arch", ARCHS)
def test_two_train_steps_match_jax(arch):
    """Two make_train_step steps: each port step starts from the JAX state
    before it (the first from the initial state, whose Adam moments are
    zero) and takes the JAX step's batch and noise; its loss, gradients,
    updated parameters, EMA and AdamW moments are held against the JAX
    state after it. For the GRU the r/z slices of each bias_hh stay where
    they were, and the first step shows a bias trained twice over."""
    kw = _kwargs(arch, dropout=0.0, cond_mask_prob=0.0)
    jm = jcmdm.CMDM(**kw)
    batches = [_batch(1), _batch(2)]
    params = _init(jm)
    jsched, jcfg = jmake_schedule("cosine", 1000), JConfig(**LAMBDAS)
    opt = jtl.make_optimizer(LR, WD, 0)
    jdec = _decoder("jax")
    step_fn = jax.jit(jtl.make_train_step(jm, jsched, jcfg, opt, jdec, ema_rate=EMA))
    states = [dict(params=params, opt_state=opt.init(params),
                   ema_params=jax.tree_util.tree_map(jnp.array, params),
                   step=jnp.zeros((), jnp.int32))]
    rng = jax.random.PRNGKey(7)
    jmetrics = []
    for b in batches:
        state, m = jax.device_get(step_fn(states[-1], b, rng))
        states.append(state)
        jmetrics.append(m)

    def q_noise(s, b):  # the step's q_sample draw, as make_train_step derives it
        nrng = jax.random.split(jax.random.fold_in(rng, s), 3)[2]
        return np.asarray(jax.random.normal(nrng, b["motion"].shape, jnp.float32))

    for s, b in enumerate(batches):
        before, after = states[s], states[s + 1]
        # the JAX step's gradients, from its first moment: mu' = 0.9 mu +
        # 0.1 g (f32 rounding, about 1e-6 of max|g|, far inside the 2e-5)
        jgrads = cmdm_state_dict_from_flax(jax.tree_util.tree_map(
            lambda m1, m0: (np.asarray(m1, np.float64) - 0.9 * np.asarray(m0, np.float64))
            / 0.1, after["opt_state"][0].mu, before["opt_state"][0].mu))
        model = cmdm.CMDM(**kw)
        optimizer = training_loop.make_optimizer(model.parameters(), LR, WD)
        ema = {n: p.detach().clone() for n, p in model.named_parameters()}
        training_loop.load_train_state(model, optimizer, ema,
                                       train_state_from_flax(jax.device_get(before)))
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        step = training_loop.make_train_step(
            model, make_schedule("cosine", 1000), DiffusionConfig(**LAMBDAS), optimizer,
            _decoder("torch"), ema, ema_rate=EMA)
        metrics = step(_torch_batch(b), torch.Generator().manual_seed(s), s,
                       noise=torch.tensor(q_noise(s, b)))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(metrics[key]), float(jmetrics[s][key]),
                                       rtol=1e-5, err_msg=key)
        want = {k: cmdm_state_dict_from_flax(v) for k, v in (
            ("params", after["params"]), ("ema", after["ema_params"]),
            ("mu", after["opt_state"][0].mu), ("nu", after["opt_state"][0].nu))}
        named = dict(model.named_parameters())
        assert set(named) == set(jgrads)
        for name, p in named.items():
            jg = jgrads[name]
            np.testing.assert_allclose(p.grad.numpy(), jg, rtol=0,
                                       atol=2e-5 * max(1.0, np.abs(jg).max()), err_msg=name)
            st = optimizer.state[p]
            np.testing.assert_allclose(st["exp_avg"].numpy(), want["mu"][name], rtol=0,
                                       atol=2e-5 * max(1.0, np.abs(want["mu"][name]).max()),
                                       err_msg=name)
            # the second moment takes (1 - b2) g^2: its error carries the
            # gradient's, 2 |g| dg + dg^2 with dg the gradient's measured error
            noise = float(np.abs(p.grad.numpy() - jg).max())
            nu_diff = np.abs(st["exp_avg_sq"].numpy() - want["nu"][name])
            nu_tol = (1e-4 * np.abs(want["nu"][name]) + 1e-12
                      + (1 - 0.999) * (2 * np.abs(jg) * noise + noise ** 2))
            assert (nu_diff <= nu_tol).all(), (s, name, float((nu_diff / nu_tol).max()))
            # parameters within 1e-6, except where the gradient is within
            # 1000x of its own measured error (a relative error above 0.1%):
            # there Adam's step, a ratio of such sums (and on the first step
            # g / (|g| + eps)), may differ by up to lr
            diff = np.abs(p.detach().numpy() - want["params"][name])
            quiet = np.abs(jg) < 1e3 * noise
            assert (diff[~quiet] <= 1e-6).all(), (s, name, float(diff[~quiet].max()))
            assert (diff <= LR * 1.01).all(), (s, name)
            ema_diff = np.abs(ema[name].numpy() - want["ema"][name])
            assert (ema_diff <= 1e-6 + (1 - EMA) * diff).all(), (s, name)
        if arch == "gru":
            for i in range(2):
                name = f"gru.bias_hh_l{i}"
                assert torch.equal(named[name][: 2 * D], start[name][: 2 * D])
                assert not torch.equal(named[name][2 * D:], start[name][2 * D:])


def test_gru_bias_hh_rz_slices_take_no_gradient():
    """The hook zeroes the r/z slices of bias_hh's gradient on any
    backward, so AdamW leaves them (and their moments) where they are."""
    torch.manual_seed(0)
    model = cmdm.CMDM(**_kwargs("gru", dropout=0.0))
    x, t, cmotion, action = _inputs(3)
    out = model(torch.tensor(x), torch.tensor(t), _tcond(cmotion, action))
    out.square().mean().backward()
    for i in range(2):
        g = getattr(model.gru, f"bias_hh_l{i}").grad
        assert not g[: 2 * D].any() and g[2 * D:].abs().max() > 0
        assert getattr(model.gru, f"bias_ih_l{i}").grad[: 2 * D].abs().max() > 0


def test_trunks_refuse_what_jax_refuses():
    with pytest.raises(NotImplementedError, match="cm_mode"):
        cmdm.CMDM(**_kwargs("gru", cm_mode="concat"))
    model = cmdm.CMDM(**_kwargs("mlp")).eval()
    x, t, cmotion, action = _inputs()
    with pytest.raises(ValueError, match="built for 12 frames"):
        model(torch.tensor(x[..., :10]), torch.tensor(t), _tcond(cmotion[..., :10], action))
    # the mlp trunk ignores cm_mode: no fuse_process, as in the JAX package
    assert not hasattr(cmdm.CMDM(**_kwargs("mlp", cm_mode="concat")), "fuse_process")


@pytest.mark.parametrize("arch", ["unet", "transformer"])
def test_unknown_arch_raises(arch):
    with pytest.raises(ValueError, match="choose one of"):
        cmdm.CMDM(**_kwargs(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_and_sample_cli_on_cpu(tmp_path, arch):
    """train_mdm for 3 steps with --arch gru / mlp, then cgenerate on the
    saved checkpoint."""
    from argparse import Namespace

    from regennet_torch.data import synthetic
    from regennet_torch.data.feeder import Feeder
    from regennet_torch.sample import cgenerate
    from regennet_torch.train import train_mdm

    args = _cli_args(tmp_path, arch=arch, cm_mode="add", num_frames=T)
    loop = train_mdm.main(args, device="cpu", data=_loader(T=T))
    assert loop.model.arch == arch and loop.state_step == 3
    if arch == "gru":  # latent 32: the r/z slices are [:64], zero from init on
        assert not any(getattr(loop.model.gru, f"bias_hh_l{i}")[:64].any() for i in range(2))
    data = Feeder(clips=synthetic.make_clips("chi3d", "test", num_clips=6,
                                             min_len=T + 4, max_len=2 * T),
                  dataname="chi3d", split="test", num_frames=T, num_person=2)
    sample_args = Namespace(**{**vars(args), **dict(
        model_path=str(tmp_path / "save" / "model000000003.pt"), num_samples=2,
        num_repetitions=1, use_ddim=False, timestep_respacing="10",
        guidance_param=2.5, output_dir=str(tmp_path / "samples"), motion_length=60,
        input_text="", action_file="", text_prompt="", action_name="")})
    res = np.load(cgenerate.main(sample_args, device="cpu", data=data),
                  allow_pickle=True).item()
    assert res["output"].shape == (2, 56, 6, T) and np.isfinite(res["motion"]).all()
