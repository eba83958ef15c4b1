"""The diffusion core's remaining terms in regennet_torch against
regennet_tpu.diffusion: the learned variances and the epsilon and
previous_x mean types of p_mean_variance, denoised_fn, classifier
guidance (condition_mean in DDPM, condition_score in DDIM and PLMS),
const_noise, PLMS orders 1-4, the reverse DDIM loop, the variational-bound
terms and every loss type of training_losses.

Both sides run the same deterministic model_fn (written once per package)
or one CMDM whose Flax weights are carried over with
convert/from_flax.py; the port is fed the JAX loop's init noise and
per-step z. Tolerance: f32 within 1e-5 x max(1, max|jax|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regennet_tpu.diffusion import gaussian as jgaussian
from regennet_tpu.diffusion import losses as jlosses
from regennet_tpu.diffusion import sampling as jsampling
from regennet_tpu.diffusion.schedule import DiffusionConfig as JConfig
from regennet_tpu.diffusion.schedule import make_schedule as jmake_schedule
from regennet_tpu.models import cmdm as jcmdm
from regennet_torch.convert.from_flax import cmdm_state_dict_from_flax
from regennet_torch.diffusion import gaussian, losses, sampling
from regennet_torch.diffusion.schedule import DiffusionConfig, make_schedule
from regennet_torch.models import cmdm

SHAPE = (2, 4, 3, 6)
CMDM_KW = dict(njoints=8, nfeats=6, num_actions=4, num_frames=12, latent_dim=32,
               ff_size=64, num_layers=2, num_heads=2, arch="online", cm_mode="concat",
               cond_mode="action", cond_mask_prob=0.1)
CMDM_SHAPE = (2, 8, 6, 12)


def assert_close(ours, ref, what=""):
    ref = np.asarray(ref)
    ours = ours.detach().numpy() if torch.is_tensor(ours) else np.asarray(ours)
    assert ours.shape == ref.shape, what
    assert np.isfinite(ref).all(), what
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * max(1.0, np.abs(ref).max()),
                               err_msg=what)


def _var_head(var_type, x, lib):
    """The variance channels of the toy model: log variances for
    'learned', values in [-1, 1] for 'learned_range'."""
    if var_type == "learned":
        return -3.0 + 0.5 * lib.tanh(0.3 * x)
    return lib.tanh(0.3 * x)


def _jax_model(var_type="fixed_small"):
    def fn(x, t, cond):
        mean = jnp.tanh(0.5 * x + 1e-3 * t[:, None, None, None]) + cond["bias"]
        if var_type in ("learned", "learned_range"):
            return jnp.concatenate([mean, _var_head(var_type, x, jnp)], axis=1)
        return mean

    fn.prepare = lambda cond: {**cond, "bias": 0.1 * cond["c"]}
    return fn


def _torch_model(var_type="fixed_small"):
    def fn(x, t, cond):
        mean = torch.tanh(0.5 * x + 1e-3 * t[:, None, None, None]) + cond["bias"]
        if var_type in ("learned", "learned_range"):
            return torch.cat([mean, _var_head(var_type, x, torch)], dim=1)
        return mean

    fn.prepare = lambda cond: {**cond, "bias": 0.1 * cond["c"]}
    return fn


def _conds(seed=0):
    c = np.random.default_rng(seed).normal(size=SHAPE).astype(np.float32)
    return {"c": jnp.asarray(c), "bias": 0.1 * jnp.asarray(c)}, \
        {"c": torch.tensor(c), "bias": 0.1 * torch.tensor(c)}


def _loop_noise(key, shape, num_steps):
    """The JAX loops' PRNG stream: the init x, then one z per step."""
    rng, init_rng = jax.random.split(key)
    x0 = np.asarray(jax.random.normal(init_rng, shape, dtype=jnp.float32))
    zs = []
    for _ in range(num_steps):
        rng, step_rng = jax.random.split(rng)
        zs.append(torch.tensor(np.asarray(jax.random.normal(step_rng, shape,
                                                            dtype=jnp.float32))))
    return torch.tensor(x0), zs


def _target():
    return np.random.default_rng(9).normal(size=SHAPE).astype(np.float32)


def _jax_cond_fn(x, t, cond):
    target = jnp.asarray(_target())
    return jax.grad(lambda v: -0.5 * jnp.sum((v - target) ** 2) * 0.3)(x)


def _torch_cond_fn(x, t, cond):
    assert x.requires_grad and torch.is_grad_enabled()
    logp = -0.5 * ((x - torch.tensor(_target())) ** 2).sum() * 0.3
    return torch.autograd.grad(logp, x)[0]


def _jax_denoise(v):
    return 0.9 * v + 0.01


def _torch_denoise(v):
    return 0.9 * v + 0.01


def _scheds(respacing="10"):
    return (jmake_schedule("cosine", 1000, timestep_respacing=respacing),
            make_schedule("cosine", 1000, timestep_respacing=respacing))


# ---------------------------------------------------------------------------
# gaussian.py
# ---------------------------------------------------------------------------

def test_q_mean_variance_and_xstart_predictions_match_jax():
    jsched, sched = _scheds("")
    rng = np.random.default_rng(1)
    x0, xt, e = (rng.normal(size=SHAPE).astype(np.float32) for _ in range(3))
    t = np.array([0, 731])
    for ours, ref in zip(gaussian.q_mean_variance(sched, torch.tensor(x0), torch.tensor(t)),
                         jgaussian.q_mean_variance(jsched, jnp.asarray(x0), jnp.asarray(t))):
        assert_close(ours, ref, "q_mean_variance")
    for name in ("predict_xstart_from_eps", "predict_xstart_from_xprev"):
        assert_close(getattr(gaussian, name)(sched, torch.tensor(xt), torch.tensor(t),
                                             torch.tensor(e)),
                     getattr(jgaussian, name)(jsched, jnp.asarray(xt), jnp.asarray(t),
                                              jnp.asarray(e)), name)


@pytest.mark.parametrize("var_type", ["learned", "learned_range", "fixed_large"])
@pytest.mark.parametrize("mean_type", ["epsilon", "previous_x", "start_x"])
def test_p_mean_variance_matches_jax(var_type, mean_type):
    jsched, sched = _scheds("")
    jcond, tcond = _conds()
    x = np.random.default_rng(2).normal(size=SHAPE).astype(np.float32)
    t = np.array([0, 517])
    ref = jgaussian.p_mean_variance(
        jsched, JConfig(model_mean_type=mean_type, model_var_type=var_type),
        _jax_model(var_type), jnp.asarray(x), jnp.asarray(t, jnp.int32), jcond,
        clip_denoised=True, denoised_fn=_jax_denoise)
    ours = gaussian.p_mean_variance(
        sched, DiffusionConfig(model_mean_type=mean_type, model_var_type=var_type),
        _torch_model(var_type), torch.tensor(x), torch.tensor(t), tcond,
        clip_denoised=True, denoised_fn=_torch_denoise)
    for key in ("mean", "variance", "log_variance", "pred_xstart"):
        assert_close(ours[key], ref[key], key)


def test_condition_mean_and_score_match_jax():
    jsched, sched = _scheds("")
    jcond, tcond = _conds()
    x = np.random.default_rng(4).normal(size=SHAPE).astype(np.float32)
    t = np.array([3, 600])
    jcfg, cfg = JConfig(), DiffusionConfig()
    jout = jgaussian.p_mean_variance(jsched, jcfg, _jax_model(), jnp.asarray(x),
                                     jnp.asarray(t, jnp.int32), jcond)
    tout = gaussian.p_mean_variance(sched, cfg, _torch_model(), torch.tensor(x),
                                    torch.tensor(t), tcond)
    guided = sampling._with_grad(_torch_cond_fn)
    assert_close(gaussian.condition_mean(sched, cfg, guided, tout, torch.tensor(x),
                                         torch.tensor(t), tcond),
                 jgaussian.condition_mean(jsched, jcfg, _jax_cond_fn, jout, jnp.asarray(x),
                                          jnp.asarray(t, jnp.int32), jcond), "mean")
    ours = gaussian.condition_score(sched, cfg, guided, tout, torch.tensor(x),
                                    torch.tensor(t), tcond)
    ref = jgaussian.condition_score(jsched, jcfg, _jax_cond_fn, jout, jnp.asarray(x),
                                    jnp.asarray(t, jnp.int32), jcond)
    for key in ("mean", "pred_xstart"):
        assert_close(ours[key], ref[key], key)


# ---------------------------------------------------------------------------
# sampling.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("const_noise", [False, True])
def test_p_sample_loop_cond_fn_denoised_fn_const_noise_match_jax(const_noise):
    jsched, sched = _scheds("10")
    jcond, tcond = _conds(1)
    key = jax.random.PRNGKey(5)
    ref = jsampling.p_sample_loop(
        jsched, JConfig(model_var_type="learned_range"), _jax_model("learned_range"),
        SHAPE, key, {"c": jcond["c"]}, clip_denoised=False, denoised_fn=_jax_denoise,
        cond_fn=_jax_cond_fn, const_noise=const_noise)
    x0, zs = _loop_noise(key, SHAPE, sched.num_timesteps)
    ours = sampling.p_sample_loop(
        sched, DiffusionConfig(model_var_type="learned_range"),
        _torch_model("learned_range"), SHAPE, {"c": tcond["c"]}, clip_denoised=False,
        noise=x0, step_noise=zs, denoised_fn=_torch_denoise, cond_fn=_torch_cond_fn,
        const_noise=const_noise)
    assert not ours.requires_grad
    assert_close(ours, ref, "p_sample_loop")


def test_ddim_sample_loop_cond_fn_and_denoised_fn_match_jax():
    jsched, sched = _scheds("ddim10")
    jcond, tcond = _conds(2)
    key = jax.random.PRNGKey(6)
    ref = jsampling.ddim_sample_loop(
        jsched, JConfig(model_mean_type="epsilon"), _jax_model(), SHAPE, key,
        {"c": jcond["c"]}, clip_denoised=False, denoised_fn=_jax_denoise,
        cond_fn=_jax_cond_fn, eta=0.5)
    x0, zs = _loop_noise(key, SHAPE, sched.num_timesteps)
    ours = sampling.ddim_sample_loop(
        sched, DiffusionConfig(model_mean_type="epsilon"), _torch_model(), SHAPE,
        {"c": tcond["c"]}, clip_denoised=False, noise=x0, step_noise=zs,
        denoised_fn=_torch_denoise, cond_fn=_torch_cond_fn, eta=0.5)
    assert_close(ours, ref, "ddim_sample_loop")


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_plms_sample_loop_orders_match_jax(order):
    jsched, sched = _scheds("ddim10")
    jcond, tcond = _conds(3)
    key = jax.random.PRNGKey(order)
    cond_fns = (_jax_cond_fn, _torch_cond_fn) if order == 3 else (None, None)
    ref = jsampling.plms_sample_loop(
        jsched, JConfig(), _jax_model(), SHAPE, key, {"c": jcond["c"]},
        clip_denoised=False, order=order, cond_fn=cond_fns[0],
        denoised_fn=_jax_denoise if order == 4 else None)
    x0, _ = _loop_noise(key, SHAPE, 0)
    calls = []

    def counted(x, t, cond):
        calls.append(1)
        return _torch_model()(x, t, cond)

    counted.prepare = _torch_model().prepare
    ours = sampling.plms_sample_loop(
        sched, DiffusionConfig(), counted, SHAPE, {"c": tcond["c"]},
        clip_denoised=False, noise=x0, order=order, cond_fn=cond_fns[1],
        denoised_fn=_torch_denoise if order == 4 else None)
    assert len(calls) == sched.num_timesteps + (order > 1)
    assert_close(ours, ref, f"plms order {order}")
    with pytest.raises(ValueError, match="order"):
        sampling.plms_sample_loop(sched, DiffusionConfig(), counted, SHAPE, tcond,
                                  order=5)


@pytest.fixture(scope="module")
def cmdm_pair():
    """(JAX model_fn, port model_fn, JAX cond, port cond) on one CMDM's weights."""
    jm = jcmdm.CMDM(**CMDM_KW)
    rng = np.random.default_rng(0)
    cmotion = (0.5 * rng.normal(size=CMDM_SHAPE)).astype(np.float32)
    action = np.array([[1], [3]])
    jcond = {"cmotion": jnp.asarray(cmotion), "action": jnp.asarray(action)}
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros(CMDM_SHAPE), jnp.zeros((2,), jnp.int32),
                     jcond)["params"]
    sd = cmdm_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params))
    tm = cmdm.CMDM(**CMDM_KW).eval()
    tm.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    tcond = {"cmotion": torch.tensor(cmotion), "action": torch.tensor(action)}
    return jcmdm.make_model_fn(jm, params), cmdm.make_model_fn(tm), jcond, tcond


def test_plms_and_ddim_round_trip_on_a_cmdm_match_jax(cmdm_pair):
    jfn, tfn, jcond, tcond = cmdm_pair
    jsched, sched = _scheds("ddim10")
    key = jax.random.PRNGKey(11)
    ref = jsampling.plms_sample_loop(jsched, JConfig(), jfn, CMDM_SHAPE, key, jcond,
                                     clip_denoised=False, order=2)
    x0, _ = _loop_noise(key, CMDM_SHAPE, 0)
    ours = sampling.plms_sample_loop(sched, DiffusionConfig(), tfn, CMDM_SHAPE, tcond,
                                     clip_denoised=False, noise=x0, order=2)
    assert_close(ours, ref, "plms on the CMDM")

    # the reverse loop encodes the PLMS sample; DDIM (eta 0) decodes it again
    xT_ref = jsampling.ddim_reverse_sample_loop(jsched, JConfig(), jfn, ref, jcond,
                                                clip_denoised=False)
    xT = sampling.ddim_reverse_sample_loop(sched, DiffusionConfig(), tfn,
                                           torch.tensor(np.asarray(ref)), tcond,
                                           clip_denoised=False)
    assert_close(xT, xT_ref, "ddim_reverse_sample_loop")
    back = sampling.ddim_sample_loop(sched, DiffusionConfig(), tfn, CMDM_SHAPE, tcond,
                                     clip_denoised=False, noise=xT,
                                     step_noise=[torch.zeros(CMDM_SHAPE)] * 10)
    back_ref = jsampling.ddim_sample_loop(jsched, JConfig(), jfn, CMDM_SHAPE, key, jcond,
                                          clip_denoised=False, noise=xT_ref)
    assert_close(back, back_ref, "the round trip's decode")


# ---------------------------------------------------------------------------
# losses.py
# ---------------------------------------------------------------------------

def test_kl_and_discretized_likelihood_match_jax():
    rng = np.random.default_rng(5)
    m1, l1, m2, l2 = (rng.normal(size=(3, 7)).astype(np.float32) for _ in range(4))
    assert_close(losses.normal_kl(*map(torch.tensor, (m1, l1, m2, l2))),
                 jlosses.normal_kl(*map(jnp.asarray, (m1, l1, m2, l2))), "normal_kl")
    assert_close(losses.normal_kl(torch.tensor(m1), torch.tensor(l1), 0.0, 0.0),
                 jlosses.normal_kl(jnp.asarray(m1), jnp.asarray(l1), 0.0, 0.0), "prior kl")
    # both edge branches and the bin probability; inside the bins the
    # standardised distance stays below 1, where cdf_plus - cdf_min does
    # not cancel to the last bits of f32 (there either package's value is
    # the rounding of its tanh)
    x = np.concatenate([np.array([-1.0, -0.9995, 0.0, 0.9995, 1.0]),
                        rng.uniform(-0.5, 0.5, 30)]).astype(np.float32)
    means = rng.normal(size=x.shape).astype(np.float32) * 0.1
    log_scales = rng.uniform(-0.5, 0.5, x.shape).astype(np.float32)
    assert_close(losses._approx_standard_normal_cdf(torch.tensor(means * 10)),
                 jlosses._approx_standard_normal_cdf(jnp.asarray(means * 10)), "cdf")
    assert_close(losses.discretized_gaussian_log_likelihood(
        torch.tensor(x), means=torch.tensor(means), log_scales=torch.tensor(log_scales)),
        jlosses.discretized_gaussian_log_likelihood(
            jnp.asarray(x), means=jnp.asarray(means), log_scales=jnp.asarray(log_scales)),
        "discretized_gaussian_log_likelihood")


def _model_output(jsched, var_type, x0, t, rng):
    """A model output [B, C or 2C, F, T] for x_0 prediction: the variance
    channels in their range; at t = 0, where the term is the decoder's
    likelihood of x_0 in bins of 2/255, the predicted x_0 lies within a
    fifth of the decoder's standard deviation of x_0, as a trained model's
    would. Farther out the bin probability is the difference of two CDF
    values within a few ulps of 1, and either package's f32 value is the
    rounding of its tanh."""
    C = x0.shape[1]
    learned = var_type.startswith("learned")
    out = rng.normal(size=(x0.shape[0], 2 * C if learned else C) + x0.shape[2:])
    if var_type == "learned":
        out[:, C:] = -3.0 + 0.5 * np.tanh(out[:, C:])
        log_var = out[:, C:]
    elif var_type == "learned_range":
        out[:, C:] = np.tanh(out[:, C:])
        frac = (out[:, C:] + 1) / 2
        log_var = (frac * np.log(np.asarray(jsched.betas))[0]
                   + (1 - frac) * np.asarray(jsched.posterior_log_variance_clipped)[0])
    else:
        log_var = np.asarray(jsched.posterior_log_variance_clipped)[0] * np.ones_like(x0)
    first = t == 0
    out[first, :C] = x0[first] + 0.2 * np.exp(0.5 * log_var[first]) * rng.normal(
        size=x0[first].shape)
    return out.astype(np.float32)


@pytest.mark.parametrize("var_type", ["learned_range", "fixed_small"])
def test_vb_terms_and_prior_bpd_match_jax(var_type):
    jsched, sched = _scheds("")
    rng = np.random.default_rng(6)
    x0 = np.clip(rng.normal(size=SHAPE), -1, 1).astype(np.float32)
    xt = rng.normal(size=SHAPE).astype(np.float32)
    t = np.array([0, 421])
    out = _model_output(jsched, var_type, x0, t, rng)
    ref = jlosses.vb_terms_bpd(jsched, JConfig(model_var_type=var_type),
                               lambda *a: jnp.asarray(out), jnp.asarray(x0), jnp.asarray(xt),
                               jnp.asarray(t, jnp.int32), {})
    ours = losses.vb_terms_bpd(sched, DiffusionConfig(model_var_type=var_type),
                               lambda *a: torch.tensor(out), torch.tensor(x0),
                               torch.tensor(xt), torch.tensor(t), {})
    for key in ("output", "pred_xstart"):
        assert_close(ours[key], ref[key], key)
    assert_close(losses.prior_bpd(sched, torch.tensor(x0)),
                 jlosses.prior_bpd(jsched, jnp.asarray(x0)), "prior_bpd")


def test_calc_bpd_loop_on_a_cmdm_matches_jax(cmdm_pair):
    jfn, tfn, jcond, tcond = cmdm_pair
    jsched, sched = _scheds("10")
    x0 = np.clip(np.random.default_rng(7).normal(size=CMDM_SHAPE), -1, 1).astype(np.float32)
    key = jax.random.PRNGKey(13)
    ref = jlosses.calc_bpd_loop(jsched, JConfig(), jfn, jnp.asarray(x0), key, jcond)
    # the JAX loop's draws: one split per step, t = T-1 first
    rng, draws = key, []
    for _ in range(sched.num_timesteps):
        rng, srng = jax.random.split(rng)
        draws.append(torch.tensor(np.asarray(jax.random.normal(srng, x0.shape, jnp.float32))))
    ours = losses.calc_bpd_loop(sched, DiffusionConfig(), tfn, torch.tensor(x0), tcond,
                                step_noise=draws)
    assert set(ours) == set(ref) == {"total_bpd", "prior_bpd", "vb", "xstart_mse", "mse"}
    assert ours["vb"].shape == (2, sched.num_timesteps)
    for key_ in ref:
        assert_close(ours[key_], ref[key_], key_)


@pytest.mark.parametrize("loss_type,var_type", [
    ("kl", "fixed_small"), ("rescaled_kl", "learned_range"), ("mse", "learned"),
    ("rescaled_mse", "learned_range"), ("rescaled_mse", "fixed_large")])
def test_training_losses_every_loss_type_matches_jax(loss_type, var_type):
    """Each term and the gradient of the summed loss with respect to the
    model output: the vb term reaches only the variance channels."""
    jsched, sched = _scheds("50")
    rng = np.random.default_rng(8)
    x0 = np.clip(rng.normal(size=SHAPE), -1, 1).astype(np.float32)
    noise = rng.normal(size=SHAPE).astype(np.float32)
    t = np.array([0, 31])
    out = _model_output(jsched, var_type, x0, t, rng)
    mask = np.ones((SHAPE[0], 1, 1, SHAPE[3]), bool)
    mask[1, ..., 4:] = False
    kw = dict(loss_type=loss_type, model_var_type=var_type)

    def jloss(o):
        terms = jlosses.training_losses(jsched, JConfig(**kw), lambda *a: o, jnp.asarray(x0),
                                        jnp.asarray(t, jnp.int32), {"mask": jnp.asarray(mask)},
                                        None, noise=jnp.asarray(noise))
        return jnp.sum(terms["loss"]), terms

    jgrad, jterms = jax.grad(jloss, has_aux=True)(jnp.asarray(out))
    to = torch.tensor(out, requires_grad=True)
    terms = losses.training_losses(sched, DiffusionConfig(**kw), lambda *a: to,
                                   torch.tensor(x0), torch.tensor(t),
                                   {"mask": torch.tensor(mask)}, torch.tensor(noise))
    terms["loss"].sum().backward()
    assert set(terms) == set(jterms)
    assert ("vb" in terms) == (var_type.startswith("learned") and not loss_type.endswith("kl"))
    for name in jterms:
        assert_close(terms[name], jterms[name], name)
    assert_close(to.grad, jgrad, "gradient")
