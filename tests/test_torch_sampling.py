"""regennet_torch.diffusion samplers against the JAX package's loops.

Both sides run the same analytic denoiser; the port is fed the JAX
loop's exact noise stream (the init x and one z per step, replicated as
tests/test_reference_golden.py does). Tolerance 1e-4 on the final sample
(f32 coefficient arithmetic in different op orders over the steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regennet_tpu.diffusion import DiffusionConfig as JConfig
from regennet_tpu.diffusion import make_schedule as jmake_schedule
from regennet_tpu.diffusion import sampling as jsampling
from regennet_torch.diffusion import DiffusionConfig, make_schedule, sampling

SHAPE = (2, 5, 3, 8)
ATOL = 1e-4


def _replicate_loop_noise(key, shape, num_steps):
    """The JAX loops' PRNG stream: init noise, then one z per step."""
    rng, init_rng = jax.random.split(key)
    x0 = np.asarray(jax.random.normal(init_rng, shape, dtype=jnp.float32))
    zs = []
    for _ in range(num_steps):
        rng, step_rng = jax.random.split(rng)
        zs.append(np.asarray(jax.random.normal(step_rng, shape, dtype=jnp.float32)))
    return x0, zs


def _jax_model(x, t, cond):
    return jnp.tanh(0.5 * x + 1e-3 * t[:, None, None, None]) + cond["bias"]


def _jax_model_fn():
    fn = lambda x, t, cond: _jax_model(x, t, cond)  # noqa: E731
    fn.prepare = lambda cond: {**cond, "bias": 0.1 * cond["c"]}
    return fn


def _torch_model_fn():
    def fn(x, t, cond):
        return torch.tanh(0.5 * x + 1e-3 * t[:, None, None, None]) + cond["bias"]

    fn.prepare = lambda cond: {**cond, "bias": 0.1 * cond["c"]}
    return fn


def _cond(seed=0):
    c = np.random.default_rng(seed).normal(size=SHAPE).astype(np.float32)
    return {"c": jnp.asarray(c)}, {"c": torch.tensor(c)}


@pytest.mark.parametrize("var_type", ["fixed_small", "fixed_large"])
@pytest.mark.parametrize("respacing", ["10", "ddim5"])
@pytest.mark.parametrize("clip", [False, True])
def test_p_sample_loop_matches_jax(var_type, respacing, clip):
    jsched = jmake_schedule("cosine", 1000, timestep_respacing=respacing)
    sched = make_schedule("cosine", 1000, timestep_respacing=respacing)
    key = jax.random.PRNGKey(7)
    jcond, tcond = _cond()
    ref = np.asarray(jsampling.p_sample_loop(
        jsched, JConfig(model_var_type=var_type), _jax_model_fn(), SHAPE, key,
        jcond, clip_denoised=clip,
    ))
    x0, zs = _replicate_loop_noise(key, SHAPE, sched.num_timesteps)
    ours = sampling.p_sample_loop(
        sched, DiffusionConfig(model_var_type=var_type), _torch_model_fn(),
        SHAPE, tcond, clip_denoised=clip, noise=torch.tensor(x0),
        step_noise=[torch.tensor(z) for z in zs],
    )
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_sample_loop_matches_jax(eta):
    jsched = jmake_schedule("cosine", 1000, timestep_respacing="ddim10")
    sched = make_schedule("cosine", 1000, timestep_respacing="ddim10")
    key = jax.random.PRNGKey(3)
    jcond, tcond = _cond(1)
    ref = np.asarray(jsampling.ddim_sample_loop(
        jsched, JConfig(), _jax_model_fn(), SHAPE, key, jcond,
        clip_denoised=False, eta=eta,
    ))
    x0, zs = _replicate_loop_noise(key, SHAPE, sched.num_timesteps)
    ours = sampling.ddim_sample_loop(
        sched, DiffusionConfig(), _torch_model_fn(), SHAPE, tcond,
        clip_denoised=False, noise=torch.tensor(x0),
        step_noise=[torch.tensor(z) for z in zs], eta=eta,
    )
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("loop", ["p_sample_loop", "ddim_sample_loop"])
def test_partial_noise_start_matches_jax(loop):
    """skip_timesteps + init_image: start from q_sample(init_image, T-skip-1)."""
    jsched = jmake_schedule("cosine", 1000, timestep_respacing="10")
    sched = make_schedule("cosine", 1000, timestep_respacing="10")
    key = jax.random.PRNGKey(11)
    jcond, tcond = _cond(2)
    init = np.random.default_rng(5).normal(size=SHAPE).astype(np.float32)
    skip = 4
    ref = np.asarray(getattr(jsampling, loop)(
        jsched, JConfig(), _jax_model_fn(), SHAPE, key, jcond,
        clip_denoised=False, skip_timesteps=skip, init_image=jnp.asarray(init),
    ))
    x0, zs = _replicate_loop_noise(key, SHAPE, sched.num_timesteps - skip)
    ours = getattr(sampling, loop)(
        sched, DiffusionConfig(), _torch_model_fn(), SHAPE, tcond,
        clip_denoised=False, noise=torch.tensor(x0),
        step_noise=[torch.tensor(z) for z in zs], skip_timesteps=skip,
        init_image=torch.tensor(init),
    )
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=ATOL)


def test_schedule_matches_jax():
    for respacing in ["", "25", "ddim50", "10,5"]:
        j = jmake_schedule("cosine", 1000, timestep_respacing=respacing)
        t = make_schedule("cosine", 1000, timestep_respacing=respacing)
        assert t.num_timesteps == j.num_timesteps
        np.testing.assert_array_equal(t.timestep_map.numpy(), j.timestep_map)
        for name in ("betas", "alphas_cumprod_prev", "posterior_mean_coef1",
                     "posterior_mean_coef2", "posterior_log_variance_clipped",
                     "fixed_large_log_variance", "sqrt_recipm1_alphas_cumprod"):
            np.testing.assert_array_equal(getattr(t, name).numpy(),
                                          np.asarray(getattr(j, name)), err_msg=name)


def test_generator_draws_are_reproducible_and_consume_every_step():
    sched = make_schedule("cosine", 1000, timestep_respacing="5")
    cfg = DiffusionConfig()
    _, tcond = _cond()

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return sampling.p_sample_loop(sched, cfg, _torch_model_fn(), SHAPE, tcond,
                                      clip_denoised=False, generator=gen)

    torch.testing.assert_close(run(0), run(0), rtol=0, atol=0)
    assert not torch.equal(run(0), run(1))
    # handed-in noise: exactly one z per step, and too few raise
    zs = [torch.zeros(SHAPE)] * (sched.num_timesteps - 1)
    with pytest.raises(ValueError, match="fewer z"):
        sampling.p_sample_loop(sched, cfg, _torch_model_fn(), SHAPE, tcond,
                               noise=torch.zeros(SHAPE), step_noise=zs)
