"""The GAN of regennet_torch (models/actor_gan.py) against the JAX
package's, on the CPU at small widths: G and D forwards, the noise
family, the upsample, one d_step and g_step in each loss mode with the
penalty's alpha fed in from JAX, and B2's second-order Function (the
backward of the training attention, differentiated once more) against
autograd and jax.grad. f32, within 1e-5 x max(1, max|jax|) unless stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regennet_tpu.models import actor_gan as jgan
from regennet_torch.convert.from_flax import actor_gan_state_dict_from_flax
from regennet_torch.models import actor_gan as gan
from regennet_torch.models import transformer as tfm
from regennet_torch.ops import attention as A
from tests.test_torch_actor_cvae import close

J, C, NA, T, NN, Z = 5, 6, 4, 12, 4, 3
WIDTH = dict(latent_dim=32, ff_size=64, num_layers=2, num_heads=4)
B = 3


def _pair(jmodel, model, *inputs, seed=0):
    """Init the Flax module, load its params into the port's module."""
    params = jmodel.init(jax.random.PRNGKey(seed), *map(jnp.asarray, inputs))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    model.load_state_dict({k: torch.tensor(v) for k, v in
                           actor_gan_state_dict_from_flax(params).items()}, strict=True)
    return params


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    noise = gan.gen_noise(rng, B, NN, Z, mode="gp", length_scale=3.0)
    x = (0.5 * rng.normal(size=(B, J, C, T))).astype(np.float32)
    y = np.asarray([0, 3, 1])
    y_fake = np.asarray([2, 2, 0])
    return noise, x, y, y_fake


def _models():
    jG = jgan.Generator(njoints=J, nfeats=C, num_actions=NA, num_frames=T, **WIDTH)
    jD = jgan.Discriminator(njoints=J, nfeats=C, num_actions=NA, **WIDTH)
    G = gan.Generator(J, C, NA, T, noise_dim=Z, **WIDTH)
    D = gan.Discriminator(J, C, NA, **WIDTH)
    return jG, jD, G, D


@pytest.mark.parametrize("train_route", [False, True])
def test_generator_and_discriminator_match_flax(train_route):
    """Both forwards, on the sampling route (B1's plain version) and the
    train route (B2's at rate 0)."""
    noise, x, y, _ = _inputs()
    jG, jD, G, D = _models()
    pg = _pair(jG, G, noise, y)
    pd = _pair(jD, D, x, y, seed=1)
    gen = torch.Generator().manual_seed(0) if train_route else None
    close(G(torch.tensor(noise), torch.tensor(y), gen).detach(),
          jG.apply({"params": pg}, jnp.asarray(noise), jnp.asarray(y)), what="G")
    close(D(torch.tensor(x), torch.tensor(y), gen).detach(),
          jD.apply({"params": pd}, jnp.asarray(x), jnp.asarray(y)), what="D")


@pytest.mark.parametrize("mode", ["independent", "independent_2", "independent_3", "constant",
                                  "gaussian", "gp", "multi_gp", "gp_single_scale"])
def test_gen_noise_is_bit_equal(mode):
    kw = dict(lambda_noise=0.7, mode=mode, length_scale=5.0, n_person=2)
    ours = gan.gen_noise(np.random.default_rng(4), 3, 6, 4, **kw)
    ref = jgan.gen_noise(np.random.default_rng(4), 3, 6, 4, **kw)
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("frames", [60, 61, 16])
def test_upsample_matches_jax_resize(frames):
    h = np.random.default_rng(0).normal(size=(2, 16, 8)).astype(np.float32)
    ours = gan.upsample_linear(torch.tensor(h), frames)
    close(ours, jax.image.resize(jnp.asarray(h), (2, frames, 8), method="linear"))


def test_upsample_raises_when_it_would_downsample():
    with pytest.raises(ValueError, match="antialiases"):
        gan.upsample_linear(torch.zeros(1, 16, 4), 15)


def _grads_from_adam(opt_state, beta1):
    """The gradients of a first AdamW step, from its first moment."""
    return jax.tree_util.tree_map(lambda m: np.asarray(m) / (1.0 - beta1), opt_state[0].mu)


def _check_update(module, before, grads_ref, params_ref, lr):
    """train_cvae's bounds: gradients within 1e-3 x max|g|; parameters within
    1e-5 x max(1, max|p|), or 2 lr more where |g| <= 1e-4 x max|g| (Adam
    takes the sign there)."""
    grads = actor_gan_state_dict_from_flax(grads_ref)
    after = actor_gan_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params_ref))
    state = module.state_dict()
    moved = 0
    for name, p in module.named_parameters():
        g_ref = grads[name]
        g_scale = max(float(np.abs(g_ref).max()), 1e-30)
        close(p.grad, g_ref, scale=1e-3 * g_scale, what=f"grad {name}")
        err = np.abs(state[name].numpy() - after[name])
        tol = 1e-5 * max(1.0, float(np.abs(after[name]).max()))
        noise_mask = np.abs(g_ref) <= 1e-4 * g_scale
        assert err[~noise_mask].max(initial=0.0) <= tol, (name, float(err.max()))
        assert err[noise_mask].max(initial=0.0) <= 2 * lr + tol, name
        moved += not torch.equal(before[name], state[name])
    assert moved > 0


@pytest.mark.parametrize("loss_mode", ["hinge", "wgan-gp"])
def test_d_step_and_g_step_match_jax(loss_mode):
    noise, x, y, y_fake = _inputs(1)
    jG, jD, G, D = _models()
    pg = _pair(jG, G, noise, y)
    pd = _pair(jD, D, x, y, seed=1)
    lr, mult, beta1, wd = 2e-4, 4.0, 0.5, 1e-3
    jopt_d, jopt_g = jgan.make_optimizers(lr, mult, beta1, wd)
    jd_step, jg_step = jgan.make_gan_steps(jG, jD, jopt_d, jopt_g, loss_mode=loss_mode)
    opt_d, opt_g = gan.make_optimizers(D, G, lr, mult, beta1, wd)
    d_step, g_step = gan.make_gan_steps(G, D, opt_d, opt_g, loss_mode=loss_mode,
                                        generator=torch.Generator().manual_seed(0))

    key = jax.random.PRNGKey(7)
    alpha = np.asarray(jax.random.uniform(key, (B, 1, 1, 1), jnp.float32))
    new_pd, sd, ref = jd_step(pd, jopt_d.init(pd), pg, jnp.asarray(x), jnp.asarray(y),
                              jnp.asarray(noise), jnp.asarray(y_fake), key)
    before = {k: v.clone() for k, v in D.state_dict().items()}
    ours = d_step(torch.tensor(x), torch.tensor(y), torch.tensor(noise), torch.tensor(y_fake),
                  alpha=torch.tensor(alpha))
    assert set(ours) == set(ref)
    for k in ref:
        close(ours[k], ref[k], what=k)
    _check_update(D, before, _grads_from_adam(sd, beta1), new_pd, lr * mult)

    noise2, _, _, _ = _inputs(2)
    y_fake2 = np.asarray([1, 0, 3])
    new_pg, sg, ref = jg_step(pg, jopt_g.init(pg), new_pd, jnp.asarray(noise2),
                              jnp.asarray(y_fake2))
    before = {k: v.clone() for k, v in G.state_dict().items()}
    d_before = {k: v.clone() for k, v in D.state_dict().items()}
    ours = g_step(torch.tensor(noise2), torch.tensor(y_fake2))
    assert set(ours) == set(ref)
    for k in ref:
        close(ours[k], ref[k], what=k)
    _check_update(G, before, _grads_from_adam(sg, beta1), new_pg, lr)
    # D is frozen in the G step
    assert all(torch.equal(d_before[k], v) for k, v in D.state_dict().items())


class _TrainOnCpu(torch.autograd.Function):
    """B2 on the CPU as the GPU runs it under autograd: the plain forward,
    and a backward through `_AttentionTrainBackward` (here with the plain
    first backward inside it), so a second derivative goes through the
    closed-form second-order term."""

    @staticmethod
    def forward(ctx, q, k, v, seed, cfg):
        ctx.save_for_backward(q, k, v, seed)
        ctx.cfg = cfg
        with torch.no_grad():
            return A.attention_btd_train_reference(q, k, v, cfg.num_heads, cfg.rate, seed,
                                                   cfg.causal, cfg.softmax_f32)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seed = ctx.saved_tensors
        dq, dk, dv = A._AttentionTrainBackward.apply(q, k, v, dout.contiguous(), seed, ctx.cfg)
        return dq, dk, dv, None, None


def _train_attention_via_function(q, k, v, num_heads, rate, seed, causal=True,
                                  softmax_f32=False, kv_len=None):
    return _TrainOnCpu.apply(q, k, v, seed,
                             A._TrainConfig(num_heads, float(rate), causal, softmax_f32, 0))


@pytest.mark.parametrize("rate,causal", [(0.0, False), (0.25, True)])
def test_second_order_function_matches_autograd(rate, causal):
    """_AttentionTrainBackward's VJP against autograd's double backward of
    the plain training attention (f32, 1e-5 x max(1, max|autograd|))."""
    g = torch.Generator().manual_seed(3)
    Bq, Tq, Dq, H = 2, 9, 16, 2
    q, k, v, dout = (torch.randn(Bq, Tq, Dq, generator=g).requires_grad_() for _ in range(4))
    cot = [torch.randn(Bq, Tq, Dq, generator=g) for _ in range(3)]
    seed = torch.tensor([[5, -7], [11, 13]], dtype=torch.int32)
    cfg = A._TrainConfig(H, rate, causal, False, 0)
    out = A._AttentionTrainBackward.apply(q, k, v, dout, seed, cfg)
    ours = torch.autograd.grad(sum((o * c).sum() for o, c in zip(out, cot)), (q, k, v, dout))
    plain = A.attention_btd_train_reference(q, k, v, H, rate, seed, causal)
    first = torch.autograd.grad(plain, (q, k, v), dout, create_graph=True)
    ref = torch.autograd.grad(sum((o * c).sum() for o, c in zip(first, cot)), (q, k, v, dout))
    for name, a, b in zip(("q", "k", "v", "dout"), ours, ref):
        close(a, b.detach(), what=name)


def test_penalty_through_the_second_order_function_matches_jax(monkeypatch):
    """gradient_penalty's gradient in D's parameters, with each self-attention
    differentiated through _AttentionTrainBackward, against jax.grad of the
    JAX package's gradient_penalty (gradients within 1e-4 x max|g|)."""
    monkeypatch.setattr(tfm, "fused_attention_btd_train", _train_attention_via_function)
    noise, x, y, y_fake = _inputs(3)
    jG, jD, G, D = _models()
    pg = _pair(jG, G, noise, y)
    pd = _pair(jD, D, x, y, seed=1)
    fake = np.asarray(jG.apply({"params": pg}, jnp.asarray(noise), jnp.asarray(y_fake)))
    key = jax.random.PRNGKey(5)
    alpha = np.asarray(jax.random.uniform(key, (B, 1, 1, 1), jnp.float32))
    ref_gp, ref_g = jax.value_and_grad(
        lambda p: jgan.gradient_penalty(jD, p, jnp.asarray(x), jnp.asarray(fake),
                                        jnp.asarray(y_fake), key))(pd)
    gp = gan.gradient_penalty(D, torch.tensor(x), torch.tensor(fake), torch.tensor(y_fake),
                              torch.tensor(alpha), torch.Generator().manual_seed(0))
    close(gp.detach(), ref_gp, what="penalty")
    names = [n for n, _ in D.named_parameters()]
    # psi's bias shifts D(x) by a constant: no part in the penalty
    grads = torch.autograd.grad(gp, list(D.parameters()), allow_unused=True)
    ref = actor_gan_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, ref_g))
    attn = [n for n in names if "self_attn" in n]
    assert attn
    for name, gr, p in zip(names, grads, D.parameters()):
        gr = torch.zeros_like(p) if gr is None else gr
        scale = max(float(np.abs(ref[name]).max()), 1e-30)
        close(gr, ref[name], scale=1e-4 * scale, what=name)


def test_gen_samples_per_class_and_h5(tmp_path):
    h5py = pytest.importorskip("h5py")
    noise, _, y, _ = _inputs()
    jG, _, G, _ = _models()
    pg = _pair(jG, G, noise, y)
    cfg = dict(NN=NN, Z=Z, mode="gp", length_scale=3.0)
    samples = gan.gen_samples_per_class(G, 2, cfg, per_class=3, seed=4)
    assert samples.shape == (2, 3, J, C, T)
    ref_path = str(tmp_path / "ref.h5")
    jgan.gen_samples_per_class(jG, pg, 2, ref_path, cfg, per_class=3, seed=4)
    path = gan.write_samples_h5(str(tmp_path / "ours.h5"), samples)
    with h5py.File(path) as ours, h5py.File(ref_path) as ref:
        assert sorted(ours) == sorted(ref) == [f"A00{c}_{i}" for c in (1, 2) for i in range(3)]
        for key in ref:
            close(ours[key][()], ref[key][()], what=key)
