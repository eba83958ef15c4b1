"""The ACTOR family of regennet_torch against the JAX package's, on the CPU:
each loss term of models/actor_losses and their mix, and every ActorCVAE
arch as CVAE and CAE (2 layers, latent 32) against flax on converted
params. The trainer and generate_sequences are held in
tests/test_torch_train_cvae.py, full LBS and the new rot2xyz joint sets
in tests/test_torch_lbs_vertices.py.

The flax params come across through convert/from_flax and go back
through the JAX package's own convert_actor_cvae, so the port's layout is
the released ACTOR one. Draws the JAX functions take from a key (the
reparameterisation noise, the mmd sample, the hp signs, the latents) are
fed to the port. f32, within 1e-5 x max(1, max|jax|) unless stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regennet_tpu.convert.torch_ckpt import convert_actor_cvae
from regennet_tpu.models import actor_cvae as jcvae
from regennet_tpu.models import actor_losses as jlosses
from regennet_torch.convert.from_flax import actor_cvae_state_dict_from_flax
from regennet_torch.models import actor_cvae, actor_losses

ARCHS = list(actor_cvae.ARCH_FAMILIES)
SMALL = dict(latent_dim=32, ff_size=64, num_layers=2, num_heads=4, num_gru_layers=2)


def close(ours, ref, scale=1e-5, what=""):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    tol = scale * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(ours - ref).max())
    assert err <= tol, (what, err, tol)


def _tree_equal(a, b):
    fa, fb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(path))


def _loss_batch(seed=0):
    rng = np.random.default_rng(seed)
    B, J, F, T = 4, 6, 12, 7
    a = {k: rng.normal(size=(B, J, F, T)).astype(np.float32) for k in ("x", "output")}
    a.update({k: rng.normal(size=(B, J, 6, T)).astype(np.float32)
              for k in ("x_xyz", "output_xyz")})
    a.update({k: rng.normal(scale=0.5, size=(B, 16)).astype(np.float32)
              for k in ("mu", "logvar", "z")})
    mask = np.ones((B, T), bool)
    mask[2, 4:] = False
    a["mask"] = mask
    return a


@pytest.mark.parametrize("ltype", ["rc", "rcxyz", "vel", "velxyz", "kl", "mmd", "hp"])
def test_each_loss_matches_jax(ltype):
    batch = _loss_batch()
    key = jax.random.PRNGKey(5)
    w = np.random.default_rng(6).normal(scale=0.3, size=(6 * 12 * 7, 3)).astype(np.float32)

    def jlatent(x):
        return jnp.tanh(x.reshape(x.shape[0], -1) @ jnp.asarray(w))

    def latent(x):
        return torch.tanh(x.reshape(x.shape[0], -1) @ torch.tensor(w))

    noise = None
    if ltype == "mmd":
        noise = torch.tensor(np.asarray(jax.random.normal(key, batch["z"].shape)))
    elif ltype == "hp":
        noise = torch.tensor(np.asarray(jax.random.rademacher(
            key, (2,) + batch["x"].shape, dtype=jnp.float32)))
    ref = jlosses.get_loss_function(ltype)({k: jnp.asarray(v) for k, v in batch.items()},
                                           rng=key, latent_fn=jlatent)
    ours = actor_losses.get_loss_function(ltype)(
        {k: torch.tensor(v) for k, v in batch.items()}, latent_fn=latent, noise=noise)
    # hp: a second difference over eps^2 = 0.01 scales f32 rounding by 100
    close(ours, ref, scale=1e-3 if ltype == "hp" else 1e-5, what=ltype)
    # the generator route draws the same kind of sample
    if ltype in ("mmd", "hp"):
        val = actor_losses.get_loss_function(ltype)(
            {k: torch.tensor(v) for k, v in batch.items()}, latent_fn=latent,
            generator=torch.Generator().manual_seed(0))
        assert np.isfinite(float(val))


def test_compute_losses_mix_matches_jax():
    batch = _loss_batch(1)
    lambdas = {"rc": 1.0, "kl": 1e-5, "mmd": 0.5, "vel": 1.0}
    key = jax.random.PRNGKey(7)
    ref_mixed, ref = jlosses.compute_losses({k: jnp.asarray(v) for k, v in batch.items()},
                                            lambdas, rng=key)
    # the JAX mix folds each sorted loss's index into the key
    i = sorted(lambdas).index("mmd")
    noise = {"mmd": torch.tensor(np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), batch["z"].shape)))}
    mixed, ours = actor_losses.compute_losses({k: torch.tensor(v) for k, v in batch.items()},
                                              lambdas, noise=noise)
    assert set(ours) == set(ref)
    for k in ref:
        close(ours[k], ref[k], what=k)


def _flax_model(arch, vae, J=8, F=6, T=10, dropout=0.0):
    return jcvae.ActorCVAE(njoints=J, nfeats=F, num_actions=5, arch=arch, num_frames=T,
                           vae=vae, dropout=dropout, **SMALL)


def _port_model(arch, vae, params, J=8, F=6, T=10, dropout=0.0):
    model = actor_cvae.ActorCVAE(njoints=J, nfeats=F, num_actions=5, arch=arch,
                                 num_frames=T, vae=vae, dropout=dropout, **SMALL)
    sd = actor_cvae_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params))
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    return model.eval(), sd


@pytest.mark.parametrize("modeltype", ["cvae", "cae"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_generate_match_flax(arch, modeltype):
    vae = modeltype == "cvae"
    jmodel = _flax_model(arch, vae)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (3, 8, 6, 10))) * 0.5
    action = np.asarray([0, 2, 4])
    key = jax.random.PRNGKey(2)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(action),
                         rng=key)["params"]
    model, sd = _port_model(arch, vae, params)
    # the port's state dict is the released layout: the JAX converter reads it back
    _tree_equal(convert_actor_cvae(sd, arch), params)

    ref = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(action), rng=key)
    eps = torch.tensor(np.asarray(jax.random.normal(key, ref["mu"].shape)))
    with torch.no_grad():
        ours = model(torch.tensor(x), torch.tensor(action), eps=eps)
    for name in ("output", "mu", "logvar", "z"):
        close(ours[name], ref[name], what=f"{arch} {modeltype} {name}")
    if not vae:
        np.testing.assert_array_equal(ours["z"].numpy(), ours["mu"].numpy())

    gen_key = jax.random.PRNGKey(3)
    ref_gen = jmodel.generate({"params": params}, jnp.asarray(action), 10, gen_key)
    z = torch.tensor(np.asarray(jax.random.normal(gen_key, (3, SMALL["latent_dim"]))))
    close(model.generate(torch.tensor(action), 10, z=z), ref_gen, what=f"{arch} generate")


def test_train_mode_draws_dropout_and_reparameterisation_from_the_generator():
    model = actor_cvae.ActorCVAE(njoints=8, nfeats=6, num_actions=5, dropout=0.1, **SMALL)
    x, a = torch.randn(3, 8, 6, 10), torch.tensor([0, 1, 2])

    def run(seed):
        return model(x, a, generator=torch.Generator().manual_seed(seed))["output"]

    torch.testing.assert_close(run(0), run(0), rtol=0, atol=0)
    assert not torch.equal(run(0), run(1))
    out = model.eval()(x, a)  # no generator: z is mu, no dropout
    torch.testing.assert_close(out["z"], out["mu"], rtol=0, atol=0)
