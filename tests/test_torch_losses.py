"""regennet_torch's training losses and the rotation functions the orient
loss needs, against the JAX package on the same numpy inputs.

Values and gradients (torch autograd against jax.grad) at f32, on the
synthetic SMPL-X body model with 24 vertices. Tolerances: rotations 1e-5
(values) and 1e-4 (gradients; arctan2 and sqrt chains); loss terms 1e-5
relative; the gradient of the total loss with respect to the model
output 1e-5 x max(1, max|grad|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regennet_tpu.diffusion import losses as jlosses
from regennet_tpu.diffusion.schedule import DiffusionConfig as JConfig
from regennet_tpu.diffusion.schedule import make_schedule as jmake_schedule
from regennet_tpu.ops import body_model as jbm
from regennet_tpu.ops import pose_decode as jpd
from regennet_tpu.ops import rotations as jrot
from regennet_torch.diffusion import losses
from regennet_torch.diffusion.schedule import DiffusionConfig, make_schedule
from regennet_torch.ops import body_model as bm
from regennet_torch.ops import pose_decode as pd
from regennet_torch.ops import rotations as rot

B, J, F, T = 3, 56, 6, 10
LAMBDAS = dict(lambda_rcxyz=1.0, lambda_vel=1.0, lambda_vel_rcxyz=1.0,
               lambda_fc=1.0, lambda_orient=1.0, lambda_body=1.0,
               lambda_transl=1.0)


def _matrices():
    """Random rotations, rotations within 1e-7..1e-3 rad of the identity,
    the identity itself, and half turns (each quaternion branch)."""
    rng = np.random.default_rng(0)
    aa = rng.normal(size=(8, 3))
    small = rng.normal(size=(4, 3)) * np.array([1e-7, 1e-5, 1e-4, 1e-3])[:, None]
    half = np.pi * np.eye(3) * 0.999
    aa = np.concatenate([aa, small, np.zeros((1, 3)), half]).astype(np.float32)
    return np.asarray(jrot.axis_angle_to_matrix(jnp.asarray(aa)))


@pytest.mark.parametrize("name", ["matrix_to_quaternion", "matrix_to_axis_angle"])
def test_matrix_conversions_and_gradients_match_jax(name):
    m = _matrices()
    jfn, tfn = getattr(jrot, name), getattr(rot, name)
    np.testing.assert_allclose(tfn(torch.tensor(m)).numpy(),
                               np.asarray(jfn(jnp.asarray(m))), rtol=0, atol=1e-5)
    w = np.random.default_rng(1).normal(size=jfn(jnp.asarray(m)).shape).astype(np.float32)
    jg = np.asarray(jax.grad(lambda x: jnp.sum(jfn(x) * w))(jnp.asarray(m)))
    tm = torch.tensor(m, requires_grad=True)
    (tfn(tm) * torch.tensor(w)).sum().backward()
    assert np.isfinite(jg).all() and torch.isfinite(tm.grad).all()
    np.testing.assert_allclose(tm.grad.numpy(), jg, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(jg).max()))


def test_quaternion_helpers_and_gradients_match_jax():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(9, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[0] = [1.0, 0.0, 0.0, 0.0]  # the identity: the Taylor branch
    q[1] = [1.0, 1e-7, -1e-7, 0.0]  # within the Taylor branch's reach
    q[2] = [-0.6, 0.0, 0.8, 0.0]  # negative real part
    np.testing.assert_array_equal(rot.standardize_quaternion(torch.tensor(q)).numpy(),
                                  np.asarray(jrot.standardize_quaternion(jnp.asarray(q))))
    for jfn, tfn, x in ((jrot.quaternion_to_axis_angle, rot.quaternion_to_axis_angle, q),
                        (jrot._sqrt_positive_part, rot._sqrt_positive_part,
                         np.array([-1.0, 0.0, 1e-8, 0.25, 4.0], np.float32))):
        np.testing.assert_allclose(tfn(torch.tensor(x)).numpy(),
                                   np.asarray(jfn(jnp.asarray(x))), rtol=0, atol=1e-5)
        jg = np.asarray(jax.grad(lambda v: jnp.sum(jfn(v)))(jnp.asarray(x)))
        tx = torch.tensor(x, requires_grad=True)
        tfn(tx).sum().backward()
        assert np.isfinite(jg).all() and torch.isfinite(tx.grad).all()
        np.testing.assert_allclose(tx.grad.numpy(), jg, rtol=1e-4, atol=1e-5)


def _batch():
    """x_start, model output and cmotion [B, J, F, T] (rot6d with a
    translation row), the first three frames of each target held still
    so the foot-contact mask engages; mask [B, 1, 1, T] with padding."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, J, F, T)).astype(np.float32)
    x[..., 1:3] = x[..., :1]
    out = (x + 0.3 * rng.normal(size=x.shape)).astype(np.float32)
    cm = rng.normal(size=x.shape).astype(np.float32)
    mask = np.ones((B, 1, 1, T), bool)
    mask[1, ..., 7:] = False
    return x, out, cm, mask


def _decoders():
    kw = dict(pose_rep="rot6d", jointstype="smplx", translation=True,
              glob=True, vertstrans=False, num_person=1)
    return (jpd.make_rot2xyz(jbm.synthetic("smplx", num_vertices=24), **kw),
            pd.make_rot2xyz(bm.synthetic("smplx", num_vertices=24), **kw))


def test_training_losses_terms_and_output_gradient_match_jax():
    x, out, cm, mask = _batch()
    t = np.array([5, 400, 999])
    noise = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)
    weights = np.array([1.0, 0.5, 2.0], np.float32)
    jsched, sched = jmake_schedule("cosine", 1000), make_schedule("cosine", 1000)
    jcfg, cfg = JConfig(**LAMBDAS), DiffusionConfig(**LAMBDAS)
    jdec, tdec = _decoders()

    def jloss(o):
        terms = jlosses.training_losses(
            jsched, jcfg, lambda *a: o, jnp.asarray(x), jnp.asarray(t),
            {"mask": jnp.asarray(mask), "cmotion": jnp.asarray(cm)},
            None, rot2xyz_fn=jdec, noise=jnp.asarray(noise))
        return jnp.sum(terms["loss"] * weights), terms

    jgrad, jterms = jax.jit(jax.grad(jloss, has_aux=True))(jnp.asarray(out))
    to = torch.tensor(out, requires_grad=True)
    terms = losses.training_losses(
        sched, cfg, lambda *a: to, torch.tensor(x), torch.tensor(t),
        {"mask": torch.tensor(mask), "cmotion": torch.tensor(cm)},
        torch.tensor(noise), rot2xyz_fn=tdec)
    (terms["loss"] * torch.tensor(weights)).sum().backward()

    assert set(terms) == set(jterms) == {"rot_mse", "rcxyz_mse", "vel_xyz_mse", "fc",
                                         "vel_mse", "orient", "body", "transl", "loss"}
    for name, ref in jterms.items():
        ref = np.asarray(ref)
        assert ref.shape == (B,) and (ref > 0).all(), name
        np.testing.assert_allclose(terms[name].detach().numpy(), ref, rtol=1e-5,
                                   atol=0, err_msg=name)
    jgrad = np.asarray(jgrad)
    assert np.isfinite(jgrad).all() and torch.isfinite(to.grad).all()
    np.testing.assert_allclose(to.grad.numpy(), jgrad, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(jgrad).max()))


def test_masked_l2_normaliser_and_flat_reductions():
    a = torch.arange(24.0).reshape(2, 3, 1, 4)
    mask = torch.tensor([[1, 1, 0, 0], [1, 1, 1, 1]], dtype=torch.bool).view(2, 1, 1, 4)
    got = losses.masked_l2(a, torch.zeros_like(a), mask)
    want = [(a[0, ..., :2] ** 2).sum() / (2 * 3), (a[1] ** 2).sum() / (4 * 3)]
    torch.testing.assert_close(got, torch.stack(want))
    torch.testing.assert_close(losses.sum_flat(a), a.sum(dim=(1, 2, 3)))
    torch.testing.assert_close(losses.mean_flat(a), a.mean(dim=(1, 2, 3)))
    # loss_type="kl": the variational-bound term alone, held against JAX
    rng = np.random.default_rng(3)
    x0 = np.clip(rng.normal(size=(2, 3, 2, 4)), -1, 1).astype(np.float32)
    noise = rng.normal(size=x0.shape).astype(np.float32)
    t = np.array([0, 6])
    kl_mask = np.ones((2, 1, 1, 4), bool)
    got = losses.training_losses(
        make_schedule("cosine", 10), DiffusionConfig(loss_type="kl"),
        lambda x, ts, cond: torch.tanh(x), torch.tensor(x0), torch.tensor(t),
        {"mask": torch.tensor(kl_mask)}, torch.tensor(noise))
    want = jlosses.training_losses(
        jmake_schedule("cosine", 10), JConfig(loss_type="kl"),
        lambda x, ts, cond: jnp.tanh(x), jnp.asarray(x0), jnp.asarray(t, jnp.int32),
        {"mask": jnp.asarray(kl_mask)}, None, noise=jnp.asarray(noise))
    assert set(got) == set(want) == {"loss"}
    np.testing.assert_allclose(got["loss"].numpy(), np.asarray(want["loss"]),
                               rtol=1e-5, atol=0)
