"""regennet_torch.ops.pose_decode.rot2xyz against the JAX rot2xyz on the
synthetic body models (same seed, same arrays). Tolerance 2e-5 (f32 3x3
chains over ~11 tree levels, different summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regennet_tpu.ops import body_model as jbm
from regennet_tpu.ops import pose_decode as jpd
from regennet_tpu.ops import rotations as jrot
from regennet_torch.ops import body_model as bm
from regennet_torch.ops import lbs
from regennet_torch.ops import pose_decode as pd
from regennet_torch.ops import rotations as rot

ATOL = 2e-5


def test_synthetic_body_model_matches_jax():
    for name in ("smplx", "smpl"):
        j, t = jbm.synthetic(name), bm.synthetic(name)
        assert t.parents == j.parents and t.levels == j.levels
        for field in ("v_template", "shapedirs", "posedirs", "j_regressor",
                      "lbs_weights"):
            np.testing.assert_array_equal(getattr(t, field).numpy(),
                                          np.asarray(getattr(j, field)))


def test_rotation_conversions_match_jax():
    rng = np.random.default_rng(0)
    d6 = rng.normal(size=(7, 6)).astype(np.float32)
    aa = rng.normal(size=(7, 3)).astype(np.float32)
    aa[0] = 0.0  # the Taylor branch
    np.testing.assert_allclose(
        rot.rotation_6d_to_matrix(torch.tensor(d6)).numpy(),
        np.asarray(jrot.rotation_6d_to_matrix(jnp.asarray(d6))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        rot.axis_angle_to_matrix(torch.tensor(aa)).numpy(),
        np.asarray(jrot.axis_angle_to_matrix(jnp.asarray(aa))), rtol=0, atol=1e-6)
    m = rot.rotation_6d_to_matrix(torch.tensor(d6))  # orthonormal rows
    torch.testing.assert_close(m @ m.transpose(-1, -2), torch.eye(3).expand(7, 3, 3),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("body", ["smplx", "smpl"])
@pytest.mark.parametrize("num_person", [1, 2])
@pytest.mark.parametrize("vertstrans", [False, True])
def test_rot2xyz_matches_jax(body, num_person, vertstrans):
    J = {"smplx": 55, "smpl": 24}[body]
    B, T = 2, 9
    rng = np.random.default_rng(num_person)
    x = rng.normal(size=(B, J + 1, 6 * num_person, T)).astype(np.float32)
    mask = np.ones((B, T), bool)
    mask[1, 6:] = False
    kw = dict(pose_rep="rot6d", translation=True, glob=True, jointstype=body,
              vertstrans=vertstrans, num_person=num_person)
    ref = np.asarray(jpd.rot2xyz(jnp.asarray(x), jnp.asarray(mask),
                                 jbm.synthetic(body), **kw))
    ours = pd.rot2xyz(torch.tensor(x), torch.tensor(mask), bm.synthetic(body), **kw)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=ATOL)


def test_rot2xyz_fixed_global_rotation_and_betas_match_jax():
    B, T = 2, 5
    x = np.random.default_rng(3).normal(size=(B, 55, 6, T)).astype(np.float32)
    kw = dict(pose_rep="rot6d", translation=True, glob=False,
              glob_rot=[np.pi, 0.0, 0.0], jointstype="smplx", beta=0.5)
    ref = np.asarray(jpd.rot2xyz(jnp.asarray(x), None, jbm.synthetic("smplx"), **kw))
    ours = pd.rot2xyz(torch.tensor(x), None, bm.synthetic("smplx"), **kw)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=ATOL)


def test_joints_of_identity_pose_are_rest_joints():
    model = bm.synthetic("smplx")
    rotmats = torch.eye(3).expand(3, 55, 3, 3)
    rest = lbs.shaped_rest_joints(model, None)
    torch.testing.assert_close(lbs.joints(model, rotmats), rest.expand(3, 55, 3))


def test_unported_joint_sets_raise():
    """A joint set neither package knows raises; 'vertices', once
    unported, now decodes the posed mesh."""
    x = torch.zeros(1, 56, 6, 4)
    with pytest.raises(NotImplementedError, match="jointstype is not implemented"):
        pd.rot2xyz(x, None, bm.synthetic("smplx"), jointstype="openpose")
    model = bm.synthetic("smplx")
    verts = pd.rot2xyz(torch.zeros(1, 55, 3, 4), None, model, pose_rep="rotvec",
                       translation=False, jointstype="vertices")
    assert verts.shape == (1, model.num_vertices, 3, 4)
