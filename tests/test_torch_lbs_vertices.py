"""Full LBS and the rot2xyz joint sets and pose reps of regennet_torch
against the JAX package's, on the CPU: `lbs.vertices` and
`extended_joints` on the synthetic SMPL and SMPL-X models, and the vibe,
a2m, a2mpl and vertices joint sets through the rot6d, rotvec, rotquat and
rotmat reps. f32, within 1e-5 x max(1, max|jax|) unless stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regennet_tpu.ops import body_model as jbm
from regennet_tpu.ops import lbs as jlbs
from regennet_tpu.ops import pose_decode as jpd
from regennet_tpu.ops import rotations as jrot
from regennet_torch.ops import body_model as bm
from regennet_torch.ops import lbs
from regennet_torch.ops import pose_decode as pd
from tests.test_torch_actor_cvae import close


def _rotmats(B, J, seed):
    aa = np.random.default_rng(seed).normal(scale=0.5, size=(B, J, 3)).astype(np.float32)
    return np.asarray(jrot.axis_angle_to_matrix(jnp.asarray(aa)))


@pytest.mark.parametrize("body", ["smplx", "smpl"])
def test_vertices_and_extended_joints_match_jax(body):
    jmodel, model = jbm.synthetic(body), bm.synthetic(body)
    np.testing.assert_array_equal(model.faces, np.asarray(jmodel.faces))
    R = _rotmats(3, model.num_joints, 1)
    betas = np.random.default_rng(2).normal(size=(3, 10)).astype(np.float32)
    # the JAX references in one jit: a compile costs less than their ops
    # dispatched one by one
    @jax.jit
    def references(r, b):
        out = [jlbs.vertices(jmodel, r), jlbs.vertices(jmodel, r, b, pose_blend=False)]
        return out + ([jlbs.extended_joints(jmodel, r, b)] if body == "smpl" else [])

    refs = references(jnp.asarray(R), jnp.asarray(betas))
    close(lbs.vertices(model, torch.tensor(R)), refs[0], what="vertices")
    close(lbs.vertices(model, torch.tensor(R), torch.tensor(betas), pose_blend=False),
          refs[1], what="shaped, no pose blend")
    if body == "smpl":
        ext = lbs.extended_joints(model, torch.tensor(R), torch.tensor(betas))
        assert ext.shape == (3, 54, 3)
        close(ext, refs[2], what="extended joints")


@pytest.mark.parametrize("jointstype,pose_rep", [
    ("vibe", "rot6d"), ("a2m", "rot6d"), ("a2mpl", "rotvec"), ("vertices", "rotquat"),
    ("smpl", "rotmat"), ("vertices", "rot6d")])
def test_rot2xyz_joint_sets_and_pose_reps_match_jax(jointstype, pose_rep):
    body = "smplx" if jointstype == "vertices" and pose_rep == "rot6d" else "smpl"
    J = {"smplx": 55, "smpl": 24}[body]
    feats = {"rot6d": 6, "rotvec": 3, "rotquat": 4, "rotmat": 9}[pose_rep]
    rng = np.random.default_rng(3)
    B, T, persons = 2, 5, 2 if body == "smplx" else 1
    x = rng.normal(scale=0.4, size=(B, J + 1, feats * persons, T)).astype(np.float32)
    if pose_rep == "rotmat":  # proper rotations
        rot = _rotmats(B * (J + 1) * persons * T, 1, 4).reshape(B, J + 1, T, persons, 9)
        x = np.ascontiguousarray(rot.transpose(0, 1, 3, 4, 2).reshape(B, J + 1, 9 * persons, T))
    mask = np.ones((B, T), bool)
    mask[1, 3:] = False
    kw = dict(pose_rep=pose_rep, translation=True, glob=True, jointstype=jointstype,
              vertstrans=True, num_person=persons)
    jbody = jbm.synthetic(body)
    ref = jax.jit(lambda x, m: jpd.rot2xyz(x, m, jbody, **kw))(jnp.asarray(x), jnp.asarray(mask))
    ours = pd.rot2xyz(torch.tensor(x), torch.tensor(mask), bm.synthetic(body), **kw)
    close(ours, ref, scale=2e-5, what=f"{jointstype} {pose_rep}")  # 3x3 chains
