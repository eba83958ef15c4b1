"""visualize/* of regennet_torch against the JAX package's, on the CPU: the
SMPLify priors, fit_sequence for a few steps from a shared `init_pose6d`,
the prior's gradient near the identity, Npy2Obj (rot6d and xyz routes)
and the render_mesh and fit_seq CLIs, on the synthetic body models. f32,
within 1e-5 x max(1, max|jax|) unless stated.
"""

import functools
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regennet_tpu.ops import body_model as jbm
from regennet_tpu.ops import rotations as jgeo
from regennet_tpu.visualize import joints2smpl as jfit
from regennet_tpu.visualize import pose_prior as jprior
from regennet_tpu.visualize import vis_utils as jvis
from regennet_torch.ops import body_model as bm
from regennet_torch.ops import rotations as geo
from regennet_torch.visualize import fit_seq, joints2smpl, pose_prior, render_mesh, vis_utils
from tests.test_torch_actor_cvae import close


def _pose(seed, B=4, dim=69, scale=0.4):
    return np.random.default_rng(seed).normal(scale=scale, size=(B, dim)).astype(np.float32)


def _gmm_arrays(dim, M=3, seed=1):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(M, dim, dim))
    covs = np.einsum("mij,mkj->mik", a, a) / dim + 0.2 * np.eye(dim)
    return rng.normal(scale=0.1, size=(M, dim)), covs, np.asarray([0.5, 0.3, 0.2])


def test_priors_match_jax(tmp_path):
    pose = _pose(0)
    synth, jsynth = pose_prior.synthetic_gmm_prior(69), jprior.synthetic_gmm_prior(69)
    for a, b in zip(synth, jsynth):
        close(a, b)
    # the synthetic mixture's widest components have subnormal f32 weights
    assert float(synth.nll_weights.min()) == 0.0
    close(pose_prior.gmm_neg_log_likelihood(synth, torch.tensor(pose)),
          jprior.gmm_neg_log_likelihood(jsynth, jnp.asarray(pose)), what="nll")
    close(pose_prior.angle_prior(torch.tensor(pose)), jprior.angle_prior(jnp.asarray(pose)))
    close(pose_prior.gmof(torch.tensor(pose), 0.3), jprior.gmof(jnp.asarray(pose), 0.3))
    # a pickled mixture (the layout of gmm_08.pkl: means, covars, weights)
    means, covs, weights = _gmm_arrays(69)
    path = str(tmp_path / "gmm.pkl")
    with open(path, "wb") as f:
        pickle.dump({"means": means, "covars": covs, "weights": weights}, f)
    for a, b in zip(pose_prior.load_gmm_prior(path), jprior.load_gmm_prior(path)):
        close(a, b)
    for kind, gmm in [("gmm", path), ("gmm", None), ("l2", None), ("none", None)]:
        ours = pose_prior.make_pose_prior_fn(kind, 69, gmm_path=gmm)(torch.tensor(pose))
        ref = jprior.make_pose_prior_fn(kind, 69, gmm_path=gmm)(jnp.asarray(pose))
        close(ours, ref, what=kind)
    with pytest.raises(ValueError, match="does not match"):
        pose_prior.make_pose_prior_fn("gmm", 66, gmm_path=path)


def test_prior_gradient_near_the_identity_follows_jax():
    """fit_sequence's start: rot6d at the identity plus 0.01 noise, through
    matrix_to_axis_angle into the GMM and angle priors."""
    J = 24
    init = np.tile(np.asarray([1.0, 0, 0, 0, 1.0, 0], np.float32), (3, J, 1))
    init += 0.01 * np.random.default_rng(2).normal(size=init.shape).astype(np.float32)
    ours_fn = pose_prior.make_pose_prior_fn("gmm", 69)
    ref_fn = jprior.make_pose_prior_fn("gmm", 69)

    def ref(p6):
        aa = jgeo.matrix_to_axis_angle(jgeo.rotation_6d_to_matrix(p6)[:, 1:])
        return jnp.sum(ref_fn(aa.reshape(3, -1)))

    p6 = torch.tensor(init, requires_grad=True)
    aa = geo.matrix_to_axis_angle(geo.rotation_6d_to_matrix(p6)[:, 1:])
    ours = torch.autograd.grad(ours_fn(aa.reshape(3, -1)).sum(), p6)[0]
    ref_g = jax.grad(ref)(jnp.asarray(init))
    close(ours, ref_g, scale=1e-4, what="d prior / d pose6d")


@pytest.mark.parametrize("name", ["smpl", "smplx"])
def test_fit_sequence_matches_jax(name):
    """Five Adam steps from a shared init_pose6d: losses, poses and
    translations (losses within 1e-5 x max(1, |jax|); parameters within
    1e-4, Adam's first steps moving each entry by about lr)."""
    model, jmodel = bm.synthetic(name, num_vertices=32), jbm.synthetic(name, num_vertices=32)
    T, J = 4, model.num_joints
    rng = np.random.default_rng(3)
    target = rng.normal(scale=0.3, size=(T, J, 3)).astype(np.float32)
    target -= target[:, :1]
    init = np.tile(np.asarray([1.0, 0, 0, 0, 1.0, 0], np.float32), (T, J, 1))
    init += 0.01 * rng.normal(size=init.shape).astype(np.float32)
    ours = joints2smpl.fit_sequence(model, target, num_steps=5, init_pose6d=init)
    ref = jfit.fit_sequence(jmodel, target, num_steps=5, init_pose6d=init)
    close(ours["losses"], ref["losses"], what="losses")
    close(ours["pose6d"], ref["pose6d"], scale=1e-4, what="pose6d")
    close(ours["transl"], ref["transl"], scale=1e-4, what="transl")
    assert ours["losses"][-1] < ours["losses"][0]


def _results_npy(path, nfeats=6, njoints=56, T=6, bs=2):
    rng = np.random.default_rng(0)
    if nfeats == 6:
        motion = np.broadcast_to(np.asarray([1, 0, 0, 0, 1, 0], np.float32),
                                 (bs, njoints, T, 6)).transpose(0, 1, 3, 2).copy()
        motion += rng.normal(scale=0.01, size=motion.shape).astype(np.float32)
    else:
        motion = rng.normal(scale=0.3, size=(bs, njoints, 3, T)).astype(np.float32)
    np.save(path, {"motion": motion, "lengths": np.asarray([T, T - 1][:bs]),
                   "num_samples": bs, "text": ["hello"] * bs}, allow_pickle=True)
    return path


@pytest.mark.parametrize("nfeats", [6, 3])
def test_npy2obj_matches_jax(tmp_path, monkeypatch, nfeats):
    njoints = 56 if nfeats == 6 else 24
    npy = _results_npy(str(tmp_path / "results.npy"), nfeats=nfeats, njoints=njoints)
    # the xyz route's fit from one initial pose in both packages
    init = np.tile(np.asarray([1.0, 0, 0, 0, 1.0, 0], np.float32), (6, 24, 1))
    init += 0.01 * np.random.default_rng(5).normal(size=init.shape).astype(np.float32)
    monkeypatch.setattr(vis_utils, "fit_sequence", functools.partial(
        joints2smpl.fit_sequence, init_pose6d=init))
    monkeypatch.setattr(jvis, "fit_sequence", functools.partial(
        jfit.fit_sequence, init_pose6d=init))
    kw = dict(body_model="smplx" if nfeats == 6 else "smpl", fit_steps=3)
    ours = vis_utils.Npy2Obj(npy, sample_idx=1, rep_idx=0, device="cpu", **kw)
    ref = jvis.Npy2Obj(npy, sample_idx=1, rep_idx=0, **kw)
    assert ours.real_num_frames == ref.real_num_frames == 5
    close(ours.motion, ref.motion, scale=1e-4, what="motion")
    close(ours.vertices, ref.vertices, scale=1e-4, what="vertices")
    ours.save_obj(str(tmp_path / "ours.obj"), 0)
    ref.save_obj(str(tmp_path / "ref.obj"), 0)
    a = np.loadtxt(str(tmp_path / "ours.obj"), usecols=(1, 2, 3))
    b = np.loadtxt(str(tmp_path / "ref.obj"), usecols=(1, 2, 3))
    close(a, b, scale=1e-4, what="obj")
    ours.save_npy(str(tmp_path / "params.npy"))
    saved = np.load(str(tmp_path / "params.npy"), allow_pickle=True).item()
    assert saved["length"] == 5 and saved["thetas"].shape[-1] == 5


def test_render_mesh_and_fit_seq_clis(tmp_path):
    _results_npy(str(tmp_path / "results.npy"))
    mp4 = str(tmp_path / "sample01_rep00.mp4")
    open(mp4, "w").close()
    render_mesh.main(render_mesh.parse_args(["--input_path", mp4, "--body_model", "smplx",
                                             "--device", "cpu"]))
    assert len(os.listdir(str(tmp_path / "sample01_rep00_obj"))) == 5
    assert os.path.exists(str(tmp_path / "sample01_rep00_smpl_params.npy"))

    joints = np.random.default_rng(1).normal(scale=0.2, size=(3, 24, 3)).astype(np.float32)
    os.makedirs(tmp_path / "joints")
    np.save(str(tmp_path / "joints" / "clip.npy"), joints)
    out = fit_seq.main(fit_seq.parse_args([
        "--data_folder", str(tmp_path / "joints"), "--save_folder", str(tmp_path / "fits"),
        "--num_smplify_iters", "4", "--device", "cpu"]))
    assert out["clip.npy"]["losses"].shape == (4,)
    fit = np.load(str(tmp_path / "fits" / "clip" / "fit_params.npz"))
    assert fit["pose6d"].shape == (3, 24, 6)
    assert sorted(os.listdir(str(tmp_path / "fits" / "clip")))[0] == "fit_params.npz"
    assert len([f for f in os.listdir(str(tmp_path / "fits" / "clip"))
                if f.endswith(".obj")]) == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fit_seq.main(fit_seq.parse_args(["--data_folder", str(tmp_path / "joints"),
                                             "--save_folder", str(tmp_path / "f2")]))
