"""train_cvae and generate_sequences of regennet_torch against the JAX
package's, on the CPU: one update on the model train_cvae builds against
JAX's make_train_step, the CLI's checkpoint and finetune, and
generate_sequences' grid and vertex decode. Draws the JAX step takes from
a key are fed to the port. f32, within 1e-5 x max(1, max|jax|) unless
stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from regennet_tpu.convert.torch_ckpt import convert_actor_cvae
from regennet_tpu.models import actor_cvae as jcvae
from regennet_tpu.ops import body_model as jbm
from regennet_tpu.ops import pose_decode as jpd
from regennet_tpu.sample import generate_sequences as jgenseq
from regennet_tpu.train import train_cvae as jtrain
from regennet_torch.convert.from_flax import actor_cvae_state_dict_from_flax
from regennet_torch.data import synthetic
from regennet_torch.data.feeder import Feeder
from regennet_torch.ops import body_model as bm
from regennet_torch.ops import pose_decode as pd
from regennet_torch.sample import generate_sequences
from regennet_torch.train import train_cvae
from tests.test_torch_actor_cvae import SMALL, close


def _jax_step_state(opt_state):
    """(the gradients, from Adam's first moment after one step)."""
    return jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, opt_state[0].mu)


@pytest.mark.parametrize("modeltype", ["cvae", "cae"])
def test_one_update_matches_jax(modeltype):
    """One train_cvae step (SMPL, the cvae case with the rcxyz decode) on
    the model train_cvae.build_model makes against JAX's make_train_step on
    the model the JAX CLI makes (its default dropout, which its train=False
    apply leaves off); the cae case trades rcxyz for mmd."""
    J, F, T, B = 25, 6, 8, 4
    argv = ["--data_path", "", "--save_dir", "", "--modeltype", modeltype,
            "--body_model", "smpl", "--num_person", "1"]
    if modeltype == "cae":
        argv += ["--lambda_mmd", "0.5", "--lambda_rcxyz", "0"]
    args = train_cvae.parse_args(argv)
    lambdas = train_cvae.active_lambdas(args)
    assert lambdas == jtrain.active_lambdas(jtrain.parse_args(argv))
    vae = modeltype == "cvae"
    # as the JAX CLI builds it, at a cut width
    D, layers = SMALL["latent_dim"], SMALL["num_layers"]
    jmodel = jcvae.ActorCVAE(njoints=J, nfeats=F, num_actions=5, latent_dim=D,
                             num_layers=layers, num_frames=T, vae=vae)
    rng = np.random.default_rng(8)
    x = (0.3 * rng.normal(size=(B, J, F, T))).astype(np.float32)
    action = np.asarray([0, 3, 1, 4])
    mask = np.ones((B, T), bool)
    mask[2, 5:] = False
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(action),
                         rng=jax.random.PRNGKey(2))["params"]
    args.num_frames, args.latent_dim, args.num_layers = T, D, layers
    model = train_cvae.build_model(args, J, F, 5)
    model.load_state_dict({k: torch.tensor(v) for k, v in actor_cvae_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)).items()}, strict=True)
    model.train()

    decode = dict(pose_rep="rot6d", translation=True, glob=True, jointstype="smpl",
                  vertstrans=False, num_person=1)
    # under its own jit, the step traces the decode once for x and output
    jrot2xyz = jax.jit(jpd.make_rot2xyz(jbm.synthetic("smpl"), **decode))
    optimizer = optax.adamw(args.lr)
    jstep = jtrain.make_train_step(jmodel, optimizer, lambdas, jrot2xyz)
    key = jax.random.PRNGKey(9)
    new_params, opt_state, ref = jstep(params, optimizer.init(params), jnp.asarray(x),
                                       jnp.asarray(action), jnp.asarray(mask), key)
    # the JAX step's draws: the reparameterisation noise, then each sorted
    # loss's fold of the loss key
    reparam_key, loss_key = jax.random.split(key)
    mu_shape = (B, SMALL["latent_dim"])
    eps = torch.tensor(np.asarray(jax.random.normal(reparam_key, mu_shape)))
    noise = {"mmd": torch.tensor(np.asarray(jax.random.normal(
        jax.random.fold_in(loss_key, sorted(lambdas).index("mmd")), mu_shape)))} \
        if "mmd" in lambdas else None

    rot2xyz = pd.make_rot2xyz(bm.synthetic("smpl"), **decode)
    opt = train_cvae.make_optimizer(model.parameters(), args.lr, train_cvae.WEIGHT_DECAY)
    step = train_cvae.make_train_step(model, opt, lambdas, rot2xyz, torch.Generator())
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ours = step(torch.tensor(x), torch.tensor(action), torch.tensor(mask),
                eps=eps if vae else None, loss_noise=noise)
    assert set(ours) == set(ref)
    for k in ref:
        close(ours[k], ref[k], what=k)

    grads = actor_cvae_state_dict_from_flax(_jax_step_state(opt_state))
    after = actor_cvae_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, new_params))
    port_grads = {n: p.grad for n, p in model.named_parameters()}
    moved = 0
    for name, value in after.items():
        g_ref = grads[name]
        g_scale = max(float(np.abs(g_ref).max()), 1e-30)
        close(port_grads[name], g_ref, scale=1e-3 * g_scale, what=f"grad {name}")
        err = np.abs(model.state_dict()[name].numpy() - value)
        tol = 1e-5 * max(1.0, float(np.abs(value).max()))
        noise_mask = np.abs(g_ref) <= 1e-4 * g_scale  # Adam's step takes its sign
        assert err[~noise_mask].max(initial=0.0) <= tol, (name, float(err.max()))
        assert err[noise_mask].max(initial=0.0) <= 2 * args.lr + tol, name
        moved += not torch.equal(before[name], model.state_dict()[name])
    assert moved > 0


def _feeder(num_clips, T):
    return Feeder(clips=synthetic.make_clips("chi3d", "train", num_clips=num_clips,
                                             min_len=T + 4, max_len=2 * T),
                  dataname="chi3d", split="train", num_frames=T, num_person=2,
                  pose_rep="rot6d")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 2-epoch train_cvae run on in-memory Chi3D clips (T 8, batch 4)."""
    save_dir = tmp_path_factory.mktemp("cvae") / "run"
    args = train_cvae.parse_args([
        "--data_path", "", "--save_dir", str(save_dir), "--num_frames", "8",
        "--batch_size", "4", "--num_epochs", "2", "--snapshot", "2", "--latent_dim", "16",
        "--num_layers", "1", "--device", "cpu"])
    model, path = train_cvae.main(args, data=_feeder(10, 8))
    return args, model, path


def test_train_cvae_cli_writes_the_checkpoint_and_finetunes(trained, tmp_path):
    import json
    import os

    args, model, path = trained
    assert path.endswith("model000000002.pt") and os.path.exists(path)
    saved = json.load(open(os.path.join(args.save_dir, "args.json")))
    assert (saved["num_actions"], saved["njoints"], saved["nfeats"]) == (8, 56, 12)
    sd = torch.load(path)
    convert_actor_cvae({k: v.numpy() for k, v in sd.items()}, "transformer")
    args2 = train_cvae.parse_args([
        "--data_path", "", "--save_dir", args.save_dir, "--num_frames", "8",
        "--batch_size", "4", "--num_epochs", "1", "--snapshot", "1", "--latent_dim", "16",
        "--num_layers", "1", "--duration_finetune", path, "--modeltype", "cae",
        "--lambda_mmd", "1.0", "--lambda_hp", "0.1"])
    _, path2 = train_cvae.main(args2, device="cpu", data=_feeder(10, 8))
    assert os.path.basename(path2) == "retraincheckpoint_orig_0002_added_0001.pt"


def test_generate_grid_matches_jax(trained):
    _, model, _ = trained
    model = model.eval()
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    jmodel = jcvae.ActorCVAE(njoints=56, nfeats=12, num_actions=8, latent_dim=16,
                             num_layers=1, num_frames=8)
    params = convert_actor_cvae(sd, "transformer")
    classes = np.arange(8, dtype=np.int32)
    durations = [6, 8]
    key = jax.random.PRNGKey(4)
    ref = jgenseq.generate_grid(jmodel, params, key, classes, durations, fact=0.8)
    latents = [torch.tensor(np.asarray(jax.random.normal(jax.random.fold_in(key, r),
                                                         (8, 16)))) for r in range(2)]
    ours = generate_sequences.generate_grid(model, torch.tensor(classes), durations,
                                            fact=0.8, latents=latents)
    assert ours.shape == (2, 8, 56, 12, 8)
    close(ours, ref, what="grid")


def test_generate_sequences_cli_decodes_vertices(trained, tmp_path):
    _, _, path = trained
    args = generate_sequences.parse_args([
        "--model_path", path, "--output_path", str(tmp_path / "g.npy"), "--num_frames", "8",
        "--nspa", "2", "--jointstype", "vertices", "--device", "cpu"])
    result = generate_sequences.main(args)
    V = bm.synthetic("smplx").num_vertices
    assert result["generation"].shape == (2, 8, 56, 12, 8)
    assert result["generation_xyz"].shape == (2, 8, V, 6, 8)
    assert result["classes"].tolist() == list(range(8))
    assert np.isfinite(result["generation_xyz"]).all()
    dur = generate_sequences.main(generate_sequences.parse_args([
        "--model_path", path, "--output_path", str(tmp_path / "d.npy"), "--duration_exp",
        "--device", "cpu"]))
    assert dur["generation"].shape == (4, 8, 56, 12, 100)
    assert dur["durations"].tolist() == generate_sequences.DURATION_EXP
