"""evaluate_cvae, othermetrics and tables of regennet_torch against the JAX
package's, on the CPU: the CLI's ST-GCN route (chi3d, debug,
--other_metrics) on one CVAE and one classifier in both packages, the
latents fed from JAX's keys (the GRU route in
test_torch_evaluate_cvae_gru.py); the generated batches of the decode and
autotrans routes; the output-space metrics and the sweep tables. Metrics within rtol 1e-4 (the classifiers'
f32 features feed FID and the diversity draws); generated motions f32
within 1e-5 x max(1, max|jax|).
"""

import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regennet_tpu.data import synthetic as jsynthetic
from regennet_tpu.data.collate import collate as jcollate
from regennet_tpu.data.get_data import BatchLoader as JBatchLoader
from regennet_tpu.data.get_data import get_dataset as jget_dataset
from regennet_tpu.eval import evaluate_cvae as jevaluate_cvae
from regennet_tpu.eval import othermetrics as jothermetrics
from regennet_tpu.eval import tables as jtables
from regennet_tpu.eval.tools import save_metrics as jsave_metrics
from regennet_tpu.models import actor_cvae as jcvae
from regennet_tpu.models.stgcn import STGCN as JSTGCN
from regennet_tpu.train import checkpoint as jcheckpoint
from regennet_tpu.utils.rng import sampling_key
from regennet_torch.convert.from_flax import (
    actor_cvae_state_dict_from_flax,
    stgcn_state_dict_from_flax,
)
from regennet_torch.data.collate import collate
from regennet_torch.data.get_data import BatchLoader, get_dataset
from regennet_torch.eval import evaluate_cvae, othermetrics, tables
from regennet_torch.models.actor_cvae import ActorCVAE
from tests.test_torch_actor_cvae import close

LATENT, LAYERS = 16, 1


def jax_draws(seed, pass_index):
    """The JAX CLI's latents: per seed, pass i's key is the (i + 1)-th split
    of sampling_key(seed); each batch splits it once more."""
    rng = sampling_key(seed)
    for _ in range(pass_index + 1):
        rng, grng = jax.random.split(rng)
    state = {"rng": grng}

    def draw(shape):
        state["rng"], zrng = jax.random.split(state["rng"])
        return torch.tensor(np.asarray(jax.random.normal(zrng, shape, jnp.float32)))
    return draw


def _write_runs(root, J, F, num_actions, T, body_model, num_person, arch="transformer"):
    """One CVAE in both packages' formats: (the JAX checkpoint dir, the
    port's .pt), each with its args.json."""
    jmodel = jcvae.ActorCVAE(njoints=J, nfeats=F, num_actions=num_actions, latent_dim=LATENT,
                             num_layers=LAYERS, num_frames=T, arch=arch)
    x = jnp.zeros((2, J, F, T))
    params = jmodel.init(jax.random.PRNGKey(1), x, jnp.asarray([0, 1]),
                         rng=jax.random.PRNGKey(2))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    train_args = {"body_model": body_model, "num_person": num_person, "njoints": J,
                  "nfeats": F, "num_actions": num_actions, "latent_dim": LATENT,
                  "num_layers": LAYERS, "arch": arch, "num_frames": T, "modeltype": "cvae",
                  "pose_rep": "rot6d"}
    paths = []
    for pkg in ("jax", "torch"):
        run = os.path.join(root, pkg, "run")
        os.makedirs(run)
        with open(os.path.join(run, "args.json"), "w") as f:
            json.dump(train_args, f)
        if pkg == "jax":
            paths.append(jcheckpoint.save_checkpoint(
                run, 1, {"params": jax.tree_util.tree_map(jnp.asarray, params)}))
        else:
            path = os.path.join(run, "model000000001.pt")
            torch.save({k: torch.tensor(v) for k, v in
                        actor_cvae_state_dict_from_flax(params).items()}, path)
            paths.append(path)
    return jmodel, params, paths


def _compare(ours, ref):
    assert ours.keys() == ref.keys()
    for group in ref:
        assert ours[group].keys() == ref[group].keys(), group
        for key, values in ref[group].items():
            np.testing.assert_allclose([float(v) for v in ours[group][key]],
                                       [float(v) for v in values], rtol=1e-4, atol=1e-6,
                                       err_msg=f"{group} {key}")


def test_stgcn_route_matches_jax(tmp_path):
    data_path = jsynthetic.make_dataset_pair(str(tmp_path / "ds"), "chi3d", num_clips=16)
    _, _, (jpath, path) = _write_runs(str(tmp_path), 56, 12, 8, 8, "smplx", 2)
    # the JAX CLI's 'random' ST-GCN, as a file for the port
    stgcn = JSTGCN(in_channels=12, num_class=8, num_person=2, layout="smplx",
                   strategy="spatial", edge_importance_weighting=True)
    variables = stgcn.init(jax.random.PRNGKey(0), {"output": jnp.zeros((1, 56, 12, 8))},
                           train=False)
    rec = str(tmp_path / "stgcn.pt")
    torch.save({k: torch.tensor(v) for k, v in stgcn_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables)).items()}, rec)
    common = ["--data_path", data_path, "--dataset", "chi3d", "--eval_mode", "debug",
              "--batch_size", "4", "--other_metrics"]
    ref = jevaluate_cvae.main(jevaluate_cvae.parse_args(["--model_path", jpath] + common))
    ours = evaluate_cvae.main(evaluate_cvae.parse_args(
        ["--model_path", path, "--rec_model_path", rec, "--device", "cpu"] + common),
        draw_z=jax_draws)
    _compare(ours, ref)
    assert {"acceleration", "diversity", "multimodality", "rc_recons"} <= set(ours["other"])
    assert os.path.isfile(os.path.join(os.path.dirname(path),
                                       "evaluation_results_run_debug_1.yaml"))


@pytest.mark.parametrize("arch", ["transformer", "autotrans"])
def test_gen_batches_match_jax(tmp_path, arch):
    """build_cvae_gen_batches: decode (B1's plain version) and autotrans."""
    data_path = jsynthetic.make_dataset_pair(str(tmp_path / "ds"), "chi3d", num_clips=8)
    T = 6
    jmodel, params, (_, path) = _write_runs(str(tmp_path), 56, 12, 8, T, "smplx", 2, arch)
    model = ActorCVAE(56, 12, 8, latent_dim=LATENT, num_layers=LAYERS, arch=arch,
                      num_frames=T)
    model.load_state_dict(torch.load(path, weights_only=True), strict=True)
    model.eval()
    kw = dict(name="chi3d", num_frames=T, num_person=2, data_path=data_path, split="test",
              setting="mdm", pose_rep="rot6d", body_model="smplx")
    random.seed(0)  # the clips' frame windows
    ref = jevaluate_cvae.build_cvae_gen_batches(
        jmodel, jax.tree_util.tree_map(jnp.asarray, params), jax.random.split(sampling_key(0))[1],
        JBatchLoader(jget_dataset(**kw), 4, jcollate, shuffle=False, drop_last=False), T)
    random.seed(0)
    ours = evaluate_cvae.build_cvae_gen_batches(
        model, BatchLoader(get_dataset(**kw), 4, collate, shuffle=False, drop_last=False), T,
        jax_draws(0, 0), "cpu")
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        close(a["output"], b["output"], what="output")
        for key in ("x", "mask", "lengths", "y"):
            np.testing.assert_array_equal(a[key], b[key])


def _batches(seed):
    rng = np.random.default_rng(seed)
    out = []
    for n in (5, 4):
        lengths = rng.integers(4, 10, n)
        mask = np.arange(10)[None] < lengths[:, None]
        out.append({"output": rng.normal(size=(n, 7, 6, 10)).astype(np.float32),
                    "x": rng.normal(size=(n, 7, 6, 10)).astype(np.float32),
                    "lengths": lengths, "mask": mask, "y": rng.integers(0, 3, n)})
    return out


def test_othermetrics_match_jax():
    batches = _batches(0)
    assert othermetrics.calculate_acceleration(batches) == \
        jothermetrics.calculate_acceleration(batches)
    assert othermetrics.reconstruction_loss(batches) == jothermetrics.reconstruction_loss(batches)
    assert othermetrics.evaluate_othermetrics(batches, 3, seed=2) == \
        jothermetrics.evaluate_othermetrics(batches, 3, seed=2)


def _write_sweep(root):
    for i, (bs, arch) in enumerate([(16, "gru"), (8, "fc"), (32, "transformer")]):
        run = os.path.join(root, f"run{i}")
        os.makedirs(run)
        with open(os.path.join(run, "args.json"), "w") as f:
            json.dump({"batch_size": bs, "arch": arch}, f)
        jsave_metrics(os.path.join(run, "evaluation_results_run_debug_1.yaml"), {"feats": {
            "fid_gen_test": ["{:.6}".format(0.5 + i), "{:.6}".format(0.75 + i)],
            "accuracy_gen_test": ["0.25", "{:.6}".format(0.125 * i)],
            "diversity_gen": ["3.5", "4.25"]}})


@pytest.mark.parametrize("group_by,latex", [("batch_size", False), ("arch", True)])
def test_tables_match_jax(tmp_path, capsys, group_by, latex):
    _write_sweep(str(tmp_path))
    keys = ["fid", "accuracy", "diversity", "multimodality"]
    ours = tables.sweep_table(str(tmp_path), group_by, keys, latex=latex)
    assert ours == jtables.sweep_table(str(tmp_path), group_by, keys, latex=latex)
    if group_by == "batch_size":
        assert [line.split()[0] for line in ours.splitlines()[1:]] == ["8", "16", "32"]
    for v, key in [([0.5, 0.25], "fid"), ([0.125, 1.0], "accuracy")]:
        assert tables.format_values(v, key) == jtables.format_values(v, key)
    argv = [str(tmp_path), "--group_by", group_by, "--device", "cpu"] + (["--latex"] if latex
                                                                         else [])
    assert tables.main(tables.parse_args(argv)) == ours
    assert ours in capsys.readouterr().out


def test_clis_need_cuda_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tables.main(tables.parse_args([str(tmp_path)]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate_cvae.main(evaluate_cvae.parse_args(["--model_path", "m.pt",
                                                     "--data_path", ""]))
