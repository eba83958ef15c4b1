"""evaluate_cvae's GRU route (humanact12, pinned at 60 frames) of
regennet_torch against the JAX package's, on the CPU: one CVAE and one
GRU classifier in both packages, the latents fed from JAX's keys. Metrics
within rtol 1e-4, as tests/test_torch_evaluate_cvae.py holds the ST-GCN
route.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from regennet_tpu.data import synthetic as jsynthetic
from regennet_tpu.eval import evaluate_cvae as jevaluate_cvae
from regennet_tpu.models.gru_classifier import MotionDiscriminator as JMotionDiscriminator
from regennet_torch.convert.from_flax import gru_classifier_state_dict_from_flax
from regennet_torch.eval import evaluate_cvae
from tests.test_torch_evaluate_cvae import _compare, _write_runs, jax_draws


def test_gru_route_matches_jax(tmp_path):
    root = jsynthetic.write_humanact12_pkl(str(tmp_path / "ha12"), num_clips=12)
    _, _, (jpath, path) = _write_runs(str(tmp_path), 25, 6, 12, 60, "smpl", 1)
    variables = JMotionDiscriminator(input_size=72, output_size=12).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 24, 3, 60)), jnp.asarray([60]))
    rec = str(tmp_path / "gru.pt")
    torch.save({k: torch.tensor(v) for k, v in gru_classifier_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables)).items()}, rec)
    common = ["--data_path", root, "--dataset", "humanact12", "--eval_mode", "debug",
              "--batch_size", "4"]
    ref = jevaluate_cvae.main(jevaluate_cvae.parse_args(["--model_path", jpath] + common))
    ours = evaluate_cvae.main(evaluate_cvae.parse_args(
        ["--model_path", path, "--rec_model_path", rec, "--device", "cpu"] + common),
        draw_z=jax_draws)
    _compare(ours, ref)
    assert {"accuracy_gen", "fid_gt2"} <= set(ours["feats"])
