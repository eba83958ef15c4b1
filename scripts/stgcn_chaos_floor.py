"""The JAX package's own chaos floor for a whole run of its ST-GCN trainer:
how far two runs of regennet_tpu.eval.train_stgcn's train step drift
apart after K steps when nothing but rounding separates them.

The run is the learning guard's (scripts/capability_study.py --scale
smokefit): the reduced ST-GCN (channels 32, 32, 64, 64; strides 1, 1, 2,
1; smplx, 12 features, 8 classes, two persons) from model.init at key 0,
Adam at lr 1e-3 in train mode, batches of 32 of the learnable chi3d clips
(256 + 128 clips of 32-48 frames, 24-frame windows) in the loader's order,
K = 16 steps: two of the guard's epochs. Two perturbations, each against
the unperturbed run:
  ulp      every initial parameter one f32 ulp up (np.nextafter);
  reorder  the rows of every batch in another order (the same mean loss
           and gradient in exact arithmetic; XLA sums them in another
           order). The data BatchNorm's batch statistics depend on the
           data alone, so only this one moves them: flax's variance
           E[x^2] - E[x]^2 cancels on the clips' near-constant channels.
The distances (`distances`): the per-step loss (the largest gap over the
steps), the parameters after K steps (the 2-norm over every parameter but
the convolution biases that a train-mode BatchNorm cancels, whose exact
gradient is zero: Adam moves those by lr times the sign of rounding noise,
and they are held apart), the running means and variances (2-norms), and
the eval-mode logits on the first 32 held-out clips (the largest gap).
tests/test_torch_train_stgcn.py holds the port's whole run against the
JAX run at 4x the larger of the two floors this script prints.

Run on the CPU:  python3 scripts/stgcn_chaos_floor.py [--steps 16]
"""

from __future__ import annotations

import argparse
import copy
import functools
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

REDUCED = dict(channels=(32, 32, 64, 64), strides=(1, 1, 2, 1))
BATCH, FRAMES, LR, STEPS = 32, 24, 1e-3, 16
# the convolution biases a train-mode BatchNorm follows at once (flax names)
CANCELLED = ("tcn_conv/bias", "res_conv/bias")


def smokefit_batches(workdir, steps=STEPS):
    """The learning guard's first `steps` training batches [(motion [32, 56,
    12, 24], labels [32])] in the loader's order, and the first 32 held-out
    clips' motion, through the JAX package's dataset and loader (host numpy;
    the port's copies give the same arrays)."""
    import random

    import numpy as np

    from regennet_tpu.data import synthetic
    from regennet_tpu.data.collate import collate
    from regennet_tpu.data.get_data import BatchLoader, get_dataset

    path = synthetic.make_dataset_pair(workdir, "chi3d", num_clips=256, learnable=True,
                                       min_len=32, max_len=48)
    random.seed(0)
    np.random.seed(0)
    kw = dict(name="chi3d", num_frames=FRAMES, num_person=2, data_path=path,
              setting="mdm", pose_rep="rot6d", body_model="smplx")
    loader = BatchLoader(get_dataset(split="train", **kw), BATCH, collate, seed=0)
    batches = []
    while len(batches) < steps:
        for motion, cond in loader:
            batches.append((motion, np.asarray(cond["y"]["action"][:, 0])))
            if len(batches) == steps:
                break
    held_out, _ = next(iter(BatchLoader(get_dataset(split="test", **kw), BATCH, collate,
                                        shuffle=False)))
    return batches, held_out


def model():
    from regennet_tpu.models.stgcn import STGCN

    return STGCN(in_channels=12, num_class=8, num_person=2, layout="smplx", **REDUCED)


def init_variables(batches):
    import jax
    import jax.numpy as jnp
    import numpy as np

    # the parameters and statistics do not depend on the batch: two clips
    # compile faster than 32
    variables = jax.jit(model().init)(jax.random.PRNGKey(0),
                                      {"output": jnp.asarray(batches[0][0][:2])})
    return jax.tree_util.tree_map(np.asarray, variables)


@functools.lru_cache(maxsize=None)
def step_fn():
    """The JAX package's jitted train step (make_step_fns), built once."""
    import optax

    from regennet_tpu.eval.train_stgcn import make_step_fns

    return make_step_fns(model(), optax.adam(LR))[0]


def compile_step():
    """Compile step_fn on zeros of the run's shapes: it needs no data, so a
    caller may do it beside smokefit_batches."""
    import jax
    import jax.numpy as jnp
    import optax

    motion = jnp.zeros((BATCH, 56, 12, FRAMES), jnp.float32)
    shapes = jax.eval_shape(model().init, jax.random.PRNGKey(0), {"output": motion})
    v = jax.tree_util.tree_map(lambda x: jnp.zeros(x.shape, x.dtype), shapes)
    jax.block_until_ready(step_fn()(v, optax.adam(LR).init(v["params"]), motion,
                                    jnp.zeros((BATCH,), jnp.int32), jax.random.PRNGKey(0)))


def run(variables, batches, held_out, order=None):
    """The JAX package's train step over `batches` from `variables` (each
    batch's rows in `order` when given) -> {"losses": [K], "variables":
    after K steps, "stats": the batch_stats after every step, "logits":
    eval-mode logits on held_out}, numpy."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    jm, step = model(), step_fn()
    v = jax.tree_util.tree_map(jnp.array, variables)
    opt_state = optax.adam(LR).init(v["params"])
    rng = jax.random.PRNGKey(0)
    losses, stats = [], []
    for motion, labels in batches:
        if order is not None:
            motion, labels = motion[order], labels[order]
        rng, srng = jax.random.split(rng)
        v, opt_state, metrics = step(v, opt_state, jnp.asarray(motion), jnp.asarray(labels),
                                     srng)
        losses.append(float(metrics["loss"]))
        stats.append(jax.tree_util.tree_map(np.asarray, v["batch_stats"]))
    v = jax.tree_util.tree_map(np.asarray, v)
    logits = np.asarray(jax.jit(lambda v, x: jm.apply(v, {"output": x})["yhat"])(
        v, jnp.asarray(held_out)))
    return {"losses": np.asarray(losses), "variables": v, "stats": stats, "logits": logits}


def leaves(tree, prefix=""):
    """{"a/b": array} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def split_flax(variables):
    """(parameters held by their 2-norm, the cancelled biases, running
    means, running variances) of flax variables, by name."""
    params = leaves(variables["params"])
    stats = leaves(variables["batch_stats"])
    return ({k: v for k, v in params.items() if not k.endswith(CANCELLED)},
            {k: v for k, v in params.items() if k.endswith(CANCELLED)},
            {k: v for k, v in stats.items() if k.endswith("mean")},
            {k: v for k, v in stats.items() if k.endswith("var")})


def distances(a, b):
    """The distances between two runs: a and b are {"losses", "params",
    "cancelled", "means", "vars", "logits"} with the dicts keyed alike."""
    import numpy as np

    def norm(x, y):
        return float(np.sqrt(sum(float(np.sum((np.asarray(x[k], np.float64)
                                               - np.asarray(y[k], np.float64)) ** 2))
                                 for k in x)))

    return {"loss": float(np.abs(a["losses"] - b["losses"]).max()),
            "params": norm(a["params"], b["params"]),
            "cancelled": float(max(np.abs(a["cancelled"][k] - b["cancelled"][k]).max()
                                   for k in a["cancelled"])),
            "running_mean": norm(a["means"], b["means"]),
            "running_var": norm(a["vars"], b["vars"]),
            "logits": float(np.abs(a["logits"] - b["logits"]).max())}


def summary(result):
    params, cancelled, means, variances = split_flax(result["variables"])
    return {"losses": result["losses"], "params": params, "cancelled": cancelled,
            "means": means, "vars": variances, "logits": result["logits"]}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=STEPS)
    cli = parser.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    with tempfile.TemporaryDirectory() as tmp:
        batches, held_out = smokefit_batches(tmp, cli.steps)
    variables = init_variables(batches)
    ref = summary(run(variables, batches, held_out))
    up = copy.deepcopy(variables)
    up["params"] = jax.tree_util.tree_map(
        lambda x: np.nextafter(x, np.float32(np.inf)).astype(np.float32), up["params"])
    order = np.random.default_rng(5).permutation(BATCH)
    floors = {"ulp": distances(summary(run(up, batches, held_out)), ref),
              "reorder": distances(summary(run(variables, batches, held_out, order)), ref)}
    print(json.dumps({"steps": cli.steps, "batch_sum": float(sum(float(m.sum())
                                                                 for m, _ in batches)),
                      "floors": floors}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
