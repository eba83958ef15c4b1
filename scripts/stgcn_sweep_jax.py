"""Train the JAX package's reduced ST-GCN evaluator at the learning guard's
settings for several seeds, and keep what a comparison with the port
needs (the counterpart of scripts/stgcn_sweep_torch.py, which imports
regennet_torch only).

The settings are those of scripts/capability_study.py --scale smokefit:
the learnable chi3d pair of 256 + 128 clips of 32-48 frames, 24-frame
windows, the 4-block ST-GCN (channels 32, 32, 64, 64; strides 1, 1, 2, 1),
batch 32, Adam at lr 1e-3, 10 epochs, keep_best. For each seed it runs
regennet_tpu.eval.train_stgcn.run_training and writes into --workdir:
  jax_init_seed<S>.npz   the initial variables (model.init at the seed's
                         key, as run_training draws them), "/"-joined keys;
  jax_kept_seed<S>.npz   the variables keep_best returns;
  jax_sweep.json         each seed's held-out accuracy after every epoch
                         and the epoch keep_best took.

Run on the CPU:  python3 scripts/stgcn_sweep_jax.py --workdir DIR [--seeds 0,1,2,3,4]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import sys
import time
from argparse import Namespace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SMOKEFIT = dict(clips=256, min_len=32, max_len=48, frames=24, batch=32, lr=1e-3, epochs=10,
                channels=(32, 32, 64, 64), strides=(1, 1, 2, 1))
EPOCH_RE = re.compile(r"^epoch (\d+): .* test_acc ([0-9.]+)$")


def kept_epoch(accs):
    """The epoch keep_best returns: the first of the best (its test is a
    strict >)."""
    return max(range(len(accs)), key=lambda e: (accs[e], -e))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workdir", required=True)
    parser.add_argument("--seeds", default="0,1,2,3,4")
    cli = parser.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from regennet_tpu.data import synthetic
    from regennet_tpu.eval.train_stgcn import run_training
    from regennet_tpu.models.stgcn import STGCN
    from scripts.stgcn_chaos_floor import leaves

    s = SMOKEFIT
    os.makedirs(cli.workdir, exist_ok=True)
    ds_dir = os.path.join(cli.workdir, "ds")
    ds_path = synthetic.make_dataset_pair(ds_dir, "chi3d", num_clips=s["clips"],
                                          learnable=True, min_len=s["min_len"],
                                          max_len=s["max_len"])
    model = STGCN(in_channels=12, num_class=8, num_person=2, layout="smplx",
                  channels=s["channels"], strides=s["strides"])
    results = {"settings": {k: list(v) if isinstance(v, tuple) else v for k, v in s.items()},
               "seeds": {}}
    for seed in (int(x) for x in cli.seeds.split(",")):
        init = model.init(jax.random.PRNGKey(seed),
                          {"output": jnp.zeros((s["batch"], 56, 12, s["frames"]))})
        np.savez(os.path.join(cli.workdir, f"jax_init_seed{seed}.npz"), **leaves(init))
        args = Namespace(dataset="chi3d", data_path=ds_path, pose_rep="rot6d",
                         body_model="smplx", glob=True, translation=True,
                         num_frames=s["frames"], batch_size=s["batch"], lr=s["lr"],
                         num_epochs=s["epochs"], save_every=1000,
                         save_dir=os.path.join(cli.workdir, f"jax_stgcn_seed{seed}"), seed=seed,
                         keep_best=True, stgcn_channels=s["channels"],
                         stgcn_strides=s["strides"])
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            kept = run_training(args)
        seconds = time.perf_counter() - t0
        accs = [float(m.group(2)) for m in map(EPOCH_RE.match, out.getvalue().splitlines())
                if m]
        np.savez(os.path.join(cli.workdir, f"jax_kept_seed{seed}.npz"),
                 **leaves(jax.device_get(kept)))
        results["seeds"][str(seed)] = {"test_acc_by_epoch": accs,
                                       "kept_epoch": kept_epoch(accs), "seconds": seconds}
        print(f"seed {seed}: held-out accuracy by epoch {accs}, keep_best takes epoch "
              f"{kept_epoch(accs)} ({seconds:.1f} s)", flush=True)
    with open(os.path.join(cli.workdir, "jax_sweep.json"), "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
