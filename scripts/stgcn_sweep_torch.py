"""Train the port's reduced ST-GCN evaluator at the learning guard's settings
for several seeds, from its own initialisation and from the JAX package's,
and let every evaluator, the JAX package's included, judge one fixed set of
clips generated by the guard's trained CMDM.

It reads what scripts/stgcn_sweep_jax.py wrote into --workdir
(jax_init_seed<S>.npz, jax_kept_seed<S>.npz, jax_sweep.json) and a finished
learning-guard workdir of the port (--study, from `python3
scripts/capability_study_torch.py --scale smokefit --device cpu --workdir
DIR`: its clips, its CMDM checkpoints). For each seed:
  port       train_stgcn.run_training as the guard runs it (seed S: the
             Flax initialisers drawn from torch.Generator(S));
  port@jax   the same run from the JAX package's initial variables of seed
             S (stgcn_state_dict_from_flax);
  jax        the JAX package's kept evaluator of seed S, converted.
Each evaluator's held-out accuracy after every epoch (the two port rows),
the epoch keep_best took, its accuracy on the ground truth, and on the
fixed generated clips (the guard's protocol, eval_cmdm's stgcn_eval, on
the EMA of the checkpoints of --steps at guidance 1, its test split: the
clips behind accuracy_gen_test) the accuracy and the share of clips in the most frequent
class, and the data BatchNorm's largest gain 1/sqrt(running_var + eps).
With --protocol_seeds, the named seeds' evaluators also rerun the
guard's stages 4-6 (`--eval_only` on a copy of the study with the
evaluator swapped in), which gives their trained accuracy_gen_test.
Writes <workdir>/torch_sweep.json and prints a table.

Run on the CPU:  python3 scripts/stgcn_sweep_torch.py --workdir DIR --study DIR
                     [--seeds 0,1,2,3,4] [--protocol_seeds 0] [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import importlib.util
import io
import json
import os
import shutil
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# the JAX sweep's log format and keep_best's rule (its module imports JAX
# only inside main)
from scripts.stgcn_sweep_jax import EPOCH_RE, kept_epoch  # noqa: E402


def load_study():
    spec = importlib.util.spec_from_file_location(
        "capability_study_torch", os.path.join(REPO, "scripts", "capability_study_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def unflatten(npz_path):
    """jax_*_seed<S>.npz ("/"-joined keys) -> nested dict of numpy."""
    import numpy as np

    tree = {}
    with np.load(npz_path) as f:
        for key in f.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = np.asarray(f[key])
    return tree


def train(cap, data, seed, device, init_state=None):
    """The guard's evaluator training at `seed` (from `init_state`, a state
    dict, when given) -> (state dict, held-out accuracy by epoch)."""
    import torch

    from regennet_torch.eval import train_stgcn

    draw = train_stgcn.random_init_
    if init_state is not None:
        def load(model, generator):
            model.load_state_dict({k: torch.tensor(v) for k, v in init_state.items()},
                                  strict=False)
            return model
        train_stgcn.random_init_ = load
    out = io.StringIO()
    try:
        with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(out):
            args = cap.stgcn_args(tmp, "smokefit")
            args.seed = seed
            model = train_stgcn.run_training(args, device=device, data=data)
    finally:
        train_stgcn.random_init_ = draw
    accs = [float(m.group(2)) for m in map(EPOCH_RE.match, out.getvalue().splitlines()) if m]
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}, accs


def generated_clips(cap, study, data, device, step):
    """The guard protocol's test-split clips at the study's checkpoint
    `step` (EMA, guidance 1, the smokefit's samples and seed 0): ({"gen":
    motion, "gt": motion}, {"gen": labels, "gt": labels}), numpy."""
    import numpy as np

    from regennet_torch.eval import stgcn_eval

    args_t = cap.train_args(os.path.join(study, "cmdm_save"), "smokefit")
    ema = cap.checkpoints(args_t.save_dir)[step][1]
    seen = {}
    measure = stgcn_eval.evaluate_seed_metrics

    def capture(evaluator, loaders, **kw):
        seen.update(loaders)
        return {}

    stgcn_eval.evaluate_seed_metrics = capture
    try:
        cap.evaluate_row(args_t, data, None, device, state=ema, guidance=1.0,
                         num_samples=cap.SCALES["smokefit"]["samples"])
    finally:
        stgcn_eval.evaluate_seed_metrics = measure
    motion = {k: np.concatenate([b["output"] for b in seen[k]["test"]]) for k in ("gen", "gt")}
    labels = {k: np.concatenate([b["y"] for b in seen[k]["test"]]) for k in ("gen", "gt")}
    return motion, labels


def judge(cap, state, clips, labels, held_out, device):
    """Accuracy and the most frequent class's share on each clip set."""
    import numpy as np

    from regennet_torch.eval import stgcn_eval

    evaluator = stgcn_eval.STGCNEvaluator("chi3d", "smplx", 8, 12, 2, state, device=device,
                                          **cap.REDUCED_STGCN)
    out = {}
    for name, (x, y) in {**{k: (clips[k], labels[k]) for k in clips},
                         "held_out": held_out}.items():
        pred = np.argmax(evaluator({"output": x})["yhat"], axis=1)
        out[name] = {"accuracy": float((pred == y).mean()),
                     "top_class_share": float(np.bincount(pred, minlength=8).max() / len(pred)),
                     "top_class": int(np.bincount(pred, minlength=8).argmax())}
    return out


def protocol(cap, study, state, scratch, device):
    """Stages 4-6 of the guard (--eval_only) on a copy of the study with
    `state` as its evaluator -> (trained accuracy_gen_test, chosen step)."""
    import torch

    from regennet_torch.train import checkpoint

    if os.path.exists(scratch):
        shutil.rmtree(scratch)
    shutil.copytree(study, scratch)
    torch.save({k: torch.as_tensor(v) for k, v in state.items()},
               os.path.join(scratch, "stgcn_save", checkpoint.ckpt_name(cap.STGCN_STEP)))
    with contextlib.redirect_stdout(io.StringIO()):
        results = cap.run_study(device=device, workdir=scratch, scale="smokefit",
                                eval_only=True)
    shutil.rmtree(scratch)
    return (results["trained"]["accuracy_gen_test"]["mean"],
            results["selection"]["chosen_step"])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workdir", required=True)
    parser.add_argument("--study", required=True)
    parser.add_argument("--seeds", default="0,1,2,3,4")
    parser.add_argument("--protocol_seeds", default="")
    parser.add_argument("--steps", default="402,704",
                        help="the checkpoints whose generated clips are judged")
    parser.add_argument("--device", default=None, help="cpu or cuda:N (default: cuda:0)")
    cli = parser.parse_args(argv)

    import numpy as np

    from regennet_torch.convert.from_flax import stgcn_state_dict_from_flax
    from regennet_torch.data.collate import collate
    from regennet_torch.data.get_data import BatchLoader
    from regennet_torch.device import pin_f32_contract, resolve_device

    device = resolve_device(cli.device)
    pin_f32_contract()
    cap = load_study()
    data = cap.feeder(cap.load_clips(os.path.join(cli.study, "ds")),
                      cap.SCALES["smokefit"]["frames"])
    steps = [int(x) for x in cli.steps.split(",")]
    clips, labels = {}, {}
    for step in steps:
        motion, y = generated_clips(cap, cli.study, data, device, step)
        clips[f"gen@{step}"], labels[f"gen@{step}"] = motion["gen"], y["gen"]
    clips["gt"], labels["gt"] = motion["gt"], y["gt"]
    test = copy.deepcopy(data)
    test.split = "test"
    batches = list(BatchLoader(test, 32, collate, shuffle=False, drop_last=False))
    held_out = (np.concatenate([m for m, _ in batches]),
                np.concatenate([c["y"]["action"][:, 0] for _, c in batches]))
    with open(os.path.join(cli.workdir, "jax_sweep.json")) as f:
        jax_sweep = json.load(f)["seeds"]
    protocol_seeds = {int(x) for x in cli.protocol_seeds.split(",") if x}
    rows = []
    for seed in (int(x) for x in cli.seeds.split(",")):
        jax_init = stgcn_state_dict_from_flax(
            unflatten(os.path.join(cli.workdir, f"jax_init_seed{seed}.npz")))
        runs = {"port": train(cap, data, seed, device),
                "port@jax": train(cap, data, seed, device, init_state=jax_init),
                "jax": ({k: np.asarray(v) for k, v in stgcn_state_dict_from_flax(unflatten(
                    os.path.join(cli.workdir, f"jax_kept_seed{seed}.npz"))).items()},
                        jax_sweep[str(seed)]["test_acc_by_epoch"])}
        for kind, (state, accs) in runs.items():
            row = {"seed": seed, "evaluator": kind, "test_acc_by_epoch": accs,
                   "kept_epoch": kept_epoch(accs),
                   # the data BatchNorm's largest gain, 1/sqrt(running_var + eps): a
                   # channel the training clips hold near-constant
                   "data_bn_max_gain": float(np.max(
                       (np.asarray(state["data_bn.running_var"]) + 1e-5) ** -0.5)),
                   **judge(cap, state, clips, labels, held_out, device)}
            if seed in protocol_seeds:
                row["protocol_accuracy_gen_test"], row["protocol_chosen_step"] = protocol(
                    cap, cli.study, state, os.path.join(cli.workdir, "protocol_copy"), device)
            rows.append(row)
            print(f"seed {seed} {kind:8s} epochs {' '.join(f'{a:.3f}' for a in accs)} | "
                  f"kept {row['kept_epoch']} | GT {row['held_out']['accuracy']:.3f} | "
                  + " | ".join(f"{k} acc {row[k]['accuracy']:.3f}, top class "
                               f"{row[k]['top_class']} share {row[k]['top_class_share']:.3f}"
                               for k in clips if k.startswith("gen"))
                  + f" | data_bn gain {row['data_bn_max_gain']:.0f}"
                  + (f" | protocol accuracy_gen_test {row['protocol_accuracy_gen_test']:.4f} "
                     f"(step {row['protocol_chosen_step']})" if seed in protocol_seeds else ""),
                  flush=True)
    with open(os.path.join(cli.workdir, "torch_sweep.json"), "w") as f:
        json.dump({"study": os.path.abspath(cli.study), "generated_steps": steps,
                   "generated_clips": int(len(labels["gt"])), "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
