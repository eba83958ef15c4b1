"""The learning guard of regennet_torch: train -> sample -> evaluate on a
task whose labels are learnable from the motion, and check that the
system learns.

The smokefit scale of scripts/capability_study.py, through the port:
 1. data: 256 learnable chi3d clips of 32-48 frames (and 128 test clips),
    synthetic.make_clip_pair(learnable=True), held in memory;
 2. evaluator: the reduced 4-block ST-GCN (channels 32, 32, 64, 64;
    strides 1, 1, 2, 1) trained 10 epochs at lr 1e-3 with keep_best
    (eval/train_stgcn.py); its held-out accuracy on ground truth;
 3. CMDM: the online trunk (2 layers, latent 64, 4 heads, 24 frames,
    cm_mode concat) trained by train_mdm with --num_steps 800 at batch 32,
    lr 1e-3, EMA 0.99, on a 50-step cosine schedule (the loop's epoch
    count, 800 // (8 batches + 1) = 88, ends it at 704 steps, as the JAX
    loop's does);
 4. the eval_cmdm protocol (stgcn_eval.evaluate, every metric) on 32
    samples with one seed and guidance 1.0, sampling the full 50 steps,
    for three rows: the trained EMA weights, a random initialisation, and
    the oracle (the ground-truth reactor through the generated side);
 5. the checks: trained beats chance and random, its FID collapses
    against random, the oracle keeps the signal, sits far below the trained
    FID and bounds the trained accuracy (those of the JAX study and its
    test, tests/test_capability_smoke.py).
The JAX study's checkpoint curve and guidance sweep are left out: the
trained row is the final EMA.

Run:  python3 scripts/capability_study_torch.py [--device cuda|cpu] \\
          [--workdir DIR] [--out FILE.json]
It writes the JSON artefact (the fields tests/test_capability_smoke.py
reads, `checks`, `ok` and the wall of each stage) and exits 1 when a check
misses.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import tempfile
import time
from argparse import Namespace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

NUM_CLIPS, MIN_LEN, MAX_LEN, NUM_FRAMES = 256, 32, 48, 24
STGCN_SIZE = dict(channels=(32, 32, 64, 64), strides=(1, 1, 2, 1))
NUM_SAMPLES, NUM_SEEDS, GUIDANCE = 32, 1, 1.0
CHANCE = 1.0 / 8.0


def log(msg):
    print(f"[capability] {msg}", file=sys.stderr, flush=True)


def train_args(save_dir: str, steps: int = 800):
    """The smokefit CMDM training configuration as train_mdm arguments."""
    from regennet_torch.utils import parser_util

    return parser_util.train_args([
        "--save_dir", save_dir, "--overwrite", "--seed", "10", "--batch_size", "32",
        "--diffusion_steps", "50", "--setting", "cmdm", "--arch", "online",
        "--cm_mode", "concat", "--layers", "2", "--latent_dim", "64",
        "--cond_mask_prob", "0.1", "--lambda_orient", "0", "--lambda_body", "0",
        "--lambda_transl", "0", "--dataset", "chi3d", "--num_person", "2",
        "--body_model", "smplx", "--shuffle", "--lr", "1e-3", "--ema_rate", "0.99",
        "--log_interval", "100", "--save_interval", "400", "--num_steps", str(steps),
        "--num_frames", str(NUM_FRAMES), "--steps_per_call", "2",
    ])


def stgcn_args(save_dir: str, epochs: int = 10):
    return Namespace(
        dataset="chi3d", data_path="", pose_rep="rot6d", body_model="smplx",
        glob=True, translation=True, num_frames=NUM_FRAMES, batch_size=32, lr=1e-3,
        num_epochs=epochs, save_every=1000, save_dir=save_dir, seed=0, keep_best=True,
        stgcn_channels=STGCN_SIZE["channels"], stgcn_strides=STGCN_SIZE["strides"],
    )


def feeder(pair, ar_shuffle=False):
    from regennet_torch.data.feeder import Feeder

    return Feeder(clips=pair["train"], test_clips=pair["test"], dataname="chi3d",
                  split="train", num_frames=NUM_FRAMES, num_person=2, pose_rep="rot6d",
                  ar_shuffle=ar_shuffle)


def summarize(eval_dict):
    """mean / min / max over the seeds of each metric."""
    import numpy as np

    out = {}
    for k, vals in eval_dict["feats"].items():
        arr = np.asarray([float(v) for v in vals])
        out[k] = {"mean": float(arr.mean()), "min": float(arr.min()),
                  "max": float(arr.max()), "n_seeds": len(arr)}
    return out


def guard_checks(results):
    """{name: (held, the numbers compared)}: the smokefit checks of
    scripts/capability_study.py and the six thresholds
    tests/test_capability_smoke.py holds the JAX study to."""
    acc = {k: results[k]["accuracy_gen_test"]["mean"] for k in
           ("trained", "random_init", "oracle")}
    fid = {k: results[k]["fid_gen_test"]["mean"] for k in
           ("trained", "random_init", "oracle")}
    gt = results["evaluator"]["gt_test_accuracy"]
    return {
        "evaluator_pass": (gt >= 0.6, f"evaluator GT accuracy {gt:.4f} >= 0.6"),
        "trained_acc_above_chance": (acc["trained"] > CHANCE + 0.10,
                                     f"trained accuracy {acc['trained']:.4f} > chance + 0.10"),
        "trained_acc_above_random": (acc["trained"] > acc["random_init"],
                                     f"trained accuracy {acc['trained']:.4f} > random-init "
                                     f"{acc['random_init']:.4f}"),
        "trained_fid_much_below_random": (fid["trained"] < 0.25 * fid["random_init"],
                                          f"trained FID {fid['trained']:.4g} < 0.25 x "
                                          f"random-init FID {fid['random_init']:.4g}"),
        "oracle_preserves_signal": (acc["oracle"] >= 0.5,
                                    f"oracle accuracy {acc['oracle']:.4f} >= 0.5"),
        "oracle_fid_far_below_trained": (fid["oracle"] < 0.1 * max(fid["trained"], 1e-9),
                                         f"oracle FID {fid['oracle']:.4g} < 0.1 x trained "
                                         f"FID {fid['trained']:.4g}"),
        "oracle_is_ceiling": (acc["trained"] <= acc["oracle"] + 0.05,
                              f"trained accuracy {acc['trained']:.4f} <= oracle "
                              f"{acc['oracle']:.4f} + 0.05"),
    }


def require_learning(results):
    """Raises AssertionError naming every check that misses, with its
    numbers."""
    missed = [what for held, what in guard_checks(results).values() if not held]
    if missed:
        raise AssertionError("the learning guard missed: " + "; ".join(missed))


def evaluate_row(args_t, data, evaluator, device, state=None, oracle=False, seed=0):
    """One eval_cmdm protocol run: the model of `state` (a state dict), or
    a random initialisation from `seed`; oracle routes the ground-truth
    reactor through the generated side instead of sampling."""
    import torch

    from regennet_torch.eval import stgcn_eval
    from regennet_torch.models.cmdm import make_cfg_model_fn, make_model_fn
    from regennet_torch.utils.fixseed import fixseed
    from regennet_torch.utils.model_util import create_model_and_diffusion

    ea = Namespace(**vars(args_t))
    ea.batch_size = min(32, NUM_SAMPLES)
    ea.num_samples, ea.num_seeds, ea.seed_start = NUM_SAMPLES, NUM_SEEDS, 0
    ea.guidance_param = GUIDANCE
    ea.timestep_respacing = ""  # the full 50-step schedule
    fixseed(seed)
    model, sched, cfg = create_model_and_diffusion(ea, data, device=device)
    if state is not None:
        model.load_state_dict(state, strict=True)
    model = model.to(device=device, dtype=torch.float32).eval()

    def model_fn_builder():
        if GUIDANCE != 1.0:
            return make_cfg_model_fn(model, GUIDANCE)
        return make_model_fn(model)

    return summarize(stgcn_eval.evaluate(ea, model_fn_builder, sched, cfg, data, evaluator,
                                         oracle=oracle))


def run_study(device="cuda", workdir=None, steps=800, epochs=10):
    """Run the five stages; returns the artefact (checks and ok included)."""
    import numpy as np
    import torch

    from regennet_torch.data import synthetic
    from regennet_torch.data.collate import ccollate, collate
    from regennet_torch.data.get_data import BatchLoader
    from regennet_torch.device import resolve_device
    from regennet_torch.eval import stgcn_eval, train_stgcn
    from regennet_torch.train import train_mdm

    device = resolve_device(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    workdir = workdir or tempfile.mkdtemp(prefix="capability_torch_")
    walls = {}
    t00 = time.perf_counter()
    results = {"study": "capability_smokefit_torch", "device": str(device),
               "scale": "smokefit", "walls_s": walls}

    t0 = time.perf_counter()
    pair = synthetic.make_clip_pair("chi3d", NUM_CLIPS, min_len=MIN_LEN, max_len=MAX_LEN,
                                    learnable=True)
    data = feeder(pair)
    walls["data"] = time.perf_counter() - t0
    results["dataset"] = {"num_clips_train": len(pair["train"]),
                          "num_clips_test": len(pair["test"]), "num_actions": 8}
    log(f"{len(pair['train'])} + {len(pair['test'])} learnable clips in memory")

    t0 = time.perf_counter()
    sargs = stgcn_args(os.path.join(workdir, "stgcn_save"), epochs)
    classifier = train_stgcn.run_training(sargs, device=device, data=data)
    sync()
    walls["evaluator_training"] = time.perf_counter() - t0
    evaluator = stgcn_eval.STGCNEvaluator(
        "chi3d", "smplx", 8, 12, 2, classifier.state_dict(), device=device, **STGCN_SIZE)
    test = copy.deepcopy(data)
    test.split = "test"
    hits = []
    for motion, cond in BatchLoader(test, 32, collate, shuffle=False, drop_last=False):
        hits.append(np.argmax(evaluator({"output": motion})["yhat"], 1)
                    == cond["y"]["action"][:, 0])
    gt_acc = float(np.concatenate(hits).mean())
    results["evaluator"] = {"gt_test_accuracy": gt_acc, "chance": CHANCE,
                            "epochs": epochs, "threshold": 0.6, "pass": gt_acc >= 0.6}
    log(f"evaluator GT test accuracy {gt_acc:.3f} ({walls['evaluator_training']:.1f} s)")

    t0 = time.perf_counter()
    args_t = train_args(os.path.join(workdir, "cmdm_save"), steps)
    loader = BatchLoader(feeder(pair, ar_shuffle=args_t.shuffle), args_t.batch_size, ccollate)
    loop = train_mdm.main(args_t, device=device, data=loader)
    sync()
    walls["cmdm_training"] = time.perf_counter() - t0
    ema = {k: v.detach().clone() for k, v in loop.ema.items()}
    results["cmdm_training"] = {"steps": loop.state_step, "batch_size": args_t.batch_size,
                                "latent_dim": args_t.latent_dim, "layers": args_t.layers,
                                "diffusion_steps": args_t.diffusion_steps,
                                "ema_rate": args_t.ema_rate}
    log(f"CMDM trained {loop.state_step} steps in {walls['cmdm_training']:.1f} s")
    del loop

    results["eval_protocol"] = {"num_samples": NUM_SAMPLES, "num_seeds": NUM_SEEDS,
                                "guidance_param": GUIDANCE, "timestep_respacing": "",
                                "batch_size": min(32, NUM_SAMPLES)}
    for row, kw in (("trained", dict(state=ema)), ("random_init", {}),
                    ("oracle", dict(oracle=True))):
        t0 = time.perf_counter()
        results[row] = evaluate_row(args_t, data, evaluator, device, **kw)
        sync()
        walls[f"eval_{row}"] = time.perf_counter() - t0
        log(f"{row}: accuracy_gen_test {results[row]['accuracy_gen_test']['mean']:.3f}, "
            f"fid_gen_test {results[row]['fid_gen_test']['mean']:.4g} "
            f"({walls[f'eval_{row}']:.1f} s)")

    checks = guard_checks(results)
    results["checks"] = {name: held for name, (held, _) in checks.items()}
    results["checked"] = [what for _, what in checks.values()]
    results["ok"] = all(results["checks"].values())
    results["total_s"] = time.perf_counter() - t00
    results["workdir"] = workdir
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default="",
                    help="the artefact's path (default: in the workdir)")
    ap.add_argument("--workdir", default="", help="default: a new temporary directory")
    cli = ap.parse_args(argv)
    results = run_study(cli.device, cli.workdir or None)
    cli.out = cli.out or os.path.join(results["workdir"], "capability_smokefit_torch.json")
    with open(cli.out, "w") as f:
        json.dump(results, f, indent=1)
    log(f"ok={results['ok']} in {results['total_s']:.1f} s; artefact {cli.out}")
    return 0 if results["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
