"""The capability study of regennet_torch: train -> sample -> evaluate on a
task whose labels are learnable from the motion, and check that the
system learns (the counterpart of scripts/capability_study.py).

 1. data: learnable chi3d clips (synthetic.make_clip_pair(learnable=True):
    8 actions, mild actor and strong reactor signatures), held in memory
    and kept as numpy under <workdir>/ds/ for --eval_only;
 2. evaluator: the ST-GCN recognition classifier trained by
    eval/train_stgcn.py with keep_best, kept as
    <workdir>/stgcn_save/model000009999.pt; its held-out accuracy on the
    ground truth;
 3. CMDM: the online trunk trained by train_mdm, its checkpoints kept in
    <workdir>/cmdm_save (model<N>.pt the raw parameters, opt<N>.pt the EMA);
 4. the checkpoint curve: the eval_cmdm protocol (stgcn_eval.evaluate) on
    each checkpoint's EMA with min(64, samples) samples and one seed, and at
    the full scale on its raw parameters too;
 5. selection: the top 2 checkpoints by the curve's train-split accuracy
    (train-split FID breaks ties), each evaluated at the headline size at
    every guidance of the sweep; the best train-split accuracy is the
    trained row (test-split numbers never select); then a random
    initialisation at the chosen guidance and the oracle (the ground-truth
    reactor through the generated side, guidance 1);
 6. the checks of the scale and the calibration against the oracle.

Scales (those of capability_study.py:53-106, 236-315):
  full      the study: 4 layers, latent 128 (4 heads of 32), a 1000-step
            cosine schedule, 12,000 steps at batch 64 on 1024 clips of
            70-110 frames in 60-frame windows; the reference 10-block
            ST-GCN, 20 epochs; evaluation respaced to 100 steps; headline
            128 samples x 3 seeds, guidance swept over 2.5, 3.5 and 5.0;
            the JAX study's seven checks.
  smokefit  the learning guard: 2 layers, latent 64, 50 steps, 800 steps at
            batch 32 on 256 clips of 32-48 frames in 24-frame windows; the
            reduced 4-block ST-GCN, 10 epochs; 32 samples x 1 seed,
            guidance 1; the six thresholds of tests/test_capability_smoke.py.
  smoke     the plumbing only: 2 layers, latent 32, 20 steps at batch 8 on
            32 clips of 24-40 frames in 16-frame windows; 16 x 1.
The training loop runs num_steps // (batches per epoch + 1) epochs, as the
JAX loop does: 11,280 steps at full, 704 at smokefit, 16 at smoke.

Run:  python3 scripts/capability_study_torch.py [--scale full|smoke|smokefit]
          [--device cuda|cpu] [--workdir DIR] [--out FILE.json] [--clips N]
          [--headline_samples N] [--headline_seeds N] [--eval_only DIR]
--eval_only DIR reruns stages 4-6 on a finished workdir from its clips,
classifier, checkpoints and cap_train_config.json. The script writes a JSON
artefact (in the workdir unless --out) and exits 1 when a check misses.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import subprocess
import sys
import tempfile
import time
from argparse import Namespace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CHANCE = 1.0 / 8.0
REDUCED_STGCN = dict(channels=(32, 32, 64, 64), strides=(1, 1, 2, 1))
SCALES = {
    "full": dict(batch=64, diffusion_steps=1000, layers=4, latent=128, lr="1e-4",
                 ema="0.999", log=500, save=2000, steps=12000, frames=60, steps_per_call=8,
                 clips=1024, lengths=(70, 110), stgcn=None, stgcn_epochs=20, threshold=0.90,
                 samples=128, seeds=3, guidances=(2.5, 3.5, 5.0)),
    "smoke": dict(batch=8, diffusion_steps=50, layers=2, latent=32, lr="1e-3", ema="0.99",
                  log=10, save=10, steps=20, frames=16, steps_per_call=2, clips=32,
                  lengths=(24, 40), stgcn=None, stgcn_epochs=3, threshold=0.2, samples=16,
                  seeds=1, guidances=(1.0,)),
    "smokefit": dict(batch=32, diffusion_steps=50, layers=2, latent=64, lr="1e-3",
                     ema="0.99", log=100, save=400, steps=800, frames=24, steps_per_call=2,
                     clips=256, lengths=(32, 48), stgcn=REDUCED_STGCN, stgcn_epochs=10,
                     threshold=0.6, samples=32, seeds=1, guidances=(1.0,)),
}
CURVE_KEYS = ("fid_gen_test", "fid_gen_train", "accuracy_gen_test", "accuracy_gen_train")
STGCN_STEP = 9999  # the kept classifier's file, model000009999.pt, as the JAX study's


def log(msg):
    print(f"[capability] {msg}", file=sys.stderr, flush=True)


def train_args(save_dir: str, scale: str = "smokefit"):
    """The scale's CMDM training configuration as train_mdm arguments."""
    from regennet_torch.utils import parser_util

    s = SCALES[scale]
    return parser_util.train_args([
        "--save_dir", save_dir, "--overwrite", "--seed", "10",
        "--batch_size", str(s["batch"]), "--diffusion_steps", str(s["diffusion_steps"]),
        "--setting", "cmdm", "--arch", "online", "--cm_mode", "concat",
        "--layers", str(s["layers"]), "--latent_dim", str(s["latent"]),
        "--cond_mask_prob", "0.1", "--lambda_orient", "0", "--lambda_body", "0",
        "--lambda_transl", "0", "--dataset", "chi3d", "--num_person", "2",
        "--body_model", "smplx", "--shuffle", "--lr", s["lr"], "--ema_rate", s["ema"],
        "--log_interval", str(s["log"]), "--save_interval", str(s["save"]),
        "--num_steps", str(s["steps"]), "--num_frames", str(s["frames"]),
        "--steps_per_call", str(s["steps_per_call"]),
    ])


def stgcn_args(save_dir: str, scale: str = "smokefit"):
    s = SCALES[scale]
    size = s["stgcn"] or {}
    return Namespace(
        dataset="chi3d", data_path="", pose_rep="rot6d", body_model="smplx",
        glob=True, translation=True, num_frames=s["frames"], batch_size=32, lr=1e-3,
        num_epochs=s["stgcn_epochs"], save_every=1000, save_dir=save_dir, seed=0,
        keep_best=True, stgcn_channels=size.get("channels"), stgcn_strides=size.get("strides"),
    )


def feeder(pair, num_frames, ar_shuffle=False):
    from regennet_torch.data.feeder import Feeder

    return Feeder(clips=pair["train"], test_clips=pair["test"], dataname="chi3d",
                  split="train", num_frames=num_frames, num_person=2, pose_rep="rot6d",
                  ar_shuffle=ar_shuffle)


def save_clips(ds_dir, pair):
    import numpy as np

    os.makedirs(ds_dir, exist_ok=True)
    for split, clips in pair.items():
        np.savez(os.path.join(ds_dir, f"chi3d_{split}.npz"), **clips)


def load_clips(ds_dir):
    import numpy as np

    pair = {}
    for split in ("train", "test"):
        with np.load(os.path.join(ds_dir, f"chi3d_{split}.npz")) as f:
            pair[split] = {k: f[k] for k in f.files}
    return pair


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


def full_checks(results):
    """{name: (held, the numbers compared)}: the full scale's seven checks,
    those of capability_study.py:597-617 letter for letter."""
    def metric(row, key):
        return results[row][key]["mean"] if key in results[row] else None

    acc_tr, acc_rd, acc_or = (metric(r, "accuracy_gen_test")
                              for r in ("trained", "random_init", "oracle"))
    fid_tr, fid_rd = metric("trained", "fid_gen_test"), metric("random_init", "fid_gen_test")
    curve = results["fid_vs_step"]
    first = curve[0].get("fid_gen_test", 0) if curve else 0
    last = curve[-1].get("fid_gen_test", 1e9) if curve else 1e9
    return {
        "evaluator_gt_acc>=0.90": (results["evaluator"]["pass"],
                                   f"evaluator GT accuracy "
                                   f"{results['evaluator']['gt_test_accuracy']:.4f} >= 0.90"),
        "accuracy_gen_trained>4x_chance": ((acc_tr or 0) > 0.5,
                                           f"trained accuracy {acc_tr} > 0.5"),
        "accuracy_gen_trained>>random": ((acc_tr or 0) > (acc_rd or 0) + 0.2,
                                         f"trained accuracy {acc_tr} > random-init {acc_rd} "
                                         "+ 0.2"),
        "fid_gen_trained<<random": (fid_tr is not None and fid_rd is not None
                                    and fid_tr < 0.25 * fid_rd,
                                    f"trained FID {fid_tr} < 0.25 x random-init FID {fid_rd}"),
        "fid_curve_improves": (len(curve) >= 2 and last < first * 0.8,
                               f"last curve FID {last} < 0.8 x first {first}"),
        "oracle_is_ceiling": (acc_or is not None and (acc_tr or 0.0) <= acc_or + 0.05,
                              f"trained accuracy {acc_tr} <= oracle {acc_or} + 0.05"),
        "oracle_preserves_signal": ((acc_or or 0.0) >= 0.75,
                                    f"oracle accuracy {acc_or} >= 0.75"),
    }


def smoke_checks(results):
    return {"smoke_plumbing_only": (True, "smoke runs the plumbing, not a learning check")}


CHECKS = {"full": full_checks, "smokefit": guard_checks, "smoke": smoke_checks}


def require_learning(results):
    """Raises AssertionError naming every check that misses, with its
    numbers."""
    missed = [what for held, what in guard_checks(results).values() if not held]
    if missed:
        raise AssertionError("the learning guard missed: " + "; ".join(missed))


def calibration(results):
    """The trained row against the oracle (the protocol's ceiling) and chance."""
    def acc(row):
        return results[row]["accuracy_gen_test"]["mean"]

    return {
        "note": "oracle = GT reactor through the generated-side pipeline; the "
                "trained-vs-oracle gap is model quality, the oracle-vs-1.0 gap is the "
                "protocol's ceiling (windowing, concat, evaluator)",
        "trained_over_oracle_accuracy": acc("trained") / acc("oracle") if acc("oracle") else None,
        "accuracy_multiple_of_chance": acc("trained") / CHANCE,
        "oracle_accuracy_gen_test": acc("oracle"),
        "oracle_fid_gen_test": results["oracle"]["fid_gen_test"]["mean"],
        "trained_fid_gen_test": results["trained"]["fid_gen_test"]["mean"],
    }


def rank_curve(curve, fallback_step):
    """The top 2 steps by the curve's accuracy_gen_train, fid_gen_train
    breaking ties (a stable sort: the earlier step first on a full tie)."""
    ranked = sorted((p for p in curve if "accuracy_gen_train" in p),
                    key=lambda p: (-p["accuracy_gen_train"], p.get("fid_gen_train", 1e18)))
    return [p["step"] for p in ranked[:2]] or [fallback_step]


def choose(headline):
    """{(step, guidance): {"accuracy_gen_train": mean, ...}} in (candidate,
    guidance) order -> the (step, guidance) of the best train-split accuracy;
    a tie goes to the earlier entry, as max() over the JAX study's dict."""
    return max(headline, key=lambda k: headline[k]["accuracy_gen_train"])


def default_respacing(args_t):
    """The evaluation's respacing: 100 steps of a 1000-step schedule, else
    the whole schedule."""
    return "100" if args_t.diffusion_steps >= 1000 else ""


def evaluate_row(args_t, data, evaluator, device, state=None, guidance=1.0, respacing=None,
                 num_samples=32, num_seeds=1, seed_start=0, oracle=False, seed=0):
    """One eval_cmdm protocol run (its summary): the model of `state` (a state
    dict), or a random initialisation drawn after fixseed(seed); oracle
    routes the ground-truth reactor through the generated side instead of
    sampling. respacing None: default_respacing."""
    import torch

    from regennet_torch.eval import stgcn_eval
    from regennet_torch.models.cmdm import make_cfg_model_fn, make_model_fn
    from regennet_torch.utils.fixseed import fixseed
    from regennet_torch.utils.model_util import create_model_and_diffusion

    ea = Namespace(**vars(args_t))
    # the protocol batch of 32 (eval_cmdm's), clamped so the drop_last
    # loaders keep a batch at the smoke scale
    ea.batch_size = min(32, num_samples)
    ea.num_samples, ea.num_seeds, ea.seed_start = num_samples, num_seeds, seed_start
    ea.guidance_param = guidance
    ea.timestep_respacing = default_respacing(args_t) if respacing is None else respacing
    fixseed(seed)
    model, sched, cfg = create_model_and_diffusion(ea, data, device=device)
    if state is not None:
        model.load_state_dict(state, strict=True)
    model = model.to(device=device, dtype=torch.float32).eval()

    def model_fn_builder():
        if guidance != 1.0:
            return make_cfg_model_fn(model, guidance)
        return make_model_fn(model)

    return summarize(stgcn_eval.evaluate(ea, model_fn_builder, sched, cfg, data, evaluator,
                                         oracle=oracle))


def checkpoints(save_dir):
    """{step: (raw state dict file, EMA state dict)} of the run, in step order."""
    import torch

    from regennet_torch.train import checkpoint

    steps = sorted(int(m.group(1)) for m in map(checkpoint.CKPT_RE.match, os.listdir(save_dir))
                   if m and m.group(2))
    return {step: (os.path.join(save_dir, checkpoint.ckpt_name(step)),
                   torch.load(os.path.join(save_dir, checkpoint.opt_name(step)),
                              map_location="cpu", weights_only=True)["ema"])
            for step in steps}


@contextlib.contextmanager
def counted_sampling(steps):
    """Appends each sampling loop's denoiser steps to `steps` while open."""
    from regennet_torch.diffusion import sampling

    loop = sampling.p_sample_loop

    def counted(sched, *a, **kw):
        steps.append(sched.num_timesteps)
        return loop(sched, *a, **kw)

    sampling.p_sample_loop = counted
    try:
        yield
    finally:
        sampling.p_sample_loop = loop


def card(device):
    """The card's torch name and nvidia-smi's name and power limit, or None
    off the card."""
    import torch

    if device.type != "cuda":
        return None
    try:
        lines = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        lines = []
    index = device.index or 0
    return {"name": torch.cuda.get_device_name(device),
            "name_power_limit": lines[index].strip() if len(lines) > index else None}


def run_study(device="cuda", workdir=None, scale="smokefit", clips=0, headline_samples=0,
              headline_seeds=0, eval_only=False):
    """Run the stages (with eval_only, 4-6 on the finished `workdir`);
    returns the artefact (checks and ok included)."""
    import numpy as np
    import torch

    from regennet_torch.data import synthetic
    from regennet_torch.data.collate import ccollate, collate
    from regennet_torch.data.get_data import BatchLoader
    from regennet_torch.device import pin_f32_contract, resolve_device
    from regennet_torch.eval import stgcn_eval, train_stgcn
    from regennet_torch.ops import attention
    from regennet_torch.train import checkpoint, train_mdm

    device = resolve_device(device)
    pin_f32_contract()  # before the ST-GCN is trained or loaded, --eval_only too
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    s = SCALES[scale]
    workdir = workdir or tempfile.mkdtemp(prefix="capability_torch_")
    ds_dir, stgcn_dir = os.path.join(workdir, "ds"), os.path.join(workdir, "stgcn_save")
    config_path = os.path.join(workdir, "cap_train_config.json")
    walls = {}
    t00 = time.perf_counter()
    results = {"study": "capability_torch", "device": str(device), "card": card(device),
               "scale": scale, "walls_s": walls}
    b1, b2 = attention.fused_attention_btd, attention.fused_attention_btd_train
    b1.launches = b2.launches = b2.backward_launches = 0
    for by_tokens in (b1.launches_by_tokens, b2.launches_by_tokens,
                      b2.backward_launches_by_tokens):
        by_tokens.clear()

    t0 = time.perf_counter()
    if eval_only:
        with open(config_path) as f:
            recorded = json.load(f)
        if recorded["scale"] != scale:
            raise ValueError(f"--eval_only {workdir}: a {recorded['scale']} run, not {scale}")
        pair = load_clips(ds_dir)
    else:
        n = clips or s["clips"]
        pair = synthetic.make_clip_pair("chi3d", n, min_len=s["lengths"][0],
                                        max_len=s["lengths"][1], learnable=True)
        save_clips(ds_dir, pair)
    data = feeder(pair, s["frames"])
    walls["data"] = time.perf_counter() - t0
    results["dataset"] = {"num_clips_train": len(pair["train"]),
                          "num_clips_test": len(pair["test"]), "num_actions": 8,
                          "clip_lengths": list(s["lengths"]), "reused": eval_only}
    log(f"{len(pair['train'])} + {len(pair['test'])} learnable clips")

    t0 = time.perf_counter()
    sargs = stgcn_args(stgcn_dir, scale)
    rec_path = os.path.join(stgcn_dir, checkpoint.ckpt_name(STGCN_STEP))
    if eval_only:
        state = rec_path
    else:
        classifier = train_stgcn.run_training(sargs, device=device, data=data)
        train_stgcn.save_stgcn(stgcn_dir, STGCN_STEP, classifier)
        state = classifier.state_dict()
    sync()
    walls["evaluator_training"] = time.perf_counter() - t0
    evaluator = stgcn_eval.STGCNEvaluator("chi3d", "smplx", 8, 12, 2, state, device=device,
                                          **(s["stgcn"] or {}))
    test = copy.deepcopy(data)
    test.split = "test"
    hits = []
    for motion, cond in BatchLoader(test, 32, collate, shuffle=False, drop_last=False):
        hits.append(np.argmax(evaluator({"output": motion})["yhat"], 1)
                    == cond["y"]["action"][:, 0])
    gt_acc = float(np.concatenate(hits).mean())
    results["evaluator"] = {"gt_test_accuracy": gt_acc, "chance": CHANCE,
                            "epochs": sargs.num_epochs, "threshold": s["threshold"],
                            "pass": gt_acc >= s["threshold"], "reused": eval_only}
    log(f"evaluator GT test accuracy {gt_acc:.3f} ({walls['evaluator_training']:.1f} s)")

    args_t = train_args(os.path.join(workdir, "cmdm_save"), scale)
    if eval_only:
        ckpts = checkpoints(args_t.save_dir)
        results["cmdm_training"] = dict(recorded, steps=max(ckpts), reused=workdir)
    else:
        t0 = time.perf_counter()
        loader = BatchLoader(feeder(pair, s["frames"], ar_shuffle=args_t.shuffle),
                             args_t.batch_size, ccollate)
        loop = train_mdm.main(args_t, device=device, data=loader)
        sync()
        walls["cmdm_training"] = time.perf_counter() - t0
        results["cmdm_training"] = {"scale": scale, "steps": loop.state_step,
                                    "batch_size": args_t.batch_size,
                                    "latent_dim": args_t.latent_dim, "layers": args_t.layers,
                                    "diffusion_steps": args_t.diffusion_steps,
                                    "steps_per_call": args_t.steps_per_call,
                                    "lr_anneal_steps": args_t.lr_anneal_steps,
                                    "ema_rate": args_t.ema_rate}
        with open(config_path, "w") as f:  # what --eval_only reports as trained
            json.dump(results["cmdm_training"], f, indent=1)
        log(f"CMDM trained {loop.state_step} steps in {walls['cmdm_training']:.1f} s")
        del loop, loader
        ckpts = checkpoints(args_t.save_dir)

    num_samples = headline_samples or s["samples"]
    num_seeds = headline_seeds or s["seeds"]
    guidances = s["guidances"]
    results["eval_protocol"] = {"num_samples": num_samples, "num_seeds": num_seeds,
                                "guidance_param": guidances[0],
                                "timestep_respacing": default_respacing(args_t),
                                "batch_size": min(32, num_samples),
                                "scale_default": [s["samples"], s["seeds"]]}
    sampling_steps = []
    with counted_sampling(sampling_steps):
        # the curve: the EMA of each checkpoint (and at full its raw
        # parameters), one seed, the first guidance, the default respacing
        t0 = time.perf_counter()
        curve, curve_n = [], min(64, num_samples)
        for step, (raw_path, ema) in ckpts.items():
            summary = evaluate_row(args_t, data, evaluator, device, state=ema,
                                   guidance=guidances[0], num_samples=curve_n)
            point = {"step": step, **{k: summary[k]["mean"] for k in CURVE_KEYS
                                      if k in summary}}
            if scale == "full":
                raw = evaluate_row(args_t, data, evaluator, device,
                                   state=checkpoint.load_state_dict(raw_path),
                                   guidance=guidances[0], num_samples=curve_n)
                for k in ("fid_gen_test", "accuracy_gen_test"):
                    if k in raw:
                        point[f"raw_{k}"] = raw[k]["mean"]
            curve.append(point)
            log(f"curve point {point}")
        sync()
        walls["curve"] = time.perf_counter() - t0
        results["fid_vs_step"] = curve

        t0 = time.perf_counter()
        top2 = rank_curve(curve, max(ckpts))
        candidates = {}
        for step in top2:
            for g in guidances:
                candidates[(step, g)] = evaluate_row(
                    args_t, data, evaluator, device, state=ckpts[step][1], guidance=g,
                    num_samples=num_samples, num_seeds=num_seeds)
                log(f"headline ckpt {step} g={g}: accuracy_gen_train "
                    f"{candidates[(step, g)]['accuracy_gen_train']['mean']:.3f}, "
                    f"accuracy_gen_test {candidates[(step, g)]['accuracy_gen_test']['mean']:.3f}")
        headline = {k: {m: v[m]["mean"] for m in ("accuracy_gen_train", "accuracy_gen_test",
                                                  "fid_gen_test")}
                    for k, v in candidates.items()}
        best_step, best_g = choose(headline)
        sync()
        walls["headline"] = time.perf_counter() - t0
        results["selection"] = {
            "rule": "top-2 checkpoints by the curve's accuracy_gen_train (one seed), "
                    "fid_gen_train breaking ties; the headline protocol on each at every "
                    "guidance of the sweep; the best accuracy_gen_train is the trained row "
                    "(test-split numbers never select)",
            "candidates": top2, "guidance_sweep": list(guidances),
            "chosen_step": best_step, "chosen_guidance": best_g,
            "candidate_headline": {f"ckpt{st}_g{g}": v for (st, g), v in headline.items()}}
        results["eval_protocol"]["guidance_param"] = best_g
        results["trained"] = candidates[(best_step, best_g)]
        log(f"chosen: step {best_step}, guidance {best_g}")

        for row, kw in (("random_init", dict(guidance=best_g)),
                        ("oracle", dict(guidance=1.0, oracle=True))):
            t0 = time.perf_counter()
            results[row] = evaluate_row(args_t, data, evaluator, device, num_samples=num_samples,
                                        num_seeds=num_seeds, **kw)
            sync()
            walls[f"eval_{row}"] = time.perf_counter() - t0
            log(f"{row}: accuracy_gen_test {results[row]['accuracy_gen_test']['mean']:.3f}, "
                f"fid_gen_test {results[row]['fid_gen_test']['mean']:.4g} "
                f"({walls[f'eval_{row}']:.1f} s)")

    on_card = device.type == "cuda"
    trained_steps = 0 if eval_only else results["cmdm_training"]["steps"]
    results["launches"] = {
        "fused_attention_btd": {
            "total": b1.launches, "by_tokens": dict(b1.launches_by_tokens),
            "expected": args_t.layers * sum(sampling_steps) * on_card},
        "fused_attention_btd_train": {
            "forward": b2.launches, "backward": b2.backward_launches,
            "forward_by_tokens": dict(b2.launches_by_tokens),
            "backward_by_tokens": dict(b2.backward_launches_by_tokens),
            "expected_each_way": args_t.layers * trained_steps * on_card},
        "sampling_calls": len(sampling_steps), "sampling_steps": sum(sampling_steps)}
    results["calibration"] = calibration(results)
    checks = CHECKS[scale](results)
    results["checks"] = {name: held for name, (held, _) in checks.items()}
    results["checked"] = [what for _, what in checks.values()]
    results["ok"] = all(results["checks"].values())
    results["total_s"] = time.perf_counter() - t00
    results["workdir"] = workdir
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", default="full", choices=sorted(SCALES))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default="", help="the artefact's path (default: in the workdir)")
    ap.add_argument("--workdir", default="", help="default: a new temporary directory")
    ap.add_argument("--eval_only", default="",
                    help="a finished workdir of this scale: reuse its clips, classifier "
                         "and checkpoints, rerun only the curve, selection and headline")
    ap.add_argument("--headline_samples", type=int, default=0,
                    help="the headline's num_samples (0: the scale's; the reference "
                         "protocol is 1000)")
    ap.add_argument("--headline_seeds", type=int, default=0,
                    help="the headline's num_seeds (0: the scale's; the reference "
                         "protocol is 20)")
    ap.add_argument("--clips", type=int, default=0,
                    help="train-split clips (0: the scale's); the test split holds "
                         "max(clips // 2, 4)")
    cli = ap.parse_args(argv)
    results = run_study(cli.device, cli.eval_only or cli.workdir or None, cli.scale,
                        clips=cli.clips, headline_samples=cli.headline_samples,
                        headline_seeds=cli.headline_seeds, eval_only=bool(cli.eval_only))
    cli.out = cli.out or os.path.join(results["workdir"], f"capability_{cli.scale}_torch.json")
    with open(cli.out, "w") as f:
        json.dump(results, f, indent=1)
    missed = [n for n, held in results["checks"].items() if not held]
    log(f"ok={results['ok']} in {results['total_s']:.1f} s"
        + (f"; missed {missed}" if missed else "") + f"; artefact {cli.out}")
    return 0 if results["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
