"""ACTOR CVAE/CAE baseline evaluation: `python -m regennet_torch.eval.evaluate_cvae`
(counterpart of regennet_tpu/eval/evaluate_cvae.py).

Loads a checkpoint of `train.train_cvae` (model<N>.pt, the model rebuilt
from the args.json beside it) and scores generated motions against the
dataset by a frozen classifier, per seed:

- the ST-GCN route (ntu, chi3d, uestc): shuffle both splits, build the
  ground-truth batches of train and test, then generated batches over a
  second pass of the same loaders (`model.decode` of one latent per item
  at the batch's classes, or the autotrans decoder frame by frame; the
  transformer decoder's self-attention through B1 `fused_attention_btd`),
  and the ACTOR metric assembly (`evaluate_seed_metrics(...,
  actor_quirks=True)`);
- the GRU route (humanact12), pinned at 60 frames: generated, ground-truth
  and second ground-truth batches decoded to SMPL joints and scored by the
  GRU classifier (accuracy, FID, diversity, multimodality, the a2m quirks).

`--other_metrics` adds the output-space metrics of eval/othermetrics.py
on the test split's generated batches. The results go to
`evaluation_results_<run>_<mode>_<N>.yaml` beside the checkpoint. The
classifier is --rec_model_path (a released file or the port's .pt), or
drawn from --seed with 'random'. The host streams (`random` for shuffles
and windows, numpy's for the metric draws) are consumed in the JAX
package's order; the latents come from a torch.Generator seeded by each
evaluation seed, or from the caller's `draw_z`.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from regennet_torch.data.collate import collate
from regennet_torch.data.get_data import BatchLoader, get_dataset
from regennet_torch.device import pin_f32_contract, resolve_device
from regennet_torch.eval import metrics as M
from regennet_torch.eval import othermetrics
from regennet_torch.eval.eval_humanact12_uestc import _classifier_state
from regennet_torch.eval.stgcn_eval import STGCNEvaluator, build_gt_batches, evaluate_seed_metrics
from regennet_torch.eval.tools import save_metrics
from regennet_torch.models import gru_classifier, stgcn
from regennet_torch.models.actor_cvae import ActorCVAE
from regennet_torch.train import checkpoint
from regennet_torch.utils.fixseed import fixseed
from regennet_torch.utils.parser_util import device_arg

# the dataset dispatch: humanact12 goes to the GRU (action2motion)
# evaluator, the rest to the ST-GCN harness
DATASET_EVAL = {
    "ntu": {"num_classes": 26, "num_person": 2, "harness": "stgcn"},
    "chi3d": {"num_classes": 8, "num_person": 2, "harness": "stgcn"},
    "uestc": {"num_classes": 40, "num_person": 1, "harness": "stgcn"},
    "humanact12": {"num_classes": 12, "num_person": 1, "harness": "gru"},
}

# draw_z(seed, pass_index) -> (batch_size -> latents [batch_size, D])
ZDraws = Callable[[int, int], Callable[[int], torch.Tensor]]


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", required=True, type=str)
    p.add_argument("--data_path", required=True, type=str)
    p.add_argument("--dataset", default="chi3d", type=str)
    p.add_argument("--rec_model_path", default="random", type=str,
                   help="frozen recognition classifier, or 'random' (drawn from --seed)")
    p.add_argument("--eval_mode", default="debug", type=str, choices=["debug", "full"])
    p.add_argument("--batch_size", default=32, type=int)
    p.add_argument("--num_frames", default=0, type=int)
    p.add_argument("--other_metrics", action="store_true")
    p.add_argument("--num_seeds", default=0, type=int,
                   help="the evaluation seed count; 0 = 1 for debug, 20 for full")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default=0, type=device_arg,
                   help="CUDA device id (the run is on cuda:<id>), or 'cpu'.")
    return p.parse_args(argv)


def _load_model(args):
    """(model, train args, body model, num_person, num_frames) of the
    checkpoint, the model on the CPU in eval mode."""
    args_path = os.path.join(os.path.dirname(args.model_path.rstrip("/")), "args.json")
    train_args = {}
    if os.path.exists(args_path):
        with open(args_path) as f:
            train_args = json.load(f)
    spec = DATASET_EVAL[args.dataset]
    body_model = train_args.get("body_model", "smplx")
    num_person = int(train_args.get("num_person", spec["num_person"]))
    # the data-derived layout the trainer records
    njoints = int(train_args.get("njoints", {"smpl": 25, "smplx": 56}[body_model]))
    nfeats = int(train_args.get("nfeats", 6 * num_person))
    num_actions = int(train_args.get("num_actions", spec["num_classes"]))
    num_frames = args.num_frames or int(train_args.get("num_frames", 60))
    if spec["harness"] == "gru" and not args.num_frames:
        num_frames = 60  # the action2motion protocol is pinned at 60 frames
    model = ActorCVAE(njoints=njoints, nfeats=nfeats, num_actions=num_actions,
                      latent_dim=int(train_args.get("latent_dim", 256)),
                      num_layers=int(train_args.get("num_layers", 4)),
                      arch=train_args.get("arch", "transformer"), num_frames=num_frames,
                      vae=train_args.get("modeltype", "cvae") == "cvae")
    checkpoint.load_model(model, args.model_path)
    return model.eval(), train_args, body_model, num_person, num_frames


def generator_draws(device) -> ZDraws:
    """N(0, I) latents from a torch.Generator seeded by the evaluation seed,
    drawn in loader order across the seed's passes."""
    state = {}

    def draws(seed: int, pass_index: int):
        if pass_index == 0:
            state["gen"] = torch.Generator(device=device).manual_seed(int(seed))
        gen = state["gen"]

        def draw(shape):
            return torch.randn(shape, generator=gen, device=device)
        return draw

    return draws


@torch.no_grad()
def build_cvae_gen_batches(model: ActorCVAE, loader, num_frames: int,
                           draw: Callable, device):
    """One generated batch per loader batch: a latent per item from
    draw((B, latent_dim)), decoded at num_frames for the batch's classes
    (the autotrans decoder frame by frame)."""
    batches = []
    for motions, model_kwargs in loader:
        y = model_kwargs["y"]
        action = torch.as_tensor(np.asarray(y["action"])[:, 0], device=device)
        z = torch.as_tensor(draw((action.shape[0], model.latent_dim)), dtype=torch.float32,
                            device=device)
        if model.dec_arch == "autotrans":
            out = model.generate_autoregressive(z, action, num_frames)
        else:
            out = model.decode(z, action, num_frames)
        batches.append({
            "output": out.cpu().numpy(),
            "x": np.asarray(motions),
            "mask": np.asarray(y["mask"])[:, 0, 0, :].astype(bool),
            "lengths": np.asarray(y["lengths"]),
            "y": np.asarray(y["action"])[:, 0],
        })
    return batches


def _per_seed_strings(by_seed, num_seeds):
    return {key: ["{:.6}".format(by_seed[s][key]) for s in range(num_seeds)]
            for key in by_seed[0]}


def _evaluate_gru(args, model, train_args, num_frames, spec, num_seeds, device,
                  draw_z: ZDraws, data=None):
    """The humanact12 route: per seed, generated / ground-truth / second
    ground-truth batches decoded to the 24 SMPL joints and scored by the
    GRU classifier, the diversity draws on the seed's numpy stream."""
    from regennet_torch.eval.gru_eval import A2MEvaluator, smpl_rot2xyz

    if data is None:
        data = get_dataset(name=args.dataset, num_frames=num_frames, num_person=1,
                           data_path=args.data_path, split="test", setting="mdm",
                           pose_rep=train_args.get("pose_rep", "rot6d"), body_model="smpl")
    rot2xyz = smpl_rot2xyz(device)
    state = _classifier_state(args.rec_model_path, gru_classifier.MotionDiscriminator(
        output_size=spec["num_classes"]), gru_classifier.random_init_, args.seed)
    a2m = A2MEvaluator(spec["num_classes"], state, device=device)

    batch_size = max(1, min(args.batch_size, len(data)))
    metrics_by_seed = {}
    # gt2, the second copy, is the gt-vs-gt baseline
    ds1, ds2 = data, copy.deepcopy(data)
    for index, seed in enumerate(range(num_seeds)):
        print(f"Evaluation number: {index + 1}/{num_seeds}", flush=True)
        fixseed(seed)
        # shuffle GT1, shuffle GT2, then gen over GT1, gt over a second
        # pass of GT1, gt2 over GT2 (no drop_last)
        for ds in (ds1, ds2):
            ds.reset_shuffle()
            ds.shuffle()
        loader1 = BatchLoader(ds1, batch_size, collate, shuffle=False, drop_last=False)
        loader2 = BatchLoader(ds2, batch_size, collate, shuffle=False, drop_last=False)
        gen = build_cvae_gen_batches(model, loader1, num_frames, draw_z(seed, 0), device)
        gt = build_gt_batches(loader1, -1)
        gt2 = build_gt_batches(loader2, -1)

        def feats_of(batches):
            fs, ls, lg = [], [], []
            for b in batches:
                with torch.no_grad():
                    xyz = rot2xyz(torch.as_tensor(b["output"], device=device)).cpu().numpy()
                out = a2m(xyz[:, :24], b["lengths"])
                fs.append(out["features"])
                lg.append(out["yhat"])
                ls.append(b["y"])
            return np.concatenate(fs), np.concatenate(ls), np.concatenate(lg)

        metrics, computed = {}, {}
        for key, batches in [("gen", gen), ("gt", gt), ("gt2", gt2)]:
            f, l, g = feats_of(batches)
            metrics[f"accuracy_{key}"], _ = M.calculate_accuracy(g, l, spec["num_classes"])
            div, mult = M.calculate_diversity_multimodality(f, l, spec["num_classes"],
                                                            actor_quirks="a2m")
            metrics[f"diversity_{key}"] = div
            metrics[f"multimodality_{key}"] = mult
            computed[key] = M.calculate_activation_statistics(f)
        for key in ("gen", "gt", "gt2"):
            metrics[f"fid_{key}"] = float(M.calculate_fid(computed["gt"], computed[key]))
        metrics_by_seed[seed] = metrics
    return {"feats": _per_seed_strings(metrics_by_seed, num_seeds)}


def _log_file(args) -> str:
    run_dir = os.path.dirname(args.model_path.rstrip("/"))
    niter = checkpoint.parse_step_from_path(args.model_path)
    return os.path.join(run_dir, f"evaluation_results_{os.path.basename(run_dir)}_"
                                 f"{args.eval_mode}_{niter}.yaml")


def main(args=None, device=None, data=None, draw_z: Optional[ZDraws] = None):
    """Evaluate and return the metrics dict written to the YAML. device:
    "cpu", "cuda:N" or a torch.device; None means cuda:{args.device} (or
    the CPU for --device cpu) and raises without CUDA. data: a dataset
    (e.g. Feeder(clips=...)) in place of the test split at args.data_path.
    draw_z: the latents' source (generator_draws by default)."""
    if args is None:
        args = parse_args()
    device = resolve_device(device, getattr(args, "device", 0))
    pin_f32_contract()
    fixseed(args.seed)
    if args.dataset not in DATASET_EVAL:
        raise NotImplementedError(
            f"dataset {args.dataset} is not supported by the CVAE evaluator "
            f"(supported: {sorted(DATASET_EVAL)})")
    spec = DATASET_EVAL[args.dataset]
    model, train_args, body_model, num_person, num_frames = _load_model(args)
    model = model.to(device)
    num_seeds = args.num_seeds or (1 if args.eval_mode == "debug" else 20)
    draw_z = draw_z or generator_draws(device)

    if spec["harness"] == "gru":
        metrics = _evaluate_gru(args, model, train_args, num_frames, spec, num_seeds, device,
                                draw_z, data)
        log_file = _log_file(args)
        save_metrics(log_file, metrics)
        print(f"wrote {log_file}", flush=True)
        return metrics

    if data is None:
        data = get_dataset(name=args.dataset, num_frames=num_frames, num_person=num_person,
                           data_path=args.data_path, split="test", setting="mdm",
                           pose_rep=train_args.get("pose_rep", "rot6d"),
                           body_model=body_model)
    nfeats = 6 * num_person
    state = _classifier_state(args.rec_model_path, stgcn.STGCN(
        in_channels=nfeats, num_class=spec["num_classes"], num_person=num_person,
        layout=body_model), stgcn.random_init_, args.seed)
    evaluator = STGCNEvaluator(args.dataset, body_model, spec["num_classes"], nfeats,
                               num_person, state, device=device)

    data_types = ["train", "test"]
    datasetGT = {k: copy.deepcopy(data) for k in data_types}
    for k in data_types:
        datasetGT[k].split = k
    batch_size = max(1, min(args.batch_size, min(len(datasetGT[k]) for k in data_types)))

    metrics_by_seed, other_by_seed = {}, {}
    for index, seed in enumerate(range(num_seeds)):
        print(f"Evaluation number: {index + 1}/{num_seeds}", flush=True)
        fixseed(seed)
        # shuffle both splits first, then gt over train and test, then gen
        # over a second pass of the same loaders (fresh windows; no
        # drop_last)
        loaders_by_key = {}
        for key in data_types:
            ds = datasetGT[key]
            ds.reset_shuffle()
            ds.shuffle()
            loaders_by_key[key] = BatchLoader(ds, batch_size, collate, shuffle=False,
                                              drop_last=False)
        loaders = {"gen": {}, "gt": {}}
        for key in data_types:
            loaders["gt"][key] = build_gt_batches(loaders_by_key[key], -1)
        for i, key in enumerate(data_types):
            loaders["gen"][key] = build_cvae_gen_batches(
                model, loaders_by_key[key], num_frames, draw_z(seed, i), device)
        metrics_by_seed[seed] = evaluate_seed_metrics(evaluator, loaders, acc_only=False,
                                                      seed=None, actor_quirks=True)
        if args.other_metrics:
            other_by_seed[seed] = othermetrics.evaluate_othermetrics(
                loaders["gen"]["test"], num_classes=spec["num_classes"])

    metrics = {"feats": _per_seed_strings(metrics_by_seed, num_seeds)}
    if args.other_metrics:
        metrics["other"] = _per_seed_strings(other_by_seed, num_seeds)
    log_file = _log_file(args)
    save_metrics(log_file, metrics)
    print(f"wrote {log_file}", flush=True)
    return metrics


if __name__ == "__main__":
    main()
