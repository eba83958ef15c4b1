"""Single-person a2m evaluation with the GRU classifier, HumanAct12
(counterpart of regennet_tpu/eval/gru_eval.py).

Per seed: shuffle two copies of the dataset, then build the generated
batches (full diffusion sampling from the first copy's conditions), the
ground-truth batches (a second pass over the first copy, fresh windows)
and a second ground truth (the second copy, the gt-vs-gt baseline);
decode each to SMPL joints, read the GRU classifier's features, and
compute accuracy, FID, diversity and multimodality. The host streams
(`random` for shuffles and windows, numpy's for the diversity draws) are
consumed in the JAX package's order. The sampling noise comes from a
torch.Generator on the sampler's device seeded with the evaluation seed.

With `unconstrained` (a model without action conditioning) accuracy and
multimodality are nan. The unconstrained protocol (sample 1000 motions,
score them with the openpose ST-GCN against the modi-struct dataset)
runs when --unconstrained_rec_path and --unconstrained_data_path name
existing files; otherwise FID, KID and precision / recall over the GRU
features stand in for it.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from regennet_torch.data.collate import collate
from regennet_torch.data.get_data import BatchLoader
from regennet_torch.diffusion import sampling
from regennet_torch.eval import metrics as M
from regennet_torch.eval import unconstrained as U
from regennet_torch.models.gru_classifier import MotionDiscriminator
from regennet_torch.models.stgcn import make_unconstrained_stgcn
from regennet_torch.ops import body_model as bm
from regennet_torch.ops.pose_decode import make_rot2xyz
from regennet_torch.train import checkpoint
from regennet_torch.utils.fixseed import fixseed

NUM_SAMPLES_UNCONSTRAINED = 1000


class A2MEvaluator:
    """The frozen GRU classifier on a device: (motion_xyz [B, J, 3, T],
    lengths [B]) numpy -> {"features", "yhat"} numpy."""

    def __init__(self, num_classes: int,
                 state: Union[str, os.PathLike, Mapping[str, Any]],
                 num_joints: int = 24, device="cpu"):
        self.num_classes = num_classes
        model = MotionDiscriminator(input_size=num_joints * 3, output_size=num_classes)
        checkpoint.load_classifier_state(model, state)
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()

    @torch.no_grad()
    def __call__(self, motion_xyz, lengths) -> Dict[str, np.ndarray]:
        out = self.model(
            torch.as_tensor(np.asarray(motion_xyz), dtype=torch.float32, device=self.device),
            torch.as_tensor(np.asarray(lengths), device=self.device))
        return {"features": out["features"].cpu().numpy(), "yhat": out["yhat"].cpu().numpy()}


def _build_batches(sample_fn, generator, loader, num_samples, mode, rot2xyz, device):
    """The loader's batches, sampled (mode "gen": sample_fn(generator,
    cond, shape) on `device`, the actor input zero) or as they are ("gt"),
    each with its SMPL joints; the batch crossing num_samples is kept and
    trimmed, the loader consumed to its end."""
    batches = []
    for motions, model_kwargs in loader:
        if num_samples != -1 and len(batches) * loader.batch_size > num_samples:
            continue
        y = model_kwargs["y"]
        if mode == "gen":
            cond = {"mask": torch.as_tensor(y["mask"], device=device),
                    "cmotion": torch.zeros(motions.shape, device=device)}
            if "action" in y:
                cond["action"] = torch.as_tensor(y["action"], device=device)
            output = sample_fn(generator, cond, motions.shape).float()
        else:
            output = torch.as_tensor(motions, device=device)
        mask = torch.as_tensor(np.asarray(y["mask"])[:, 0, 0], device=device)
        batches.append({
            "output": output.cpu().numpy(),
            "output_xyz": rot2xyz(output, mask).cpu().numpy(),
            "lengths": np.asarray(y["lengths"]),
            "y": np.asarray(y["action"])[:, 0],
        })
    if batches and num_samples > 0:
        rem = num_samples % loader.batch_size
        if rem:
            for k, v in batches[-1].items():
                batches[-1][k] = v[:rem]
    return batches


def _features(evaluator, batches):
    feats, labels, logits = [], [], []
    for b in batches:
        out = evaluator(b["output_xyz"], b["lengths"])
        feats.append(out["features"])
        logits.append(out["yhat"])
        labels.append(b["y"])
    return np.concatenate(feats), np.concatenate(labels), np.concatenate(logits)


def smpl_rot2xyz(device):
    """The decode of the protocol: rot6d with a translation row -> the 24
    SMPL joints, the translation re-based to the first frame."""
    return make_rot2xyz(bm.get_body_model("smpl").to(device), pose_rep="rot6d",
                        jointstype="smpl", translation=True, glob=True, vertstrans=True)


def evaluate(args, model_fn_builder, sched, cfg, data, evaluator: A2MEvaluator,
             unconstrained: bool = False) -> Dict:
    """The multi-seed loop (args: batch_size, num_samples, num_seeds, and
    for the unconstrained protocol seed, unconstrained_rec_path and
    unconstrained_data_path). `model_fn_builder()` returns the diffusion
    ModelFn; sampling runs on the schedule's device. Returns {"feats":
    {name: [one string per seed]}}."""
    bs = args.batch_size
    device = sched.device
    rot2xyz = smpl_rot2xyz(device)
    model_fn = model_fn_builder()

    def sample_fn(generator, cond, shape):
        return sampling.p_sample_loop(sched, cfg, model_fn, shape, cond,
                                      clip_denoised=False, generator=generator)

    metrics_by_seed = {}
    ds1 = copy.deepcopy(data)
    ds2 = copy.deepcopy(data)
    for index, seed in enumerate(range(args.num_seeds)):
        print(f"Evaluation number: {index + 1}/{args.num_seeds}")
        fixseed(seed)
        generator = torch.Generator(device=device).manual_seed(seed)
        # the `random` stream: shuffle GT1, shuffle GT2, then gen over GT1,
        # gt over a second pass of GT1, gt2 over GT2; no batch is dropped
        ds1.reset_shuffle()
        ds1.shuffle()
        ds2.reset_shuffle()
        ds2.shuffle()
        eff_bs = min(bs, len(ds1))
        if eff_bs == 0:
            raise ValueError("evaluation dataset is empty")
        loader1 = BatchLoader(ds1, eff_bs, collate, shuffle=False, drop_last=False)
        loader2 = BatchLoader(ds2, eff_bs, collate, shuffle=False, drop_last=False)
        gen = _build_batches(sample_fn, generator, loader1, args.num_samples, "gen",
                             rot2xyz, device)
        gt = _build_batches(None, None, loader1, args.num_samples, "gt", rot2xyz, device)
        gt2 = _build_batches(None, None, loader2, args.num_samples, "gt", rot2xyz, device)

        # per loader (gen, gt, gt2): accuracy, features, diversity (its
        # draws on the numpy stream fixseed seeded); then every loader's
        # FID against the gt statistics
        metrics: Dict[str, float] = {}
        computed = {}
        for key, batches in [("gen", gen), ("gt", gt), ("gt2", gt2)]:
            feats, labels, logits = _features(evaluator, batches)
            if unconstrained:
                metrics[f"accuracy_{key}"] = float("nan")
            else:
                metrics[f"accuracy_{key}"], _ = M.calculate_accuracy(
                    logits, labels, evaluator.num_classes)
            computed[key] = feats
            div, mult = M.calculate_diversity_multimodality(
                feats, labels, evaluator.num_classes, unconstrained=unconstrained)
            metrics[f"diversity_{key}"] = div
            metrics[f"multimodality_{key}"] = mult
        gt_stats = M.calculate_activation_statistics(computed["gt"])
        for key, feats in computed.items():
            metrics[f"fid_{key}"] = float(M.calculate_fid(
                gt_stats, M.calculate_activation_statistics(feats)))
        if unconstrained and not _unconstrained_assets_available(args):
            metrics.update(U.evaluate_unconstrained_metrics(
                computed["gt"], computed["gen"], seed=seed))
        metrics_by_seed[seed] = metrics

    result = {"feats": {
        key: ["{:.6}".format(metrics_by_seed[s][key]) for s in range(args.num_seeds)]
        for key in metrics_by_seed[0]
    }}
    if unconstrained:
        uncon = _reference_unconstrained_metrics(args, sample_fn, data, rot2xyz, device)
        if uncon is not None:
            # scalars computed once, merged into the per-seed dict
            result["feats"].update({k: "{:.6}".format(v) for k, v in uncon.items()})
    return result


def _unconstrained_assets_available(args) -> bool:
    rec_path = getattr(args, "unconstrained_rec_path", None)
    data_path = getattr(args, "unconstrained_data_path", None)
    return bool(rec_path and data_path and os.path.exists(rec_path)
                and os.path.exists(data_path))


def _reference_unconstrained_metrics(args, sample_fn, data, rot2xyz, device):
    """The unconstrained protocol, once: sample NUM_SAMPLES_UNCONSTRAINED
    motions (batches of args.batch_size, the last partial one dropped),
    select the 15 openpose joints and score them with the openpose
    ST-GCN (args.unconstrained_rec_path: a released .pth.tar or the
    port's .pt) against the modi-struct array
    (args.unconstrained_data_path, .npy). None when either file is
    missing."""
    if not _unconstrained_assets_available(args):
        return None
    model = make_unconstrained_stgcn()
    checkpoint.load_classifier_state(model, args.unconstrained_rec_path)
    model = model.to(device)

    ds = copy.deepcopy(data)
    ds.reset_shuffle()
    ds.shuffle()
    loader = BatchLoader(ds, min(args.batch_size, len(ds)), collate, shuffle=False,
                         drop_last=True)
    generator = torch.Generator(device=device).manual_seed(
        int(getattr(args, "seed", 0)) + 10_000)
    gen = _build_batches(sample_fn, generator, loader, NUM_SAMPLES_UNCONSTRAINED, "gen",
                         rot2xyz, device)
    gen_xyz = np.concatenate([b["output_xyz"][:, U.SMPL_TO_OPENPOSE15] for b in gen])
    dataset_motions = np.load(args.unconstrained_data_path, allow_pickle=True)
    return U.evaluate_unconstrained_reference_protocol(model, gen_xyz, dataset_motions,
                                                       fast=True, seed=0)
