"""Single-person evaluation CLI: `python -m regennet_torch.eval.eval_humanact12_uestc`
(counterpart of regennet_tpu/eval/eval_humanact12_uestc.py).

HumanAct12 is scored by the GRU classifier (eval/gru_eval.py; with an
--unconstrained model, the unconstrained protocol), UESTC by the
single-person ST-GCN in the eval_cmdm protocol (eval/stgcn_eval.py,
setting mdm). Modes `debug` (10 samples, 2 seeds) and `full` (1000
samples, 20 seeds), at --batch_size. The CMDM is the --model_path file
with its args.json; the classifier is --rec_model_path (a released file
or the port's .pt), or drawn from --seed with 'random'. The results go to
`evaluation_results_iter{N}_samp{S}_scale{G}_a2m.yaml` beside the
checkpoint. `evaluate` is also the in-training evaluation of these two
datasets (train/training_loop.py).
"""

from __future__ import annotations

import os
import re

import torch

from regennet_torch.data.get_data import get_dataset
from regennet_torch.device import pin_f32_contract, resolve_device
from regennet_torch.eval.tools import save_metrics
from regennet_torch.models import gru_classifier, stgcn
from regennet_torch.models.cmdm import make_cfg_model_fn, make_model_fn
from regennet_torch.train import checkpoint
from regennet_torch.utils import parser_util
from regennet_torch.utils.fixseed import fixseed
from regennet_torch.utils.model_util import create_model_and_diffusion, model_dtype

EVAL_SIZES = {"debug": (10, 2), "full": (1000, 20)}  # (num_samples, num_seeds)


def _classifier_state(rec_model_path: str, model, random_init_, seed: int):
    """The file's path, or with '' or 'random' a random state from `seed`."""
    if rec_model_path and rec_model_path != "random":
        return rec_model_path
    return random_init_(model, torch.Generator().manual_seed(int(seed))).state_dict()


def load_gru_evaluator(args, rec_model_path: str, device="cpu"):
    """The 12-class GRU classifier of HumanAct12 (a released
    humanact12_gru.tar or the port's .pt, or 'random')."""
    from regennet_torch.eval import gru_eval

    state = _classifier_state(rec_model_path, gru_classifier.MotionDiscriminator(
        output_size=12), gru_classifier.random_init_, args.seed)
    return gru_eval.A2MEvaluator(12, state, device=device)


def load_uestc_evaluator(args, rec_model_path: str, device="cpu"):
    """The single-person ST-GCN of UESTC: 40 classes, rot6d, layout smpl."""
    from regennet_torch.eval.stgcn_eval import STGCNEvaluator

    state = _classifier_state(rec_model_path, stgcn.STGCN(
        in_channels=6, num_class=40, num_person=1, layout="smpl"), stgcn.random_init_,
        args.seed)
    return STGCNEvaluator("uestc", "smpl", num_classes=40, nfeats=6, num_person=1,
                          state_dict=state, device=device)


def evaluate(args, model_fn_builder, sched, cfg, data, rec_model_path):
    """The evaluation of args.dataset on the schedule's device."""
    device = sched.device
    if args.dataset == "humanact12":
        from regennet_torch.eval import gru_eval

        evaluator = load_gru_evaluator(args, rec_model_path, device)
        return gru_eval.evaluate(args, model_fn_builder, sched, cfg, data, evaluator,
                                 unconstrained=getattr(args, "unconstrained", False))
    if args.dataset == "uestc":
        from regennet_torch.eval import stgcn_eval

        args.body_model = "smpl"
        evaluator = load_uestc_evaluator(args, rec_model_path, device)
        return stgcn_eval.evaluate(args, model_fn_builder, sched, cfg, data, evaluator,
                                   setting="mdm", acc_only=args.eval_mode == "debug")
    raise NotImplementedError("This dataset is not supported.")


def results_path(args) -> str:
    """evaluation_results_iter{N}_samp{S}_scale{G}_a2m.yaml beside the checkpoint."""
    folder, ckpt_name = os.path.split(args.model_path)
    niter = (re.findall(r"\d+", ckpt_name) or ["0"])[0]
    scale = str(float(getattr(args, "guidance_param", 1.0))).replace(".", "p")
    return os.path.join(folder, f"evaluation_results_iter{niter}_samp{args.num_samples}"
                                f"_scale{scale}_a2m.yaml")


def main(args=None, device=None, data=None):
    """Evaluate, write the results file and return the metrics.

    device: "cpu", "cuda:N" or a torch.device; None means cuda:{args.device}
    and raises without CUDA. data: a dataset (HumanAct12Poses or UESTC) in
    place of loading args.data_path."""
    if args is None:
        args = parser_util.evaluation_parser()
    device = resolve_device(device, getattr(args, "device", 0))
    pin_f32_contract()
    fixseed(args.seed)

    print(f"Eval mode [{args.eval_mode}]")
    if args.eval_mode not in EVAL_SIZES:
        raise ValueError(f"unknown eval mode {args.eval_mode}")
    args.num_samples, args.num_seeds = EVAL_SIZES[args.eval_mode]
    if not getattr(args, "num_frames", None) or args.num_frames <= 0:
        args.num_frames = 60

    if data is None:
        data = get_dataset(
            name=args.dataset, num_frames=args.num_frames, num_person=1,
            data_path=args.data_path, split="train", setting="mdm",
            pose_rep=args.pose_rep, body_model="smpl",
        )
    args.num_actions = data.num_actions
    args.setting = "mdm"
    model, sched, cfg = create_model_and_diffusion(args, data, device=device)
    if args.model_path and args.model_path != "random":
        checkpoint.load_model(model, args.model_path)
    model = model.to(device=device, dtype=model_dtype(args)).eval()
    guidance = float(getattr(args, "guidance_param", 1.0))

    def model_fn_builder():
        if guidance != 1.0:
            return make_cfg_model_fn(model, guidance)
        return make_model_fn(model)

    eval_results = evaluate(args, model_fn_builder, sched, cfg, data, args.rec_model_path)
    evalpath = results_path(args)
    print(f"Saving evaluation: {evalpath}")
    save_metrics(evalpath, eval_results)
    return eval_results


if __name__ == "__main__":
    main()
