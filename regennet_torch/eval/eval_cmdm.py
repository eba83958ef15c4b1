"""Evaluation CLI: `python -m regennet_torch.eval.eval_cmdm` (counterpart of
regennet_tpu/eval/eval_cmdm.py).

Modes `debug` (100 samples, 1 seed, accuracy only) and `full` (1000
samples, 20 seeds, every metric), at the protocol's batch of 32, with
classifier-free guidance when --guidance_param is not 1. The CMDM is the
--model_path file with its args.json; the ST-GCN classifier is
--rec_model_path (the port's .pt or a released .pth.tar), or built from
--seed with 'random'. The results go to
`evaluation_results_<name>_<mode>_<niter>.yaml` beside the checkpoint, in
the text yaml.dump writes (eval/tools.py), for eval/easy_table.py.
Under `torchrun --nproc_per_node N` the ranks share each sampling batch
(stgcn_eval) and rank 0 writes the results.
"""

from __future__ import annotations

import os

import torch

from regennet_torch.data.get_data import get_dataset
from regennet_torch.device import resolve_device
from regennet_torch.eval import stgcn_eval
from regennet_torch.eval.tools import save_metrics
from regennet_torch.models.cmdm import make_cfg_model_fn, make_model_fn
from regennet_torch.models.stgcn import STGCN, random_init_
from regennet_torch.parallel import mesh
from regennet_torch.train import checkpoint
from regennet_torch.utils import parser_util
from regennet_torch.utils.fixseed import fixseed
from regennet_torch.utils.model_util import create_model_and_diffusion, model_dtype

NUM_CLASSES = {"ntu": 26, "chi3d": 8}
NFEATS = 6 * 2  # rot6d, both persons


def load_stgcn_evaluator(args, rec_model_path: str, device="cpu"):
    """The frozen recognition classifier from a file, or from a
    torch.Generator seeded with args.seed when the path is '' or 'random'."""
    num_classes = NUM_CLASSES[args.dataset]
    if rec_model_path and rec_model_path != "random":
        state = rec_model_path
    else:
        model = STGCN(in_channels=NFEATS, num_class=num_classes, num_person=2,
                      layout=args.body_model)
        state = random_init_(model, torch.Generator().manual_seed(int(args.seed))).state_dict()
    return stgcn_eval.STGCNEvaluator(args.dataset, args.body_model, num_classes, NFEATS, 2,
                                     state, device=device)


def results_path(args) -> str:
    """evaluation_results_<name>_<mode>_<niter>.yaml beside the checkpoint."""
    name = os.path.basename(os.path.dirname(args.model_path))
    niter = os.path.basename(args.model_path).replace("model", "").replace(".pt", "")
    return os.path.join(os.path.dirname(args.model_path),
                        f"evaluation_results_{name}_{args.eval_mode}_{niter}.yaml")


def main(args=None, device=None, data=None):
    """Evaluate, write the results file and return the metrics
    {"feats": {name: [one string per seed]}}.

    device: "cpu", "cuda:N" or a torch.device; None means cuda:{args.device}
    and raises without CUDA. data: a dataset (e.g. Feeder(clips=...)) in
    place of loading args.data_path."""
    if args is None:
        args = parser_util.evaluation_parser()
    device = mesh.local_device(resolve_device(device, getattr(args, "device", 0)))
    mesh.init_distributed(device)  # under a launcher: the ranks share each batch
    # f32 means f32 on the GPU: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fixseed(args.seed)

    args.batch_size = 32  # the protocol's batch
    log_file = results_path(args)
    print(f"Eval mode [{args.eval_mode}]")
    if args.eval_mode == "debug":
        args.num_samples, args.num_seeds = 100, 1
    elif args.eval_mode == "full":
        args.num_samples, args.num_seeds = 1000, 20
    else:
        raise ValueError(f"unknown eval mode {args.eval_mode}")
    if not getattr(args, "num_frames", None) or args.num_frames <= 0:
        args.num_frames = {"ntu": 60, "chi3d": 150}.get(args.dataset, 60)

    if data is None:
        data = get_dataset(
            name=args.dataset, num_frames=args.num_frames, num_person=args.num_person,
            data_path=args.data_path, split="test", setting=args.setting,
            pose_rep=args.pose_rep, body_model=args.body_model,
        )
    args.num_actions = data.num_actions

    model, sched, cfg = create_model_and_diffusion(args, data, device=device)
    if args.model_path and args.model_path != "random":
        checkpoint.load_model(model, args.model_path)
    model = model.to(device=device, dtype=model_dtype(args)).eval()
    guidance = float(getattr(args, "guidance_param", 1.0))

    def model_fn_builder():
        if guidance != 1.0:
            return make_cfg_model_fn(model, guidance)
        return make_model_fn(model)

    evaluator = load_stgcn_evaluator(args, args.rec_model_path, device)
    eval_dict = stgcn_eval.evaluate(
        args, model_fn_builder, sched, cfg, data, evaluator, setting=args.setting,
        acc_only=args.eval_mode == "debug",
        auto_regressive=getattr(args, "auto_regressive", False),
    )
    if mesh.global_rank() == 0:
        print(eval_dict)
        save_metrics(log_file, eval_dict)
        print(f"saved evaluation results to [{log_file}]")
    return eval_dict


if __name__ == "__main__":
    main()
