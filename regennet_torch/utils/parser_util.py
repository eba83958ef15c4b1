"""CLI arguments of the trainer, the sampler and the evaluations, with the
args.json round-trip (the port's copy of the `train_args`,
`cgenerate_args` and `evaluation_parser` parts of
regennet_tpu/utils/parser_util.py).

Training writes its arguments to args.json beside the checkpoints; the
sampler reloads the model and diffusion groups from there, overwriting
the command line's values, and the activation the trainer recorded.
"""

from __future__ import annotations

import json
import os
from argparse import ArgumentParser


def parse_and_load_from_model(parser, with_data: bool = True, argv=None):
    if with_data:
        add_data_options(parser)
    add_model_options(parser)
    add_diffusion_options(parser)
    args = parser.parse_args(argv)
    groups = (["dataset"] if with_data else []) + ["model", "diffusion"]
    args_to_overwrite = []
    for group_name in groups:
        args_to_overwrite += get_args_per_group_name(parser, group_name)

    args_path = os.path.join(os.path.dirname(args.model_path), "args.json")
    if not os.path.exists(args_path):
        raise FileNotFoundError(f"Arguments json file was not found: {args_path}")
    with open(args_path, "r") as fr:
        model_args = json.load(fr)

    for a in args_to_overwrite:
        if a in model_args:
            setattr(args, a, model_args[a])
        elif "cond_mode" in model_args:  # backward compatibility
            setattr(args, "unconstrained", model_args["cond_mode"] == "no_cond")
        else:
            print(
                f"Warning: was not able to load [{a}], "
                f"using default value [{args.__dict__[a]}] instead."
            )
    # a run of the port's trainer records the activation it trained with
    if model_args.get("activation"):
        args.activation = model_args["activation"]
    # the mlp trunk's time mixing is built for the frames it trained on
    if args.arch == "mlp" and model_args.get("num_frames"):
        args.num_frames = model_args["num_frames"]
    if args.cond_mask_prob == 0:
        args.guidance_param = 1
    return args


def parse_and_load_from_model_wo_data(parser, argv=None):
    return parse_and_load_from_model(parser, with_data=False, argv=argv)


def get_args_per_group_name(parser, group_name):
    for group in parser._action_groups:
        if group.title == group_name:
            return [a.dest for a in group._group_actions]
    raise ValueError(f"argument group {group_name!r} was not found")


def add_base_options(parser):
    group = parser.add_argument_group("base")
    group.add_argument("--cuda", default=True, type=bool,
                       help="Kept for CLI compatibility; see --device.")
    group.add_argument("--device", default=0, type=int,
                       help="CUDA device id (the sampler runs on cuda:<id>).")
    group.add_argument("--seed", default=10, type=int, help="Random seed.")
    group.add_argument("--batch_size", default=64, type=int,
                       help="Batch size during training.")
    group.add_argument("--use_ddim", action="store_true",
                       help="Use DDIM to accelerate the inference or not.")
    group.add_argument("--timestep_respacing", default="", type=str,
                       help="ddim timestep respacing.")


def add_diffusion_options(parser):
    group = parser.add_argument_group("diffusion")
    group.add_argument("--noise_schedule", default="cosine",
                       choices=["linear", "cosine"], type=str)
    group.add_argument("--diffusion_steps", default=1000, type=int)
    group.add_argument("--sigma_small", default=True, type=bool)


def add_model_options(parser):
    group = parser.add_argument_group("model")
    group.add_argument("--setting", default="mdm", choices=["mdm", "cmdm"], type=str)
    group.add_argument("--arch", default="trans_enc",
                       choices=["trans_enc", "trans_dec", "gru", "mlp", "online",
                                "offline"], type=str)
    group.add_argument("--emb_trans_dec", default=False, type=bool)
    group.add_argument("--wo_pos_emb", action="store_true")
    group.add_argument("--cm_mode", default="concat",
                       choices=["add", "concat", "concat2"], type=str)
    group.add_argument("--layers", default=8, type=int)
    group.add_argument("--latent_dim", default=512, type=int)
    group.add_argument("--cond_mask_prob", default=0.1, type=float)
    group.add_argument("--lambda_rcxyz", default=0.0, type=float)
    group.add_argument("--lambda_vel", default=0.0, type=float)
    group.add_argument("--lambda_fc", default=0.0, type=float)
    group.add_argument("--lambda_orient", default=1.0, type=float)
    group.add_argument("--lambda_body", default=1.0, type=float)
    group.add_argument("--lambda_transl", default=1.0, type=float)
    group.add_argument("--unconstrained", action="store_true")


def add_data_options(parser):
    group = parser.add_argument_group("dataset")
    group.add_argument("--dataset", default="humanml",
                       choices=["humanml", "kit", "humanact12", "uestc", "ntu",
                                "chi3d", "gta", "sbu"], type=str)
    group.add_argument("--data_dir", default="", type=str)
    group.add_argument("--num_person", default=1, type=int)
    group.add_argument("--data_path", default="", type=str)
    group.add_argument("--pose_rep", default="rot6d", type=str)
    group.add_argument("--body_model", default="smpl",
                       choices=["smpl", "smplx"], type=str)
    group.add_argument("--vel_threshold", default=0.01, type=float)
    group.add_argument("--shuffle", action="store_true",
                       help="Shuffle actor-reactor order during training.")


def add_sampling_options(parser):
    group = parser.add_argument_group("sampling")
    group.add_argument("--model_path", required=True, type=str,
                       help="Reference-layout torch state dict (.pt) with "
                            "args.json beside it.")
    group.add_argument("--output_dir", default="", type=str)
    group.add_argument("--num_samples", default=10, type=int)
    group.add_argument("--num_repetitions", default=3, type=int)
    group.add_argument("--guidance_param", default=2.5, type=float)
    group.add_argument("--compute_dtype", default="float32",
                       choices=["float32", "bfloat16"], type=str,
                       help="Dtype the denoiser computes in.")


def add_generate_options(parser):
    group = parser.add_argument_group("generate")
    group.add_argument("--motion_length", default=60, type=float)
    group.add_argument("--input_text", default="", type=str)
    group.add_argument("--action_file", default="", type=str)
    group.add_argument("--text_prompt", default="", type=str)
    group.add_argument("--action_name", default="", type=str)


def save_args(args, save_dir: str):
    """Write args to {save_dir}/args.json (the training side of the contract)."""
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, "args.json"), "w") as fw:
        json.dump(vars(args), fw, indent=4, sort_keys=True)


def add_training_options(parser):
    group = parser.add_argument_group("training")
    group.add_argument("--save_dir", required=True, type=str)
    group.add_argument("--overwrite", action="store_true")
    group.add_argument("--train_platform_type", default="NoPlatform",
                       choices=["NoPlatform", "ClearmlPlatform",
                                "TensorboardPlatform"], type=str,
                       help="TensorboardPlatform writes event files into "
                            "--save_dir; ClearmlPlatform is not ported.")
    group.add_argument("--lr", default=1e-4, type=float)
    group.add_argument("--weight_decay", default=0.0, type=float)
    group.add_argument("--lr_anneal_steps", default=0, type=int)
    group.add_argument("--ema_rate", default=0.9999, type=float,
                       help="EMA decay of the averaged parameters.")
    group.add_argument("--eval_batch_size", default=32, type=int)
    group.add_argument("--eval_split", default="test", choices=["val", "test"])
    group.add_argument("--eval_during_training", action="store_true",
                       help="Evaluate after every save, against "
                            "--rec_model_path: eval_cmdm's debug protocol, or "
                            "for humanact12/uestc eval_humanact12_uestc's.")
    group.add_argument("--rec_model_path", default="", type=str)
    group.add_argument("--nan_guard", action="store_true",
                       help="Drop non-finite training steps (loss or grad "
                            "norm) and roll back to the state before them; "
                            "the host waits for every step and keeps a copy "
                            "of the training state.")
    group.add_argument("--eval_rep_times", default=3, type=int)
    group.add_argument("--eval_num_samples", default=1_000, type=int)
    group.add_argument("--log_interval", default=1_000, type=int)
    group.add_argument("--save_interval", default=10_000, type=int)
    group.add_argument("--num_steps", default=600_000, type=int)
    group.add_argument("--num_frames", default=60, type=int)
    group.add_argument("--profile_steps", default=0, type=int,
                       help="Trace this many steps from --profile_start with "
                            "torch.profiler into <save_dir>/profile (a Chrome "
                            "trace); 0 traces nothing.")
    group.add_argument("--profile_start", default=10, type=int)
    group.add_argument("--resume_checkpoint", default="", type=str)
    group.add_argument("--data_parallel", default=-1, type=int,
                       help="Single device only: -1 or 1.")
    group.add_argument("--tensor_parallel", default=1, type=int,
                       help="Single device only: 1.")
    group.add_argument("--param_sharding", default="replicated",
                       choices=["replicated", "fsdp"], type=str,
                       help="Single device only: replicated.")
    group.add_argument("--compute_dtype", default="float32",
                       choices=["float32", "bfloat16"], type=str,
                       help="Dtype the denoiser computes in; parameters, "
                            "gradients, AdamW moments and the EMA stay "
                            "float32.")
    group.add_argument("--steps_per_call", default=8, type=int,
                       help="Steps per loop iteration: K single optimizer "
                            "steps run back to back; saves and evaluation "
                            "fall at the first K-step boundary at or after "
                            "their step, and --nan_guard rolls back whole "
                            "K-step blocks.")


def train_args(argv=None):
    parser = ArgumentParser()
    add_base_options(parser)
    add_data_options(parser)
    add_model_options(parser)
    add_diffusion_options(parser)
    add_training_options(parser)
    return parser.parse_args(argv)


def check_single_device_training(args):
    """Raise for the options this port does not train with: more than one
    device or a sharded state."""
    if getattr(args, "data_parallel", -1) not in (-1, 1):
        raise NotImplementedError("distributed training is not ported: "
                                  "--data_parallel must be -1 or 1")
    if getattr(args, "tensor_parallel", 1) != 1:
        raise NotImplementedError("tensor parallelism is not ported: "
                                  "--tensor_parallel must be 1")
    if getattr(args, "param_sharding", "replicated") != "replicated":
        raise NotImplementedError("--param_sharding fsdp is not ported")


def add_evaluation_options(parser):
    group = parser.add_argument_group("eval")
    group.add_argument("--model_path", required=True, type=str,
                       help="The CMDM's .pt file, with args.json beside it.")
    group.add_argument("--rec_model_path", required=True, type=str,
                       help="The recognition classifier (the ST-GCN; the GRU "
                            "classifier for humanact12): the port's .pt or a "
                            "released file; 'random' builds it from --seed.")
    group.add_argument("--eval_mode", default="debug", choices=["debug", "full"],
                       type=str, help="eval_cmdm: debug 100 samples, 1 seed, "
                                      "accuracy only; full 1000 samples, 20 "
                                      "seeds. eval_humanact12_uestc: debug 10 "
                                      "samples, 2 seeds.")
    group.add_argument("--guidance_param", default=2.5, type=float)
    group.add_argument("--auto_regressive", action="store_true",
                       help="Re-sample once per revealed actor frame.")
    group.add_argument("--unconstrained_rec_path", default="", type=str,
                       help="The openpose ST-GCN of the unconstrained HumanAct12 "
                            "protocol (a released .pth.tar or the port's .pt); "
                            "with --unconstrained_data_path an --unconstrained "
                            "model is scored by it.")
    group.add_argument("--unconstrained_data_path", default="", type=str,
                       help="The dataset motions of the unconstrained protocol "
                            "(humanact12_modi_struct.npy, [N, >=15, 3, T]).")
    group.add_argument("--eval_seed_batch", default=0, type=int,
                       help="Stack this many evaluation seeds into one "
                            "sampling batch (0: 128 // batch size; 1: none).")


def evaluation_parser(argv=None):
    parser = ArgumentParser()
    add_base_options(parser)
    add_evaluation_options(parser)
    return parse_and_load_from_model(parser, argv=argv)


def cgenerate_args(argv=None):
    parser = ArgumentParser()
    add_base_options(parser)
    add_data_options(parser)
    add_sampling_options(parser)
    add_generate_options(parser)
    return parse_and_load_from_model_wo_data(parser, argv)
