"""Training CLI: `python -m regennet_torch.train.train_mdm` (counterpart of
regennet_tpu/train/train_mdm.py), one GPU.

parse args -> device -> fix seeds -> platform -> args.json -> data ->
model and diffusion -> TrainLoop.run_loop(). Checkpoints land in
--save_dir as model{step:09d}.pt (what cgenerate loads) and
opt{step:09d}.pt (what a resumed run loads).
"""

from __future__ import annotations

import os

import torch

from regennet_torch.data.get_data import get_dataset_loader
from regennet_torch.device import resolve_device
from regennet_torch.train.train_platforms import get_platform
from regennet_torch.train.training_loop import TrainLoop
from regennet_torch.utils import kvlogger as logger
from regennet_torch.utils import parser_util
from regennet_torch.utils.fixseed import fixseed
from regennet_torch.utils.model_util import _pick_activation, create_model_and_diffusion


def main(args=None, device=None, data=None) -> TrainLoop:
    """Train and return the finished TrainLoop.

    device: "cpu", "cuda:N" or a torch.device; None means cuda:{args.device}
    and raises without CUDA, before anything is written. data: a
    BatchLoader (e.g. over Feeder(clips=...)) instead of loading
    args.data_path."""
    if args is None:
        args = parser_util.train_args()
    device = resolve_device(device, getattr(args, "device", 0))
    parser_util.check_single_device_training(args)
    # recorded in args.json, so the sampler builds the activation trained
    # here even though it loads a .pt file (see model_util._pick_activation)
    args.activation = _pick_activation(args)
    # f32 means f32 on the GPU: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fixseed(args.seed)

    train_platform = get_platform(args.train_platform_type)(args.save_dir)
    train_platform.report_args(args, name="Args")
    if args.save_dir is None:
        raise FileNotFoundError("save_dir was not specified.")
    if os.path.exists(args.save_dir) and not args.overwrite and \
            os.path.exists(os.path.join(args.save_dir, "args.json")):
        raise FileExistsError(
            f"save_dir [{args.save_dir}] already exists (use --overwrite)."
        )
    os.makedirs(args.save_dir, exist_ok=True)
    parser_util.save_args(args, args.save_dir)
    logger.configure(args.save_dir)

    if data is None:
        logger.log("creating data loader...")
        data = get_dataset_loader(
            name=args.dataset,
            batch_size=args.batch_size,
            num_frames=args.num_frames,
            num_person=args.num_person,
            data_path=args.data_path,
            setting=args.setting,
            pose_rep=args.pose_rep,
            body_model=args.body_model,
            shuffle=args.shuffle,
        )

    logger.log("creating model and diffusion...")
    model, sched, cfg = create_model_and_diffusion(args, data, device=device)

    logger.log("Training...")
    loop = TrainLoop(args, train_platform, model, sched, cfg, data, device)
    loop.run_loop()
    train_platform.close()
    return loop


if __name__ == "__main__":
    main()
