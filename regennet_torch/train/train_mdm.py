"""Training CLI: `python -m regennet_torch.train.train_mdm` (counterpart of
regennet_tpu/train/train_mdm.py): one GPU, or one process per GPU under
`torchrun --nproc_per_node N -m regennet_torch.train.train_mdm
--data_parallel N ...` (and --tensor_parallel, --param_sharding fsdp:
parallel/mesh.py).

parse args -> device -> process group -> fix seeds -> platform ->
args.json -> data (this rank's stride) -> model and diffusion ->
TrainLoop.run_loop(). Checkpoints land in --save_dir as
model{step:09d}.pt (what cgenerate loads) and opt{step:09d}.pt (what a
resumed run loads), whole, in the one-device layout. Rank 0 alone writes.
"""

from __future__ import annotations

import os

import torch

from regennet_torch.data.get_data import get_dataset_loader
from regennet_torch.device import pin_f32_contract, resolve_device
from regennet_torch.parallel import mesh
from regennet_torch.train.train_platforms import NoPlatform, get_platform
from regennet_torch.train.training_loop import TrainLoop
from regennet_torch.utils import kvlogger as logger
from regennet_torch.utils import parser_util
from regennet_torch.utils.fixseed import fixseed
from regennet_torch.utils.model_util import _pick_activation, create_model_and_diffusion


def main(args=None, device=None, data=None) -> TrainLoop:
    """Train and return the finished TrainLoop.

    device: "cpu", "cuda:N" or a torch.device; None means cuda:{args.device}
    (cuda:LOCAL_RANK under a launcher) and raises without CUDA, before
    anything is written. data: a BatchLoader (e.g. over Feeder(clips=...))
    instead of loading args.data_path: under a process group, this rank's
    stride of the data."""
    if args is None:
        args = parser_util.train_args()
    device = mesh.local_device(resolve_device(device, getattr(args, "device", 0)))
    layout = mesh.setup(args, device)
    is_main = layout.is_main
    # recorded in args.json, so the sampler builds the activation trained
    # here even though it loads a .pt file (see model_util._pick_activation)
    args.activation = _pick_activation(args)
    pin_f32_contract()
    fixseed(args.seed)

    if args.save_dir is None:
        raise FileNotFoundError("save_dir was not specified.")
    if os.path.exists(args.save_dir) and not args.overwrite and \
            os.path.exists(os.path.join(args.save_dir, "args.json")):
        raise FileExistsError(
            f"save_dir [{args.save_dir}] already exists (use --overwrite)."
        )
    layout.barrier()  # every rank has checked save_dir before rank 0 writes
    if is_main:
        train_platform = get_platform(args.train_platform_type)(args.save_dir)
        train_platform.report_args(args, name="Args")
        os.makedirs(args.save_dir, exist_ok=True)
        parser_util.save_args(args, args.save_dir)
        logger.configure(args.save_dir)
    else:
        train_platform = NoPlatform(args.save_dir)
        logger.configure(None, formats=(), quiet=True)

    shard, num_shards = mesh.process_shard_info(layout)
    if data is None:
        logger.log(f"creating data loader... (shard {shard}/{num_shards})")
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
            shard=shard,
            num_shards=num_shards,
        )

    logger.log("creating model and diffusion...")
    model, sched, cfg = create_model_and_diffusion(args, data, device=device)

    logger.log("Training...")
    loop = TrainLoop(args, train_platform, model, sched, cfg, data, device, layout)
    loop.run_loop()
    train_platform.close()
    return loop


if __name__ == "__main__":
    main()
