"""One rank of tests/test_torch_distributed.py: `python _torch_dist_worker.py
CONFIG.json`, started with the launcher's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT), on the CPU over gloo.

Runs each scenario of the config through regennet_torch's TrainLoop under
its layout on this rank's rows of the global batches, and saves the whole
state through TrainLoop.save (rank 0 writes). The test module imports the
builders below for its one-process references; this module imports no JAX.
"""

import json
import os
import sys
from argparse import Namespace

import numpy as np
import torch

J, F, T = 6, 6, 8
MODEL = dict(njoints=J, nfeats=F, num_actions=4, num_frames=T, latent_dim=32, ff_size=64,
             num_layers=2, num_heads=2, arch="online", cm_mode="concat", cond_mode="action")
LAMBDAS = dict(lambda_vel=1.0, lambda_orient=1.0, lambda_transl=1.0)


def make_args(save_dir, **over):
    base = dict(
        seed=10, batch_size=4, lr=1e-4, weight_decay=0.01, lr_anneal_steps=0,
        ema_rate=0.99, log_interval=1, save_interval=1000, num_steps=100,
        save_dir=save_dir, overwrite=True, resume_checkpoint="", body_model="smplx",
        pose_rep="rot6d", dataset="chi3d", setting="cmdm", nan_guard=False,
        steps_per_call=1, profile_steps=0, profile_start=10, eval_during_training=False,
        data_parallel=-1, tensor_parallel=1, param_sharding="replicated",
        compute_dtype="float32", dropout=0.1, cond_mask_prob=0.1,
    )
    base.update(over)
    return Namespace(**base)


def make_model(args):
    from regennet_torch.models import cmdm

    torch.manual_seed(0)
    return cmdm.CMDM(**MODEL, dropout=args.dropout, cond_mask_prob=args.cond_mask_prob)


def make_diffusion():
    from regennet_torch.diffusion.schedule import DiffusionConfig, make_schedule

    return make_schedule("cosine", 10), DiffusionConfig(**LAMBDAS)


def global_batches(n, batch, seed=3, nan_step=None):
    """n global batches (motion [B, J, F, T], {"y": cond}) as numpy;
    nan_step: that batch's last row is NaN (the last rank's rows)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        mask = np.ones((batch, 1, 1, T), bool)
        mask[0, ..., T - 2:] = False
        y = {"mask": mask,
             "cmotion": rng.normal(size=(batch, J, F, T)).astype(np.float32),
             "action": rng.integers(0, MODEL["num_actions"], size=(batch, 1))}
        out.append((rng.normal(size=(batch, J, F, T)).astype(np.float32), {"y": y}))
    if nan_step is not None:
        out[nan_step][0][-1] = np.nan
    return out


def rows(batch, rank, size):
    """This data rank's rows of a global batch."""
    motion, cond = batch
    n = motion.shape[0] // size
    sl = slice(rank * n, (rank + 1) * n)
    return motion[sl], {"y": {k: v[sl] for k, v in cond["y"].items()}}


def make_loop(args, layout=None, state_file=""):
    from regennet_torch.train.train_platforms import NoPlatform
    from regennet_torch.train.training_loop import TrainLoop

    model = make_model(args)
    if state_file:
        model.load_state_dict(torch.load(state_file), strict=True)
    sched, cfg = make_diffusion()
    data = [None] * 4  # len(data) only: the steps are driven by hand
    return TrainLoop(args, NoPlatform(args.save_dir), model, sched, cfg, data,
                     torch.device("cpu"), layout)


def run(loop, batches, noise=None):
    """One optimizer step per batch; noise: each step's q_sample draw."""
    losses = []
    for i, (motion, cond) in enumerate(batches):
        if noise is None:
            metrics = loop.run_step(motion, cond)
        else:
            host = loop._make_host_batch(motion, cond)
            metrics = loop._train_step(loop._to_device(host), loop.generator,
                                       loop.state_step, noise=torch.tensor(noise[i]))
            metrics.pop("loss_per_elem")
        if metrics.get("nan_skipped"):
            losses.append(float("nan"))  # rolled back: no step
            continue
        loop.step += 1
        losses.append(float(metrics["loss"]))
    return losses


def main(cfg_path):
    from regennet_torch.parallel import mesh

    with open(cfg_path) as f:
        cfg = json.load(f)
    torch.set_num_threads(1)
    results = {}
    for name, sc in cfg["scenarios"].items():
        os.environ["REGENNET_SCHEDULE_SAMPLER"] = sc.get("sampler", "uniform")
        args = make_args(os.path.join(cfg["out"], name), **sc["args"])
        layout = mesh.setup(args, torch.device("cpu"))
        rank, size = layout.data_rank, layout.data_size
        batches = [rows(b, rank, size) for b in global_batches(sc["steps"], sc["batch"],
                                                                  nan_step=sc.get("nan_step"))]
        noise = None
        if sc.get("noise"):
            n = sc["batch"] // size
            noise = np.load(sc["noise"])[:, rank * n:(rank + 1) * n]
        loop = make_loop(args, layout, sc.get("state", ""))
        split = sc.get("resume_after", len(batches))
        losses = run(loop, batches[:split], noise)
        loop.save()
        if split < len(batches):  # a new sharded run from the whole checkpoint
            from regennet_torch.train import checkpoint

            args.resume_checkpoint = checkpoint.latest_checkpoint(args.save_dir)
            loop = make_loop(args, layout)
            losses += run(loop, batches[split:])
            loop.save()
        sampler = loop.schedule_sampler
        results[name] = {
            "losses": losses, "layout": [rank, size, layout.model_rank, layout.model_size],
            "history": getattr(sampler, "_loss_history", np.zeros(0)).tolist(),
            "counts": getattr(sampler, "_loss_counts", np.zeros(0)).tolist(),
            "num_heads": [m.num_heads for m in loop.model.modules()
                          if hasattr(m, "in_proj_weight")],
        }
    if cfg.get("sample"):
        # an evaluation batch of 5 rows, shared 3/2 over the ranks
        from regennet_torch.eval import stgcn_eval
        from regennet_torch.models.cmdm import make_model_fn

        sched, dcfg = make_diffusion()
        model = make_model(make_args("")).eval()
        motion, cond = global_batches(1, 5, seed=4)[0]

        def sample_one(generator, cond, shape, rows=None):
            from regennet_torch.diffusion import sampling

            return sampling.p_sample_loop(sched, dcfg, make_model_fn(model), shape, cond,
                                          clip_denoised=False, generator=generator, rows=rows)

        tcond = {k: torch.tensor(v) for k, v in cond["y"].items()}
        out = stgcn_eval.sharded_sampler(sample_one)(
            torch.Generator().manual_seed(5), tcond, motion.shape)
        np.save(os.path.join(cfg["out"], f"sample_rank{mesh.global_rank()}.npy"), out.numpy())
    with open(os.path.join(cfg["out"], f"rank{mesh.global_rank()}.json"), "w") as f:
        json.dump(results, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main(sys.argv[1])
