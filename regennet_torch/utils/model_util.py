"""Model + diffusion factory (counterpart of regennet_tpu/utils/model_util.py).

Builds the CMDM module (float32 parameters on the CPU; the caller moves
it to its device and compute dtype), the (possibly respaced) Schedule
on `device`, and the DiffusionConfig from the parsed CLI args.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch

from regennet_torch.diffusion import DiffusionConfig, Schedule, make_schedule
from regennet_torch.models.cmdm import CMDM, random_init_

HML_FRAMES = 196  # the window HumanML3D and KIT clips are padded to


def _pick_activation(args) -> str:
    """'gelu' (the tanh form) unless args.activation says otherwise or
    args.model_path is a released torch file, whose weights reproduce the
    reference only with the exact erf form ('gelu_exact')."""
    explicit = getattr(args, "activation", None)
    if explicit:
        return explicit
    mp = getattr(args, "model_path", "") or ""
    if os.path.isfile(mp) and mp.endswith((".pt", ".tar")):
        return "gelu_exact"
    return "gelu"


def get_model_args(args, data) -> dict:
    if getattr(args, "unconstrained", False):
        cond_mode = "no_cond"
    elif args.dataset in ("kit", "humanml"):
        cond_mode = "text"
    else:
        cond_mode = "action"
    dataset = getattr(data, "dataset", data)
    num_actions = getattr(dataset, "num_actions", 1)

    njoints = {"smpl": 25, "smplx": 56}[args.body_model]
    nfeats = {"rot6d": 6, "xyz": 3}.get(args.pose_rep, 6)
    data_rep = args.pose_rep
    if args.dataset == "humanml":
        data_rep, njoints, nfeats = "hml_vec", 263, 1
    elif args.dataset == "kit":
        data_rep, njoints, nfeats = "hml_vec", 251, 1

    # the window the data gives the model (--num_frames): it shapes the mlp
    # trunk's time mixing, as the input's T shapes the JAX package's at
    # init; the dataset's reference length when it is unset. humanml and
    # kit clips are always padded to 196 frames, whatever --num_frames says
    num_frames = getattr(args, "num_frames", 0) or 0
    if args.dataset in ("humanml", "kit"):
        num_frames = HML_FRAMES
    elif num_frames <= 0:
        num_frames = {"ntu": 60, "chi3d": 150}.get(args.dataset, 60)

    return dict(
        njoints=njoints,
        nfeats=nfeats,
        num_actions=num_actions,
        num_frames=num_frames,
        latent_dim=args.latent_dim,
        ff_size=1024,
        num_layers=args.layers,
        num_heads=4,
        dropout=0.1,
        activation=_pick_activation(args),
        data_rep=data_rep,
        cond_mode=cond_mode,
        cond_mask_prob=args.cond_mask_prob,
        arch=args.arch,
        cm_mode=args.cm_mode,
        wo_pos_emb=args.wo_pos_emb,
        emb_trans_dec=args.emb_trans_dec,
    )


class TextData:
    """What the model factory reads of a text dataset (humanml, kit): one
    action, unused."""
    num_actions = 1


def model_dtype(args) -> torch.dtype:
    """The dtype the denoiser computes in (`--compute_dtype`, float32 when unset)."""
    name = getattr(args, "compute_dtype", None) or "float32"
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def create_gaussian_diffusion(args, num_person: int = None,
                              device="cpu") -> Tuple[Schedule, DiffusionConfig]:
    if num_person is None:
        num_person = getattr(args, "num_person", 1)
    sched = make_schedule(
        noise_schedule=args.noise_schedule,
        steps=getattr(args, "diffusion_steps", 1000),
        timestep_respacing=getattr(args, "timestep_respacing", ""),
        device=device,
    )
    # humanml/kit train on RIC features: the geometric loss terms do not apply
    hml = getattr(args, "dataset", "") in ("humanml", "kit")
    data_rep = "hml_vec" if hml else args.pose_rep
    cfg = DiffusionConfig(
        model_mean_type="start_x",  # the model predicts x_start
        model_var_type="fixed_small" if args.sigma_small else "fixed_large",
        loss_type="mse",
        rescale_timesteps=False,
        lambda_vel=0.0 if hml else args.lambda_vel,
        lambda_rcxyz=0.0 if hml else args.lambda_rcxyz,
        lambda_fc=0.0 if hml else args.lambda_fc,
        lambda_orient=0.0 if hml else args.lambda_orient,
        lambda_body=0.0 if hml else args.lambda_body,
        lambda_transl=0.0 if hml else args.lambda_transl,
        data_rep=data_rep,
        num_person=num_person,
        body_model=args.body_model,
        vel_threshold=args.vel_threshold,
    )
    return sched, cfg


def create_model_and_diffusion(args, data, device="cpu"):
    """The CMDM of `args`, drawn from torch.Generator(args.seed) by the
    JAX package's initialisers (cmdm.random_init_), on the CPU; its
    schedule and diffusion config on `device`."""
    model = random_init_(CMDM(**get_model_args(args, data)),
                         torch.Generator().manual_seed(int(getattr(args, "seed", 0))))
    # the cmdm setting diffuses the single reactor stream
    num_person = 1 if args.setting == "cmdm" else getattr(args, "num_person", 1)
    sched, cfg = create_gaussian_diffusion(args, num_person=num_person,
                                           device=device)
    return model, sched, cfg
