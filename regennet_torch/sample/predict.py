"""Programmatic serving wrapper (counterpart of regennet_tpu/sample/predict.py).

A plain `Predictor` with the setup()/predict() lifecycle any serving shim
(FastAPI, gRPC, Cog) can host: setup() builds the model from the args.json
beside a checkpoint of the port's trainer and loads its weights once;
predict() samples a reaction for each actor clip it is given. Nothing is
compiled per shape, so calls of any batch or length share the model.

The sampler's noise comes from a torch.Generator seeded by predict's
`seed` (the same seed gives the same output), or is handed in as `noise`:
the initial x and one z per step, as the diffusion loops take them.
"""

from __future__ import annotations

import json
import os
from argparse import Namespace
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from regennet_torch.device import resolve_device
from regennet_torch.diffusion import sampling
from regennet_torch.models.cmdm import make_cfg_model_fn, make_model_fn
from regennet_torch.train import checkpoint
from regennet_torch.utils.model_util import create_model_and_diffusion, model_dtype


class Predictor:
    """setup() once, predict() many times."""

    def setup(self, model_path: str, guidance_param: float = 1.0,
              use_ddim: bool = False, timestep_respacing: str = "", device=None):
        """device: "cpu", "cuda:N" or a torch.device; None means cuda:0 and
        raises without CUDA."""
        self.device = resolve_device(device)
        # f32 means f32 on the GPU: no TF32 in matmuls or convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        with open(os.path.join(os.path.dirname(model_path), "args.json")) as f:
            margs = json.load(f)
        margs.setdefault("timestep_respacing", timestep_respacing)
        if timestep_respacing:
            margs["timestep_respacing"] = timestep_respacing
        args = Namespace(**margs)
        self.args = args
        self.num_frames = {"ntu": 60, "chi3d": 150}.get(
            args.dataset, getattr(args, "num_frames", 60))

        class _DataStub:
            num_actions = {"ntu": 26, "chi3d": 8}.get(args.dataset, 1)
            num_person = args.num_person

        model, self.sched, self.cfg = create_model_and_diffusion(args, _DataStub(),
                                                                  device=self.device)
        checkpoint.load_model(model, model_path)
        self.model = model.to(device=self.device, dtype=model_dtype(args)).eval()
        self.model_fn = (make_cfg_model_fn(self.model, guidance_param)
                         if guidance_param != 1.0 else make_model_fn(self.model))
        self.sampler = sampling.ddim_sample_loop if use_ddim else sampling.p_sample_loop

    def predict(self, cmotion: np.ndarray, action: Optional[np.ndarray] = None,
                seed: int = 0,
                noise: Optional[Tuple[torch.Tensor, Sequence[torch.Tensor]]] = None
                ) -> np.ndarray:
        """cmotion [B, J, F, T] actor motion -> generated reactor [B, J, F, T].
        action [B, 1] (zeros when None); noise: (initial x, per-step z) in
        place of the draws from torch.Generator(seed)."""
        shape = tuple(cmotion.shape)
        cond = {"cmotion": torch.as_tensor(np.asarray(cmotion), device=self.device)}
        cond["action"] = (torch.zeros((shape[0], 1), dtype=torch.int64, device=self.device)
                          if action is None
                          else torch.as_tensor(np.asarray(action), device=self.device))
        if noise is None:
            draws = dict(generator=torch.Generator(device=self.device).manual_seed(int(seed)))
        else:
            draws = dict(noise=noise[0], step_noise=noise[1])
        out = self.sampler(self.sched, self.cfg, self.model_fn, shape, cond,
                           clip_denoised=False, **draws)
        return out.cpu().numpy()
