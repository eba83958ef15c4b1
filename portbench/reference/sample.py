"""One ancestral (DDPM) step of classifier-free-guided sampling, plain:
the guided x0 prediction of x_t, the posterior mean of q(x_{t-1} | x_t,
x0) and its fixed small variance times the step's noise z (none at t =
0), as the sampler of an x0-predicting model takes it, with no clamp.
Imports nothing of the program."""

from __future__ import annotations

import torch

from . import model, numerics


def step(weights, cfg: dict, sched: dict, x_t, t: int, cond: dict, scale: float, z,
         precision: str = "float32"):
    """(x0_hat, x_{t-1}) of x_t [B, J, F, T] at timestep t."""
    B = x_t.shape[0]
    tt = torch.full((B,), t, dtype=torch.long, device=x_t.device)
    x0 = model.cfg_denoise(weights, cfg, x_t, tt, cond, scale, precision)
    mean = sched["post_coef1"][t] * x0 + sched["post_coef2"][t] * x_t
    if t == 0:
        return x0, mean
    return x0, mean + torch.exp(0.5 * sched["post_log_var"][t]) * z


def schedule(cfg: dict, device) -> dict:
    return numerics.cosine_schedule(cfg["diffusion_steps"], device)
