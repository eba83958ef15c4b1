"""Core Gaussian-diffusion math (counterpart of regennet_tpu/diffusion/gaussian.py).

Pure functions of (Schedule, DiffusionConfig, tensors). Model callable
contract, as in the JAX package:
    model_fn(x [B, J, F, T], t_original [B] int64, cond: dict) -> prediction
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from regennet_torch.diffusion.schedule import DiffusionConfig, Schedule

ModelFn = Callable[[torch.Tensor, torch.Tensor, Dict], torch.Tensor]


def _extract(arr: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-timestep coefficients, shaped [B, 1, ...] for broadcasting."""
    out = arr[t].float()
    return out.reshape(out.shape[0], *([1] * (ndim - 1)))


def scale_timesteps(sched: Schedule, cfg: DiffusionConfig, t: torch.Tensor):
    """Respaced t -> original timesteps (optionally rescaled to ~1000)."""
    new_t = sched.timestep_map[t]
    if cfg.rescale_timesteps:
        return new_t.float() * (1000.0 / sched.original_num_steps)
    return new_t


def q_sample(sched: Schedule, x_start, t, noise):
    """Sample from q(x_t | x_0)."""
    return (
        _extract(sched.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
        + _extract(sched.sqrt_one_minus_alphas_cumprod, t, x_start.ndim) * noise
    )


def q_posterior_mean_variance(sched: Schedule, x_start, x_t, t):
    """Mean/variance of q(x_{t-1} | x_t, x_0)."""
    mean = (
        _extract(sched.posterior_mean_coef1, t, x_t.ndim) * x_start
        + _extract(sched.posterior_mean_coef2, t, x_t.ndim) * x_t
    )
    variance = _extract(sched.posterior_variance, t, x_t.ndim)
    log_variance = _extract(sched.posterior_log_variance_clipped, t, x_t.ndim)
    return mean, variance, log_variance


def predict_eps_from_xstart(sched: Schedule, x_t, t, pred_xstart):
    return (
        _extract(sched.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t - pred_xstart
    ) / _extract(sched.sqrt_recipm1_alphas_cumprod, t, x_t.ndim)


def p_mean_variance(
    sched: Schedule,
    cfg: DiffusionConfig,
    model_fn: ModelFn,
    x: torch.Tensor,
    t: torch.Tensor,
    cond: Dict,
    clip_denoised: bool = True,
) -> Dict[str, torch.Tensor]:
    """Model-predicted p(x_{t-1} | x_t) plus the x_0 prediction, for a
    model that predicts x_0 (start_x) with a fixed variance.

    The motion-inpainting hook: where cond holds 'inpainting_mask' and
    'inpainted_motion', the x_0 prediction is overwritten with the
    inpainted motion where the mask is set, before the clamp."""
    if cfg.model_var_type == "fixed_large":
        model_variance = _extract(sched.fixed_large_variance, t, x.ndim)
        model_log_variance = _extract(sched.fixed_large_log_variance, t, x.ndim)
    elif cfg.model_var_type == "fixed_small":
        model_variance = _extract(sched.posterior_variance, t, x.ndim)
        model_log_variance = _extract(sched.posterior_log_variance_clipped, t, x.ndim)
    else:
        raise NotImplementedError(f"model_var_type={cfg.model_var_type}")
    if cfg.model_mean_type != "start_x":
        raise NotImplementedError(f"model_mean_type={cfg.model_mean_type}")

    pred_xstart = model_fn(x, scale_timesteps(sched, cfg, t), cond)
    if "inpainting_mask" in cond and "inpainted_motion" in cond:
        m = cond["inpainting_mask"].to(pred_xstart.dtype)
        pred_xstart = pred_xstart * (1 - m) + cond["inpainted_motion"] * m
    if clip_denoised:
        pred_xstart = pred_xstart.clamp(-1.0, 1.0)
    model_mean, _, _ = q_posterior_mean_variance(sched, pred_xstart, x, t)
    return {
        "mean": model_mean,
        "variance": model_variance,
        "log_variance": model_log_variance,
        "pred_xstart": pred_xstart,
    }
