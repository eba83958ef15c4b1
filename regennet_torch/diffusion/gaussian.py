"""Core Gaussian-diffusion math (counterpart of regennet_tpu/diffusion/gaussian.py).

Pure functions of (Schedule, DiffusionConfig, tensors). Model callable
contract, as in the JAX package:
    model_fn(x [B, J, F, T], t_original [B] int64, cond: dict) -> prediction
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

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


def q_mean_variance(sched: Schedule, x_start, t):
    """Mean, variance and log variance of q(x_t | x_0)."""
    mean = _extract(sched.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
    variance = _extract(1.0 - sched.alphas_cumprod, t, x_start.ndim)
    log_variance = _extract(sched.log_one_minus_alphas_cumprod, t, x_start.ndim)
    return mean, variance, log_variance


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


def predict_xstart_from_eps(sched: Schedule, x_t, t, eps):
    return (
        _extract(sched.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
        - _extract(sched.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * eps
    )


def predict_xstart_from_xprev(sched: Schedule, x_t, t, xprev):
    c1 = _extract(1.0 / sched.posterior_mean_coef1, t, x_t.ndim)
    c2 = _extract(sched.posterior_mean_coef2 / sched.posterior_mean_coef1, t, x_t.ndim)
    return c1 * xprev - c2 * x_t


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
    denoised_fn: Optional[Callable] = None,
) -> Dict[str, torch.Tensor]:
    """Model-predicted p(x_{t-1} | x_t) plus the x_0 prediction.

    A learned variance ('learned', 'learned_range') takes the model
    output's channels past C = x.shape[1]. The motion-inpainting hook:
    where cond holds 'inpainting_mask' and 'inpainted_motion', the model's
    x_0 prediction is overwritten with the inpainted motion where the mask
    is set, before denoised_fn and the clamp (x_0 prediction only)."""
    model_output = model_fn(x, scale_timesteps(sched, cfg, t), cond)

    if "inpainting_mask" in cond and "inpainted_motion" in cond:
        if cfg.model_mean_type != "start_x":
            raise ValueError("inpainting supports only x_start prediction")
        m = cond["inpainting_mask"].to(model_output.dtype)
        model_output = model_output * (1 - m) + cond["inpainted_motion"] * m

    if cfg.model_var_type in ("learned", "learned_range"):
        C = x.shape[1]
        model_output, model_var_values = model_output[:, :C], model_output[:, C:]
        if cfg.model_var_type == "learned":
            model_log_variance = model_var_values
        else:
            min_log = _extract(sched.posterior_log_variance_clipped, t, x.ndim)
            max_log = _extract(torch.log(sched.betas), t, x.ndim)
            frac = (model_var_values + 1) / 2
            model_log_variance = frac * max_log + (1 - frac) * min_log
        model_variance = torch.exp(model_log_variance)
    elif cfg.model_var_type == "fixed_large":
        model_variance = _extract(sched.fixed_large_variance, t, x.ndim)
        model_log_variance = _extract(sched.fixed_large_log_variance, t, x.ndim)
    else:  # fixed_small
        model_variance = _extract(sched.posterior_variance, t, x.ndim)
        model_log_variance = _extract(sched.posterior_log_variance_clipped, t, x.ndim)

    def process_xstart(v):
        if denoised_fn is not None:
            v = denoised_fn(v)
        if clip_denoised:
            v = v.clamp(-1.0, 1.0)
        return v

    if cfg.model_mean_type == "previous_x":
        pred_xstart = process_xstart(predict_xstart_from_xprev(sched, x, t, model_output))
        model_mean = model_output
    else:
        if cfg.model_mean_type == "start_x":
            pred_xstart = process_xstart(model_output)
        else:  # epsilon
            pred_xstart = process_xstart(predict_xstart_from_eps(sched, x, t, model_output))
        model_mean, _, _ = q_posterior_mean_variance(sched, pred_xstart, x, t)
    return {
        "mean": model_mean,
        "variance": model_variance,
        "log_variance": model_log_variance,
        "pred_xstart": pred_xstart,
    }


def condition_mean(sched, cfg, cond_fn, p_mean_var, x, t, cond):
    """Classifier guidance (Sohl-Dickstein et al.): the mean shifted by
    the variance times cond_fn's gradient."""
    gradient = cond_fn(x, scale_timesteps(sched, cfg, t), cond)
    return p_mean_var["mean"] + p_mean_var["variance"] * gradient


def condition_score(sched, cfg, cond_fn, p_mean_var, x, t, cond):
    """Classifier guidance through the score (Song et al.)."""
    alpha_bar = _extract(sched.alphas_cumprod, t, x.ndim)
    eps = predict_eps_from_xstart(sched, x, t, p_mean_var["pred_xstart"])
    eps = eps - torch.sqrt(1 - alpha_bar) * cond_fn(x, scale_timesteps(sched, cfg, t), cond)
    out = dict(p_mean_var)
    out["pred_xstart"] = predict_xstart_from_eps(sched, x, t, eps)
    out["mean"], _, _ = q_posterior_mean_variance(sched, out["pred_xstart"], x, t)
    return out
