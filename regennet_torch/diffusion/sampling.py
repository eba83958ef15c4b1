"""Ancestral (DDPM) and DDIM sampling loops (counterpart of
regennet_tpu/diffusion/sampling.py).

The loops are plain Python loops over the timesteps. Noise comes from an
explicit `torch.Generator`, or is handed in: `noise` is the initial x and
`step_noise` holds one z per step, consumed in loop order (a z is drawn
at every step, the last included, as the JAX loops do). Tests feed both
from the JAX package's PRNG stream to hold the trajectories against it.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from regennet_torch.diffusion import gaussian
from regennet_torch.diffusion.schedule import DiffusionConfig, Schedule

ModelFn = gaussian.ModelFn


def _nonzero_mask(t: torch.Tensor, ndim: int) -> torch.Tensor:
    return (t != 0).float().reshape(-1, *([1] * (ndim - 1)))


def _prepare_cond(model_fn: ModelFn, cond: Dict) -> Dict:
    """Let the model precompute loop-invariant conditioning once (an
    optional `prepare` attribute on the ModelFn)."""
    prepare = getattr(model_fn, "prepare", None)
    if prepare is None or not cond:
        return cond
    return prepare(cond)


class _Noise:
    """The initial x and the per-step z: handed in, or drawn from `generator`."""

    def __init__(self, shape, device, generator, noise, step_noise):
        self.shape = tuple(shape)
        self.device = device
        self.generator = generator
        self.noise = noise
        self.steps = None if step_noise is None else iter(step_noise)

    def _draw(self):
        return torch.randn(self.shape, generator=self.generator,
                           device=self.device, dtype=torch.float32)

    def init(self) -> torch.Tensor:
        if self.noise is not None:
            return self.noise.to(self.device, torch.float32)
        return self._draw()

    def step(self) -> torch.Tensor:
        if self.steps is None:
            return self._draw()
        z = next(self.steps, None)
        if z is None:
            raise ValueError("step_noise holds fewer z than the loop has steps")
        return z.to(self.device, torch.float32)


def _start(sched, noise: _Noise, init_image, skip_timesteps):
    """Initial x, optionally the partial-noise start
    q_sample(init_image, T - skip - 1, noise=x)."""
    x = noise.init()
    if skip_timesteps and init_image is None:
        init_image = torch.zeros_like(x)
    if init_image is not None:
        t0 = torch.full((x.shape[0],), sched.num_timesteps - skip_timesteps - 1,
                        dtype=torch.long, device=x.device)
        x = gaussian.q_sample(sched, init_image.to(x.device), t0, x)
    return x


@torch.no_grad()
def p_sample_loop(
    sched: Schedule,
    cfg: DiffusionConfig,
    model_fn: ModelFn,
    shape,
    cond: Dict,
    clip_denoised: bool = True,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    step_noise: Optional[Sequence[torch.Tensor]] = None,
    skip_timesteps: int = 0,
    init_image: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Ancestral (DDPM) sampling. Returns the final sample."""
    cond = _prepare_cond(model_fn, cond)
    draws = _Noise(shape, sched.device, generator, noise, step_noise)
    x = _start(sched, draws, init_image, skip_timesteps)
    for i in range(sched.num_timesteps - skip_timesteps - 1, -1, -1):
        t = torch.full((shape[0],), i, dtype=torch.long, device=x.device)
        out = gaussian.p_mean_variance(
            sched, cfg, model_fn, x, t, cond, clip_denoised
        )
        z = draws.step()
        x = out["mean"] + _nonzero_mask(t, x.ndim) * torch.exp(
            0.5 * out["log_variance"]
        ) * z
    return x


@torch.no_grad()
def ddim_sample_loop(
    sched: Schedule,
    cfg: DiffusionConfig,
    model_fn: ModelFn,
    shape,
    cond: Dict,
    clip_denoised: bool = True,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    step_noise: Optional[Sequence[torch.Tensor]] = None,
    eta: float = 0.0,
    skip_timesteps: int = 0,
    init_image: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """DDIM sampling (Song et al. eq. 12)."""
    cond = _prepare_cond(model_fn, cond)
    draws = _Noise(shape, sched.device, generator, noise, step_noise)
    x = _start(sched, draws, init_image, skip_timesteps)
    for i in range(sched.num_timesteps - skip_timesteps - 1, -1, -1):
        t = torch.full((shape[0],), i, dtype=torch.long, device=x.device)
        out = gaussian.p_mean_variance(
            sched, cfg, model_fn, x, t, cond, clip_denoised
        )
        eps = gaussian.predict_eps_from_xstart(sched, x, t, out["pred_xstart"])
        alpha_bar = gaussian._extract(sched.alphas_cumprod, t, x.ndim)
        alpha_bar_prev = gaussian._extract(sched.alphas_cumprod_prev, t, x.ndim)
        sigma = (
            eta
            * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
            * torch.sqrt(1 - alpha_bar / alpha_bar_prev)
        )
        mean_pred = out["pred_xstart"] * torch.sqrt(alpha_bar_prev) + torch.sqrt(
            torch.clamp(1 - alpha_bar_prev - sigma**2, min=0.0)
        ) * eps
        z = draws.step()
        x = mean_pred + _nonzero_mask(t, x.ndim) * sigma * z
    return x
