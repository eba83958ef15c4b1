"""Ancestral (DDPM), DDIM, reverse DDIM and PLMS sampling loops
(counterpart of regennet_tpu/diffusion/sampling.py).

The loops are plain Python loops over the timesteps. Noise comes from an
explicit `torch.Generator`, or is handed in: `noise` is the initial x and
`step_noise` holds one z per step, consumed in loop order (a z is drawn
at every step of DDPM and DDIM, the last included, as the JAX loops do;
PLMS and the reverse loop draw none). Tests feed both from the JAX
package's PRNG stream to hold the trajectories against it.

Classifier guidance: `cond_fn(x, t, cond)` returns the gradient of a log
probability with respect to x. The loops run without autograd; each call
of cond_fn runs with it enabled, on a detached copy of x that requires
grad, and its result comes back detached.

Each step of every loop runs in a `sample.step` span (utils/profiling);
the steps of one call share the call's request id.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from regennet_torch.diffusion import gaussian
from regennet_torch.diffusion.schedule import DiffusionConfig, Schedule
from regennet_torch.utils import profiling

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


def _with_grad(cond_fn: Optional[Callable]) -> Optional[Callable]:
    """cond_fn run with autograd on a detached x that requires grad."""
    if cond_fn is None:
        return None

    def fn(x, t, cond):
        with torch.enable_grad():
            gradient = cond_fn(x.detach().requires_grad_(True), t, cond)
        return gradient.detach()

    return fn


class _Noise:
    """The initial x and the per-step z: handed in, or drawn from `generator`
    (rows=(row0, total): drawn for a batch of `total` rows, of which this
    one takes rows [row0, row0 + shape[0]])."""

    def __init__(self, shape, device, generator, noise, step_noise, rows=None):
        self.shape = tuple(shape)
        self.device = device
        self.generator = generator
        self.noise = noise
        self.steps = None if step_noise is None else iter(step_noise)
        self.rows = rows

    def _draw(self):
        if self.rows is None:
            return torch.randn(self.shape, generator=self.generator,
                               device=self.device, dtype=torch.float32)
        row0, total = self.rows
        z = torch.randn((total,) + self.shape[1:], generator=self.generator,
                        device=self.device, dtype=torch.float32)
        return z[row0:row0 + self.shape[0]]

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
    denoised_fn: Optional[Callable] = None,
    cond_fn: Optional[Callable] = None,
    const_noise: bool = False,
    rows=None,
) -> torch.Tensor:
    """Ancestral (DDPM) sampling. Returns the final sample. const_noise:
    every row takes row 0 of each step's z (the initial x stays a full
    draw). rows=(row0, total): `shape` is rows [row0, row0 + shape[0]] of a
    batch of `total`, whose noise is drawn (a data-parallel rank's share)."""
    cond = _prepare_cond(model_fn, cond)
    cond_fn = _with_grad(cond_fn)
    draws = _Noise(shape, sched.device, generator, noise, step_noise, rows)
    x = _start(sched, draws, init_image, skip_timesteps)
    request = profiling.new_request()
    for i in range(sched.num_timesteps - skip_timesteps - 1, -1, -1):
        with profiling.span("sample.step", request):
            t = torch.full((shape[0],), i, dtype=torch.long, device=x.device)
            out = gaussian.p_mean_variance(
                sched, cfg, model_fn, x, t, cond, clip_denoised, denoised_fn
            )
            if cond_fn is not None:
                out["mean"] = gaussian.condition_mean(sched, cfg, cond_fn, out, x, t, cond)
            z = draws.step()
            if const_noise:
                z = z[:1].expand(z.shape)
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
    denoised_fn: Optional[Callable] = None,
    cond_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """DDIM sampling (Song et al. eq. 12)."""
    cond = _prepare_cond(model_fn, cond)
    cond_fn = _with_grad(cond_fn)
    draws = _Noise(shape, sched.device, generator, noise, step_noise)
    x = _start(sched, draws, init_image, skip_timesteps)
    request = profiling.new_request()
    for i in range(sched.num_timesteps - skip_timesteps - 1, -1, -1):
        with profiling.span("sample.step", request):
            t = torch.full((shape[0],), i, dtype=torch.long, device=x.device)
            out = gaussian.p_mean_variance(
                sched, cfg, model_fn, x, t, cond, clip_denoised, denoised_fn
            )
            if cond_fn is not None:
                out = gaussian.condition_score(sched, cfg, cond_fn, out, x, t, cond)
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


@torch.no_grad()
def ddim_reverse_sample_loop(
    sched: Schedule,
    cfg: DiffusionConfig,
    model_fn: ModelFn,
    x0: torch.Tensor,
    cond: Dict,
    clip_denoised: bool = True,
) -> torch.Tensor:
    """Deterministic DDIM encoding x_0 -> x_T (the reverse ODE), t = 0
    to T-1. The conditioning goes to model_fn as given (no `prepare`, as
    in the JAX loop)."""
    x = x0
    request = profiling.new_request()
    for i in range(sched.num_timesteps):
        with profiling.span("sample.step", request):
            t = torch.full((x.shape[0],), i, dtype=torch.long, device=x.device)
            out = gaussian.p_mean_variance(sched, cfg, model_fn, x, t, cond, clip_denoised)
            eps = gaussian.predict_eps_from_xstart(sched, x, t, out["pred_xstart"])
            alpha_bar_next = gaussian._extract(sched.alphas_cumprod_next, t, x.ndim)
            x = out["pred_xstart"] * torch.sqrt(alpha_bar_next) + torch.sqrt(
                1 - alpha_bar_next
            ) * eps
    return x


# Adams-Bashforth coefficients of orders 1-4, newest eps first
_ADAMS_BASHFORTH = (
    (1.0,),
    (3.0 / 2.0, -1.0 / 2.0),
    (23.0 / 12.0, -16.0 / 12.0, 5.0 / 12.0),
    (55.0 / 24.0, -59.0 / 24.0, 37.0 / 24.0, -9.0 / 24.0),
)


@torch.no_grad()
def plms_sample_loop(
    sched: Schedule,
    cfg: DiffusionConfig,
    model_fn: ModelFn,
    shape,
    cond: Dict,
    clip_denoised: bool = True,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    denoised_fn: Optional[Callable] = None,
    cond_fn: Optional[Callable] = None,
    order: int = 2,
    skip_timesteps: int = 0,
    init_image: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Pseudo Linear Multistep sampling (orders 1-4: Adams-Bashforth on
    eps). At order > 1 the first step is the pseudo improved Euler step,
    which calls the model twice; steps + 1 model calls in all."""
    if not 1 <= int(order) <= 4:
        raise ValueError("order is invalid (should be int from 1-4).")
    cond = _prepare_cond(model_fn, cond)
    cond_fn = _with_grad(cond_fn)
    draws = _Noise(shape, sched.device, generator, noise, None)
    x = _start(sched, draws, init_image, skip_timesteps)

    def model_eps(x, t):
        out = gaussian.p_mean_variance(
            sched, cfg, model_fn, x, t, cond, clip_denoised, denoised_fn
        )
        if cond_fn is not None:
            out = gaussian.condition_score(sched, cfg, cond_fn, out, x, t, cond)
        return gaussian.predict_eps_from_xstart(sched, x, t, out["pred_xstart"]), out

    history: List[torch.Tensor] = []  # earlier steps' eps, newest first
    request = profiling.new_request()
    for i in range(sched.num_timesteps - skip_timesteps - 1, -1, -1):
        with profiling.span("sample.step", request):
            t = torch.full((shape[0],), i, dtype=torch.long, device=x.device)
            alpha_bar_prev = gaussian._extract(sched.alphas_cumprod_prev, t, x.ndim)
            eps, out = model_eps(x, t)
            if order > 1 and not history:
                # pseudo improved Euler
                mean_pred = out["pred_xstart"] * torch.sqrt(alpha_bar_prev) + torch.sqrt(
                    1 - alpha_bar_prev
                ) * eps
                eps2, _ = model_eps(mean_pred, torch.clamp(t - 1, min=0))
                eps_prime = (eps + eps2) / 2
            else:
                hist = [eps] + history
                coeffs = _ADAMS_BASHFORTH[len(hist) - 1]
                eps_prime = sum(c * e for c, e in zip(coeffs, hist))
            pred_prime = gaussian.predict_xstart_from_eps(sched, x, t, eps_prime)
            mean_pred = pred_prime * torch.sqrt(alpha_bar_prev) + torch.sqrt(
                1 - alpha_bar_prev
            ) * eps_prime
            nz = _nonzero_mask(t, x.ndim)
            x = mean_pred * nz + out["pred_xstart"] * (1 - nz)
            history = [eps] + history[:order - 2] if order > 1 else []
    return x
