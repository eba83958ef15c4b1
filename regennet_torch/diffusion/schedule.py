"""Diffusion noise schedules and timestep respacing.

Counterpart of regennet_tpu/diffusion/schedule.py. Every derived array is
computed once on the host in float64 numpy, exactly as there, and stored
as a float32 torch tensor on the sampling device. A respaced `Schedule`
carries `timestep_map`, so the model always sees original-scale
timesteps.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Set, Union

import numpy as np
import torch


def get_named_beta_schedule(
    schedule_name: str, num_diffusion_timesteps: int, scale_betas: float = 1.0
) -> np.ndarray:
    """Named beta schedules: 'linear' (Ho et al.) and 'cosine' (Nichol)."""
    if schedule_name == "linear":
        scale = scale_betas * 1000 / num_diffusion_timesteps
        return np.linspace(
            scale * 0.0001, scale * 0.02, num_diffusion_timesteps, dtype=np.float64
        )
    if schedule_name == "cosine":
        def alpha_bar(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

        betas = []
        for i in range(num_diffusion_timesteps):
            t1 = i / num_diffusion_timesteps
            t2 = (i + 1) / num_diffusion_timesteps
            betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), 0.999))
        return np.array(betas, dtype=np.float64)
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


def space_timesteps(
    num_timesteps: int, section_counts: Union[str, Sequence[int]]
) -> Set[int]:
    """Timesteps kept by respacing: a "ddimN" string (fixed stride that must
    divide evenly) or per-section counts such as "10,10" or [25]."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired_count = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired_count:
                    return set(range(0, num_timesteps, i))
            raise ValueError(
                f"cannot create exactly {desired_count} steps with an integer stride"
            )
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(
                f"cannot divide section of {size} steps into {section_count}"
            )
        frac_stride = 1 if section_count <= 1 else (size - 1) / (section_count - 1)
        cur_idx = 0.0
        taken = []
        for _ in range(section_count):
            taken.append(start_idx + round(cur_idx))
            cur_idx += frac_stride
        all_steps += taken
        start_idx += size
    return set(all_steps)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Precomputed diffusion arrays, one float32 entry per (possibly
    respaced) step, all on one device."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    alphas_cumprod_next: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    fixed_large_variance: torch.Tensor
    fixed_large_log_variance: torch.Tensor
    timestep_map: torch.Tensor  # int64 [T]: respaced index -> original timestep
    num_timesteps: int
    original_num_steps: int

    @property
    def device(self) -> torch.device:
        return self.betas.device


def _schedule_from_betas(betas, timestep_map, original_num_steps, device):
    betas = np.asarray(betas, dtype=np.float64)
    if not (betas.ndim == 1 and (betas > 0).all() and (betas <= 1).all()):
        raise ValueError("betas must be a 1-D array in (0, 1]")
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    alphas_cumprod_next = np.append(alphas_cumprod[1:], 0.0)

    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    # the t=0 slot takes the t=1 value (posterior_variance[0] is 0); a
    # 1-step schedule has no t=1 and keeps its only entry
    pv1 = posterior_variance[min(1, len(betas) - 1)]
    posterior_log_variance_clipped = np.log(
        np.append(max(pv1, 1e-20), posterior_variance[1:])
    )
    fixed_large_variance = np.append(pv1, betas[1:])
    with np.errstate(divide="ignore"):
        # a 1-step schedule makes entry 0 exactly 0: log is -inf, unused
        fixed_large_log_variance = np.log(fixed_large_variance)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return Schedule(
        betas=f32(betas),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        alphas_cumprod_next=f32(alphas_cumprod_next),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        log_one_minus_alphas_cumprod=f32(np.log(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1)),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(posterior_log_variance_clipped),
        posterior_mean_coef1=f32(
            betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)
        ),
        posterior_mean_coef2=f32(
            (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)
        ),
        fixed_large_variance=f32(fixed_large_variance),
        fixed_large_log_variance=f32(fixed_large_log_variance),
        timestep_map=torch.as_tensor(
            np.asarray(timestep_map, np.int64), device=device
        ),
        num_timesteps=int(betas.shape[0]),
        original_num_steps=int(original_num_steps),
    )


def make_schedule(
    noise_schedule: str = "cosine",
    steps: int = 1000,
    timestep_respacing: Union[str, Sequence[int], None] = "",
    scale_betas: float = 1.0,
    device: Union[str, torch.device] = "cpu",
) -> Schedule:
    """Build a (possibly respaced) schedule on `device`. Kept steps get
    their betas re-derived from the kept alpha_cumprod values."""
    base_betas = get_named_beta_schedule(noise_schedule, steps, scale_betas)
    if not timestep_respacing:
        return _schedule_from_betas(base_betas, np.arange(steps), steps, device)

    use_timesteps = space_timesteps(steps, timestep_respacing)
    base_alphas_cumprod = np.cumprod(1.0 - base_betas)
    last_alpha_cumprod = 1.0
    new_betas, timestep_map = [], []
    for i, alpha_cumprod in enumerate(base_alphas_cumprod):
        if i in use_timesteps:
            new_betas.append(1 - alpha_cumprod / last_alpha_cumprod)
            last_alpha_cumprod = alpha_cumprod
            timestep_map.append(i)
    return _schedule_from_betas(
        np.array(new_betas), np.array(timestep_map), steps, device
    )


MEAN_TYPES = ("previous_x", "start_x", "epsilon")
VAR_TYPES = ("learned", "fixed_small", "fixed_large", "learned_range")
LOSS_TYPES = ("mse", "rescaled_mse", "kl", "rescaled_kl")


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """Static diffusion/loss configuration (same fields as the JAX package's)."""

    model_mean_type: str = "start_x"
    model_var_type: str = "fixed_small"
    loss_type: str = "mse"
    rescale_timesteps: bool = False
    lambda_rcxyz: float = 0.0
    lambda_vel: float = 0.0
    lambda_pose: float = 1.0
    lambda_loc: float = 1.0
    lambda_root_vel: float = 0.0
    lambda_vel_rcxyz: float = 0.0
    lambda_fc: float = 0.0
    lambda_orient: float = 0.0
    lambda_body: float = 0.0
    lambda_transl: float = 0.0
    data_rep: str = "rot6d"
    num_person: int = 1
    body_model: str = "smpl"
    vel_threshold: float = 0.01

    def __post_init__(self):
        if self.model_mean_type not in MEAN_TYPES:
            raise ValueError(f"model_mean_type {self.model_mean_type!r}")
        if self.model_var_type not in VAR_TYPES:
            raise ValueError(f"model_var_type {self.model_var_type!r}")
        if self.loss_type not in LOSS_TYPES:
            raise ValueError(f"loss_type {self.loss_type!r}")
        geometric = (
            self.lambda_rcxyz or self.lambda_vel or self.lambda_root_vel
            or self.lambda_vel_rcxyz or self.lambda_fc or self.lambda_orient
            or self.lambda_body or self.lambda_transl
        )
        if geometric and self.loss_type != "mse":
            raise ValueError("Geometric losses are supported by MSE loss type only!")
