"""The ACTOR baseline's losses: rc, rcxyz, vel, velxyz, kl, mmd and hp
(counterpart of regennet_tpu/models/actor_losses.py).

- rc / rcxyz: masked MSE over the valid frames, divided by the number of
  persons packed in the feature axis;
- vel / velxyz: the same on frame differences;
- kl: the batch-summed KL divergence from N(0, I);
- mmd: the RBF-kernel maximum mean discrepancy between the latent batch
  and a standard-normal sample;
- hp: the Hessian penalty of the encoder's latent with respect to the
  input motion, by central second differences along Rademacher directions.

The mmd and hp draws come from a torch.Generator, or are handed in per
loss name (`noise`): the standard-normal sample for mmd, the [k, *x.shape]
signs for hp.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch


def compute_kernel(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """RBF kernel matrix [N, M]."""
    d2 = torch.mean((x[:, None, :] - y[None, :, :]) ** 2, dim=2) / float(x.shape[1])
    return torch.exp(-d2)


def compute_mmd(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """MMD^2 with an RBF kernel."""
    return (compute_kernel(x, x).mean() + compute_kernel(y, y).mean()
            - 2.0 * compute_kernel(x, y).mean())


def rademacher(shape, generator: Optional[torch.Generator], device=None,
               dtype=torch.float32) -> torch.Tensor:
    """Independent +-1 draws."""
    bits = torch.randint(0, 2, shape, generator=generator, device=device)
    return (2 * bits - 1).to(dtype)


def hessian_penalty(fn: Callable[[torch.Tensor], torch.Tensor], z: torch.Tensor,
                    generator: Optional[torch.Generator] = None, k: int = 2,
                    epsilon: float = 0.1, reduction: Callable = torch.max,
                    signs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Hessian penalty of fn at z (Peebles et al. 2020): k Rademacher
    directions (`signs` [k, *z.shape], else drawn from generator), the
    central second difference (fn(z + eps dz) - 2 fn(z) + fn(z - eps dz)) /
    eps^2 along each, their unbiased variance across directions, reduced
    (max by default) to a scalar."""
    if k < 2:
        raise ValueError("hessian_penalty requires k >= 2 directions")
    if signs is None:
        signs = rademacher((k, *z.shape), generator, z.device, z.dtype)
    center = fn(z)
    seconds = torch.stack([(fn(z + epsilon * dz) - 2.0 * center + fn(z - epsilon * dz))
                           / epsilon ** 2 for dz in signs])
    return reduction(torch.var(seconds, dim=0, correction=1))


def _masked_mse(x: torch.Tensor, out: torch.Tensor, mask: Optional[torch.Tensor],
                person_feats: int) -> torch.Tensor:
    """MSE over [B, J, F, T], over the valid frames of mask [B, T], divided
    by the persons packed in F (F // person_feats)."""
    num_person = max(x.shape[2] // person_feats, 1)
    diff = (x - out) ** 2
    if mask is None:
        return torch.mean(diff) / num_person
    m = mask.to(diff.dtype)
    per_frame = torch.sum(diff, dim=(1, 2))  # [B, T]
    denom = torch.clamp(torch.sum(m) * x.shape[1] * x.shape[2], min=1.0)
    return torch.sum(per_frame * m) / denom / num_person


def _vel(x):
    return x[..., 1:] - x[..., :-1]


def _vel_mask(batch):
    mask = batch.get("mask")
    return None if mask is None else mask[:, 1:]


def compute_rc_loss(batch: Dict, **_) -> torch.Tensor:
    return _masked_mse(batch["x"], batch["output"], batch.get("mask"), 6)


def compute_rcxyz_loss(batch: Dict, **_) -> torch.Tensor:
    return _masked_mse(batch["x_xyz"], batch["output_xyz"], batch.get("mask"), 3)


def compute_vel_loss(batch: Dict, **_) -> torch.Tensor:
    # no division by the persons
    return _masked_mse(_vel(batch["x"]), _vel(batch["output"]), _vel_mask(batch),
                       batch["x"].shape[2])


def compute_velxyz_loss(batch: Dict, **_) -> torch.Tensor:
    return _masked_mse(_vel(batch["x_xyz"]), _vel(batch["output_xyz"]), _vel_mask(batch),
                       batch["x_xyz"].shape[2])


def compute_kl_loss(batch: Dict, **_) -> torch.Tensor:
    mu, logvar = batch["mu"], batch["logvar"]
    return -0.5 * torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar))


def compute_mmd_loss(batch: Dict, generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None, **_) -> torch.Tensor:
    z = batch["z"]
    if noise is None:
        if generator is None:
            raise ValueError("mmd loss needs a generator for the N(0, I) sample")
        noise = torch.randn(z.shape, generator=generator, device=z.device, dtype=z.dtype)
    return compute_mmd(noise, z)


def compute_hp_loss(batch: Dict, generator: Optional[torch.Generator] = None,
                    latent_fn: Optional[Callable] = None,
                    noise: Optional[torch.Tensor] = None, **_) -> torch.Tensor:
    if latent_fn is None or (generator is None and noise is None):
        raise ValueError("hp loss needs latent_fn (x -> latent) and a generator")
    return hessian_penalty(latent_fn, batch["x"], generator, signs=noise)


_matching_ = {
    "rc": compute_rc_loss,
    "kl": compute_kl_loss,
    "hp": compute_hp_loss,
    "mmd": compute_mmd_loss,
    "rcxyz": compute_rcxyz_loss,
    "vel": compute_vel_loss,
    "velxyz": compute_velxyz_loss,
}


def get_loss_function(ltype: str) -> Callable:
    return _matching_[ltype]


def get_loss_names():
    return list(_matching_)


def compute_losses(batch: Dict, lambdas: Dict[str, float],
                   generator: Optional[torch.Generator] = None,
                   latent_fn: Optional[Callable] = None,
                   noise: Optional[Dict[str, torch.Tensor]] = None):
    """The weighted mix over the losses of `lambdas`, in sorted order:
    (mixed, {ltype: value, 'mixed': mixed}). noise: draws by loss name in
    place of the generator's."""
    mixed = 0.0
    losses = {}
    for ltype, lam in sorted(lambdas.items()):
        val = get_loss_function(ltype)(batch, generator=generator, latent_fn=latent_fn,
                                       noise=(noise or {}).get(ltype))
        losses[ltype] = val
        mixed = mixed + lam * val
    losses["mixed"] = mixed
    return mixed, losses
