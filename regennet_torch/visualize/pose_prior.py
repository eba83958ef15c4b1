"""SMPLify pose priors: the GMM max-mixture prior and the knee/elbow angle
prior (the port's copy of regennet_tpu/visualize/pose_prior.py).

The mixture negative log-likelihood is the min over components of half
the Mahalanobis quadratic minus the log of the normalised mixture weight,
computed as one batched einsum. The licensed `gmm_08.pkl` (trained on CMU
mocap) loads when a path is given; otherwise `synthetic_gmm_prior` builds
a rest-pose-centred mixture so the fit and its tests run without licensed
assets.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class GMMPrior(NamedTuple):
    """Mixture parameters over flattened axis-angle body pose (f32 tensors).

    means: [M, D]; precisions: [M, D, D]; nll_weights: [M], the weights
    over (2 pi)^(D/2) sqrt(det) / min sqrt(det)."""

    means: torch.Tensor
    precisions: torch.Tensor
    nll_weights: torch.Tensor

    @property
    def dim(self) -> int:
        return int(self.means.shape[-1])

    def to(self, device) -> "GMMPrior":
        return GMMPrior(*(t.to(device) for t in self))


def _nll_weights(weights: np.ndarray, covs: np.ndarray, dim: int) -> np.ndarray:
    sqrdets = np.array([np.sqrt(np.linalg.det(c)) for c in covs])
    const = (2 * np.pi) ** (dim / 2.0)
    return np.asarray(weights / (const * (sqrdets / sqrdets.min())))


def gmm_prior_from_arrays(means, covs, weights) -> GMMPrior:
    """The prior from raw mixture arrays (the pickle's content), inverted
    and normalised in float64, stored in f32."""
    means = np.asarray(means, np.float64)
    covs = np.asarray(covs, np.float64)
    weights = np.asarray(weights, np.float64)
    precisions = np.stack([np.linalg.inv(c) for c in covs])

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32))

    # weights below f32's smallest normal are 0, as XLA (which flushes
    # subnormals) reads them in the JAX package: such a component's -log w
    # is inf, so it never wins the min
    nll_weights = np.asarray(_nll_weights(weights, covs, means.shape[-1]), np.float32)
    nll_weights[nll_weights < np.finfo(np.float32).tiny] = 0.0
    return GMMPrior(means=f32(means), precisions=f32(precisions), nll_weights=f32(nll_weights))


def load_gmm_prior(path: str) -> GMMPrior:
    """gmm_08.pkl: a dict (means, covars, weights) or a legacy sklearn GMM."""
    import pickle

    with open(path, "rb") as f:
        gmm = pickle.load(f, encoding="latin1")
    if isinstance(gmm, dict):
        return gmm_prior_from_arrays(gmm["means"], gmm["covars"], gmm["weights"])
    return gmm_prior_from_arrays(gmm.means_, gmm.covars_, gmm.weights_)


def synthetic_gmm_prior(dim: int, num_gaussians: int = 8, seed: int = 0) -> GMMPrior:
    """A stand-in without licensed assets: Gaussians centred near the rest
    pose with graduated spreads, so far-from-rest poses pay a growing
    penalty while small bends stay cheap."""
    rng = np.random.default_rng(seed)
    means = 0.15 * rng.standard_normal((num_gaussians, dim))
    means[0] = 0.0  # one component exactly at rest
    sigmas = np.linspace(0.35, 0.9, num_gaussians)
    covs = np.stack([(s ** 2) * np.eye(dim) for s in sigmas])
    weights = np.full(num_gaussians, 1.0 / num_gaussians)
    return gmm_prior_from_arrays(means, covs, weights)


def gmm_neg_log_likelihood(prior: GMMPrior, pose: torch.Tensor) -> torch.Tensor:
    """Max-mixture NLL [B] of pose [B, D]: min over components of 0.5 quad
    - log(nll_weight)."""
    diff = pose[:, None, :] - prior.means[None]  # [B, M, D]
    prec_diff = torch.einsum("mij,bmj->bmi", prior.precisions, diff)
    quad = (prec_diff * diff).sum(dim=-1)  # [B, M]
    ll = 0.5 * quad - torch.log(prior.nll_weights)[None]
    return ll.min(dim=1).values


# axis-angle indices of the bending components of the knees (55, 58 with
# the global orient) and elbows (12, 15) in the 72-dim SMPL pose; the prior
# acts on the body pose without the global orient, hence the -3
ANGLE_PRIOR_IDXS = np.array([55 - 3, 58 - 3, 12 - 3, 15 - 3], np.int64)
ANGLE_PRIOR_SIGNS = np.array([1.0, -1.0, -1.0, -1.0], np.float32)


def angle_prior(body_pose: torch.Tensor) -> torch.Tensor:
    """exp(sign * angle)^2 [B, 4] of the knee and elbow bends of body_pose
    [B, >= 56]: anatomically impossible hyper-extension costs most."""
    signs = torch.tensor(ANGLE_PRIOR_SIGNS, device=body_pose.device)
    return torch.exp(body_pose[:, ANGLE_PRIOR_IDXS] * signs[None]) ** 2


def gmof(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """The Geman-McClure robustifier."""
    x2 = x ** 2
    s2 = sigma ** 2
    return (s2 * x2) / (s2 + x2)


def make_pose_prior_fn(kind: str, dim: int, gmm_path: Optional[str] = None,
                       pose_prior_weight: float = 4.78 * 1.5,
                       angle_prior_weight: float = 15.2, device=None):
    """`prior_fn(body_pose [B, D]) -> [B]` for fit_sequence. kind: 'gmm' (the
    max-mixture and angle priors at SMPLify's 3-D fitting weights), 'l2',
    or 'none'. The prior's tensors live on `device`."""
    if kind == "none":
        return lambda body_pose: torch.zeros(body_pose.shape[0], device=body_pose.device)
    if kind == "l2":
        w = pose_prior_weight ** 2
        return lambda body_pose: w * (body_pose ** 2).sum(dim=-1)
    if kind != "gmm":
        raise ValueError(f"unknown pose prior {kind!r}")
    prior = load_gmm_prior(gmm_path) if gmm_path else synthetic_gmm_prior(dim)
    if prior.dim != dim:
        raise ValueError(
            f"GMM prior dimension {prior.dim} does not match the body pose "
            f"dimension {dim} (SMPL body pose is 69 = 23 joints x 3)")
    prior = prior.to(device or "cpu")
    w_pose = pose_prior_weight ** 2
    w_angle = angle_prior_weight ** 2

    def prior_fn(body_pose):
        nll = w_pose * gmm_neg_log_likelihood(prior, body_pose)
        if dim > int(ANGLE_PRIOR_IDXS.max()):
            nll = nll + w_angle * angle_prior(body_pose).sum(dim=-1)
        return nll

    return prior_fn
