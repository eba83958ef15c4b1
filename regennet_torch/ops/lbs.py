"""Kinematic chain of the body model, joints-only fast path (counterpart of
part of regennet_tpu/ops/lbs.py).

Posed joint locations are rigid kinematics on the shaped rest skeleton:
pose blendshapes and vertex skinning never reach them. The chain is
composed level by level (joints grouped by tree depth), one batched
matmul per level. `vertices` and `extended_joints` are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from regennet_torch.ops.body_model import BodyModel


def shaped_rest_joints(model: BodyModel,
                       betas: Optional[torch.Tensor]) -> torch.Tensor:
    """Rest-pose joints [B, J, 3] (B = 1 when betas is None)."""
    v = model.v_template[None]
    if betas is not None:
        v = v + torch.einsum("vcn,bn->bvc", model.shapedirs, betas)
    return torch.einsum("jv,bvc->bjc", model.j_regressor, v)


def global_transforms(model: BodyModel, rotmats: torch.Tensor,
                      rest_joints: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compose local joint rotations [B, J, 3, 3] (index 0 = global orient)
    into world rotations [B, J, 3, 3] and posed joint positions [B, J, 3]."""
    B, J = rotmats.shape[:2]
    rest = rest_joints.expand(B, J, 3)
    parents = torch.tensor(model.parents, device=rotmats.device).clamp_min(0)
    bones = rest - rest[:, parents]  # offset from the parent joint
    # filled level by level, in place: a level reads only earlier levels
    R_all = torch.empty_like(rotmats)
    t_all = torch.empty_like(rest)
    R_all[:, 0], t_all[:, 0] = rotmats[:, 0], rest[:, 0]
    for joint_idx, parent_idx in model.levels:
        jidx = torch.tensor(joint_idx, device=rotmats.device)
        pidx = torch.tensor(parent_idx, device=rotmats.device)
        Rp = R_all[:, pidx]                         # [B, L, 3, 3]
        R_all[:, jidx] = Rp @ rotmats[:, jidx]
        t_all[:, jidx] = (Rp @ bones[:, jidx, :, None])[..., 0] + t_all[:, pidx]
    return R_all, t_all


def joints(model: BodyModel, rotmats: torch.Tensor,
           betas: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Posed joint locations [B, J, 3]."""
    _, t_glob = global_transforms(model, rotmats, shaped_rest_joints(model, betas))
    return t_glob
