"""Linear blend skinning of the body model (counterpart of
regennet_tpu/ops/lbs.py).

Posed joint locations are rigid kinematics on the shaped rest skeleton:
pose blendshapes and vertex skinning never reach them, so `joints` touches
no vertex. The chain is composed level by level (joints grouped by tree
depth), one batched matmul per level. `vertices` is full LBS (shape blend,
pose-corrective blend, skinning with the per-vertex transforms formed as
one [V, J] x [B, J, 12] matmul); `extended_joints` is the SMPL wrapper's
54-joint output, which needs the vertices.
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


def _pose_feature(rotmats: torch.Tensor) -> torch.Tensor:
    """(R_j - I) of every non-root joint, flattened: [B, 9 * (J - 1)]."""
    eye = torch.eye(3, dtype=rotmats.dtype, device=rotmats.device)
    return (rotmats[:, 1:] - eye).reshape(rotmats.shape[0], -1)


def vertices(model: BodyModel, rotmats: torch.Tensor,
             betas: Optional[torch.Tensor] = None,
             pose_blend: bool = True) -> torch.Tensor:
    """Posed mesh vertices [B, V, 3]."""
    v = model.v_template[None]
    if betas is not None:
        v = v + torch.einsum("vcn,bn->bvc", model.shapedirs, betas)
    rest = torch.einsum("jv,bvc->bjc", model.j_regressor, v)
    R_glob, t_glob = global_transforms(model, rotmats, rest)
    B, J = rotmats.shape[:2]
    v_posed = v.expand(B, *v.shape[1:])
    if pose_blend:
        v_posed = v_posed + (_pose_feature(rotmats) @ model.posedirs).reshape(B, -1, 3)
    # relative transforms: x -> R_glob (x - rest joint) + t_glob
    t_rel = t_glob - (R_glob @ rest.expand_as(t_glob)[..., None])[..., 0]
    A = torch.cat([R_glob, t_rel[..., None]], dim=-1)  # [B, J, 3, 4]
    T = (model.lbs_weights @ A.reshape(B, J, 12)).reshape(B, -1, 3, 4)  # [B, V, 3, 4]
    return (T[..., :3] @ v_posed[..., None])[..., 0] + T[..., 3]


def landmark_joints(model: BodyModel, verts: torch.Tensor) -> torch.Tensor:
    """The landmark vertices appended to the joint set (SMPL's extended output)."""
    return verts[:, list(model.landmark_vertex_ids)]


def extended_joints(model: BodyModel, rotmats: torch.Tensor,
                    betas: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The SMPL wrapper's 54-joint output: 24 kinematic joints, 21
    landmark vertices and the 9 joints of the extra regressor."""
    verts = vertices(model, rotmats, betas)
    parts = [joints(model, rotmats, betas), landmark_joints(model, verts)]
    if model.extra_joint_regressor is not None:
        parts.append(torch.einsum("kv,bvc->bkc", model.extra_joint_regressor, verts))
    return torch.cat(parts, dim=1)
