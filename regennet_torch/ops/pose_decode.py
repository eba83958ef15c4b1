"""Pose representation -> 3-D joints or vertices (counterpart of
regennet_tpu/ops/pose_decode.py).

Contract as in the JAX package: x [B, J(+1 translation row), F * persons, T]
-> xyz [B, K, 3 * persons, T], for pose_rep 'rot6d', 'rotvec', 'rotquat'
or 'rotmat' ('xyz' passes through). Dense computation times the frame
mask; persons are decoded one after the other. The joint sets: 'smplx' and
'smpl' from the vertex-free kinematic chain; 'vibe', 'a2m' and 'a2mpl'
from the SMPL wrapper's extended joints; 'vertices', the posed mesh.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import numpy as np
import torch

from regennet_torch.ops import lbs
from regennet_torch.ops import rotations as geo
from regennet_torch.ops.body_model import BodyModel

JOINTSTYPE_ROOT = {"a2m": 0, "smpl": 0, "smplx": 0, "a2mpl": 0, "vibe": 8}
JOINTSTYPES = (*JOINTSTYPE_ROOT, "vertices")

# joint sets taken from the SMPL wrapper's extended 54-joint output
_VIBE_JOINT_MAP = [
    24, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7, 25, 26, 27, 28, 29,
    30, 31, 32, 33, 34, 8, 5, 45, 46, 4, 7, 21, 19, 17, 16, 18, 20, 47, 48,
    49, 50, 51, 52, 53, 24, 26, 25, 28, 27,
]
_A2M_FROM_VIBE = [8, 1, 2, 3, 4, 5, 6, 7, 0, 9, 10, 11, 12, 13, 14, 21, 24, 38]


def _joint_indexes(jointstype: str) -> List[int]:
    vibe = np.asarray(_VIBE_JOINT_MAP)
    if jointstype == "vibe":
        return vibe.tolist()
    a2m = vibe[np.asarray(_A2M_FROM_VIBE)]
    if jointstype == "a2m":
        return a2m.tolist()
    return np.unique(np.concatenate([np.arange(24), a2m])).tolist()  # a2mpl


def _rotations_to_matrix(x_rot: torch.Tensor, pose_rep: str) -> torch.Tensor:
    """[..., J, F] -> [..., J, 3, 3]."""
    if pose_rep == "rotvec":
        return geo.axis_angle_to_matrix(x_rot)
    if pose_rep == "rotquat":
        return geo.quaternion_to_matrix(x_rot)
    if pose_rep == "rot6d":
        return geo.rotation_6d_to_matrix(x_rot)
    if pose_rep == "rotmat":
        return x_rot.reshape(*x_rot.shape[:-1], 3, 3)
    raise NotImplementedError(f"no geometry for pose_rep={pose_rep}")


def _decode_one_person(model, x, mask, pose_rep, translation, glob, jointstype,
                       vertstrans, betas, beta, glob_rot, single_person):
    B, V, F, T = x.shape
    if translation:
        x_transl = x[:, -1, :3, :]  # [B, 3, T]
        x_rot = x[:, :-1]
    else:
        x_transl = None
        x_rot = x
    # [B, V, F, T] -> [B*T, J, F]
    x_rot = x_rot.permute(0, 3, 1, 2).reshape(B * T, x_rot.shape[1], F)
    rotmats = _rotations_to_matrix(x_rot, pose_rep)
    if not glob:
        if glob_rot is None:
            raise TypeError("You must specify global rotation if glob is False")
        fixed = geo.axis_angle_to_matrix(
            torch.as_tensor(glob_rot, dtype=x.dtype, device=x.device)
        )
        rotmats = torch.cat([fixed.expand(B * T, 1, 3, 3), rotmats], dim=1)

    if betas is None and beta != 0:
        betas = torch.zeros((B * T, model.num_betas), dtype=x.dtype, device=x.device)
        betas[:, 1] = beta

    if jointstype == "vertices":
        pts = lbs.vertices(model, rotmats, betas)
    elif jointstype in ("smpl", "smplx"):
        pts = lbs.joints(model, rotmats, betas)
        if jointstype == "smpl":
            pts = pts[:, :24]
    else:
        pts = lbs.extended_joints(model, rotmats, betas)[:, _joint_indexes(jointstype)]
    K = pts.shape[1]
    xyz = pts.reshape(B, T, K, 3)
    if mask is not None:
        xyz = xyz * mask[:, :, None, None].to(xyz.dtype)
    xyz = xyz.permute(0, 2, 3, 1)  # [B, K, 3, T]
    if jointstype != "vertices":
        root = JOINTSTYPE_ROOT[jointstype]
        xyz = xyz - xyz[:, root:root + 1]
    if translation and vertstrans:
        if single_person:
            # re-base translations to the first frame (single person only)
            x_transl = x_transl - x_transl[:, :, :1]
        xyz = xyz + x_transl[:, None, :, :]
    return xyz


def rot2xyz(x: torch.Tensor, mask: Optional[torch.Tensor], model: BodyModel,
            pose_rep: str = "rot6d", translation: bool = True,
            glob: bool = True, jointstype: str = "smplx",
            vertstrans: bool = False, betas: Optional[torch.Tensor] = None,
            beta: float = 0.0, glob_rot=None, num_person: int = 1
            ) -> torch.Tensor:
    """Decode packed pose tensors to 3-D joint trajectories.

    x:    [B, V, F * num_person, T]; per person the last row of V is the
          root translation when `translation` (3 of F channels used).
    mask: [B, T] boolean validity, or None for all-valid.
    Returns [B, K, 3 * num_person, T]."""
    if pose_rep == "xyz":
        return x
    if jointstype not in JOINTSTYPES:
        raise NotImplementedError("This jointstype is not implemented.")
    model = model.to(x.device)
    F = x.shape[2] // num_person
    persons = [
        _decode_one_person(
            model, x[:, :, p * F:(p + 1) * F, :], mask, pose_rep, translation,
            glob, jointstype, vertstrans, betas, beta, glob_rot,
            single_person=(num_person == 1),
        )
        for p in range(num_person)
    ]
    return torch.cat(persons, dim=2)


def make_rot2xyz(model: BodyModel, **static_kwargs):
    """Bind a body model and a decode configuration into a callable."""

    @functools.wraps(rot2xyz)
    def fn(x, mask=None, **overrides):
        kw = dict(static_kwargs)
        kw.update(overrides)
        return rot2xyz(x, mask, model, **kw)

    return fn
