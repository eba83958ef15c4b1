"""Pose representation -> 3-D joints (counterpart of
regennet_tpu/ops/pose_decode.py, joint sets 'smplx' and 'smpl').

Contract as in the JAX package: x [B, J(+1 translation row), F * persons, T]
-> xyz [B, K, 3 * persons, T], for pose_rep 'rot6d' ('xyz' passes through).
Dense computation times the frame mask; persons are decoded one after the
other. The other pose reps and the vertex and extended-landmark joint sets
('vertices', 'vibe', 'a2m', 'a2mpl') are not ported yet.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from regennet_torch.ops import lbs
from regennet_torch.ops import rotations as geo
from regennet_torch.ops.body_model import BodyModel

JOINTSTYPE_ROOT = {"smpl": 0, "smplx": 0}


def _decode_one_person(model, x, mask, translation, glob, jointstype,
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
    rotmats = geo.rotation_6d_to_matrix(x_rot)
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

    pts = lbs.joints(model, rotmats, betas)
    if jointstype == "smpl":
        pts = pts[:, :24]
    K = pts.shape[1]
    xyz = pts.reshape(B, T, K, 3)
    if mask is not None:
        xyz = xyz * mask[:, :, None, None].to(xyz.dtype)
    xyz = xyz.permute(0, 2, 3, 1)  # [B, K, 3, T]
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
    if pose_rep != "rot6d":
        raise NotImplementedError(f"pose_rep={pose_rep!r} is not ported yet")
    if jointstype not in JOINTSTYPE_ROOT:
        raise NotImplementedError(
            f"jointstype={jointstype!r} is not ported yet "
            f"(ported: {tuple(JOINTSTYPE_ROOT)})"
        )
    model = model.to(x.device)
    F = x.shape[2] // num_person
    persons = [
        _decode_one_person(
            model, x[:, :, p * F:(p + 1) * F, :], mask, translation,
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
