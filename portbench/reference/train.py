"""The plain training step of the CMDM, followed from the seed: the
uniform timestep draw, q_sample, the denoiser's training forward with its
dropout, the x0 loss terms (for two-person Chi3D: the velocity, relative
orientation, body-distance and translation terms through a joint decode
of the body model's kinematic chain), autograd, AdamW as optax builds it
and the EMA. Imports nothing of the program.

`follow(...)` runs the first `steps` optimizer steps of a training run
on the batches the benchmark handed to the program and returns what the
judge compares: each step's loss, the first gradient per leaf, and the
change of every parameter and of its EMA after the steps asked for.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from . import model, numerics

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8

# the SMPL-X kinematic tree: each joint's parent (the root's is -1)
SMPLX_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 15, 15, 15,
     20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,
     21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53])


def synthetic_rest_joints(seed: int = 0) -> np.ndarray:
    """Rest joints [55, 3] of the deterministic stand-in SMPL-X body that
    the program decodes with when no licensed model file is present:
    bones drawn from normal(0.12) by numpy's default_rng(seed), added
    down the tree."""
    rng = np.random.default_rng(seed)
    offsets = rng.normal(scale=0.12, size=(len(SMPLX_PARENTS), 3))
    joints = np.zeros((len(SMPLX_PARENTS), 3))
    for j in range(1, len(SMPLX_PARENTS)):
        joints[j] = joints[SMPLX_PARENTS[j]] + offsets[j]
    return joints.astype(np.float32)


def rot6d_to_matrix(d6):
    """(..., 6) -> (..., 3, 3): Gram-Schmidt, the rows the basis."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.vector_norm(a1, dim=-1, keepdim=True).clamp_min(1e-8)
    a2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = a2 / torch.linalg.vector_norm(a2, dim=-1, keepdim=True).clamp_min(1e-8)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], dim=-2)


def rotation_angle(r):
    """The angle of rotation matrices (..., 3, 3), by atan2 of the axial
    vector's length and (trace - 1) / 2."""
    axial = torch.stack([r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0],
                         r[..., 1, 0] - r[..., 0, 1]], dim=-1)
    cos = (r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2] - 1.0) / 2.0
    return torch.atan2(torch.linalg.vector_norm(axial, dim=-1) / 2.0, cos)


def decode_joints(x, rest: torch.Tensor, precision: str):
    """Pose tensors [B, 56, 6, T] (55 rot6d joints, the translation row
    last) -> root-relative joints [B, 55, 3, T] by forward kinematics on
    the rest skeleton."""
    B, _, _, T = x.shape
    rot = rot6d_to_matrix(x[:, :-1].permute(0, 3, 1, 2))  # [B, T, 55, 3, 3]
    bones = rest - rest[np.maximum(SMPLX_PARENTS, 0)]
    R = [rot[:, :, 0]]
    pos = [rest[0].expand(B, T, 3)]
    for j in range(1, len(SMPLX_PARENTS)):
        p = int(SMPLX_PARENTS[j])
        R.append(numerics.matmul(R[p], rot[:, :, j], precision))
        pos.append(numerics.matmul(R[p], bones[j][:, None], precision)[..., 0] + pos[p])
    xyz = torch.stack(pos, dim=2)  # [B, T, 55, 3]
    xyz = xyz - xyz[:, :, :1]
    return xyz.permute(0, 2, 3, 1)


def masked_l2(a, b, mask):
    """Mean squared error over unmasked entries, normalised by the mask's
    sum times a.shape[1] * a.shape[2]."""
    loss = (a - b) ** 2 * mask.float()
    dims = tuple(range(1, a.dim()))
    return loss.sum(dims) / (mask.float().sum(dims) * float(a.shape[1] * a.shape[2]))


def loss_terms(cfg: dict, target, out, cond: dict, rest, precision: str):
    """The per-example loss [B] of the x0 prediction `out`."""
    mask = cond["mask"]
    loss = masked_l2(target, out, mask)
    lam = cfg["lambdas"]
    if not any(lam.values()):
        return loss
    vel_t = target[..., 1:] - target[..., :-1]
    vel_o = out[..., 1:] - out[..., :-1]
    terms = {"vel": masked_l2(vel_t[:, :-1], vel_o[:, :-1], mask[..., 1:])}
    cm = cond["cmotion"]
    ref = rot6d_to_matrix(cm[:, 0].movedim(-1, -2))
    angle_t = rotation_angle(ref.transpose(-1, -2) @ rot6d_to_matrix(target[:, 0].movedim(-1, -2)))
    angle_o = rotation_angle(ref.transpose(-1, -2) @ rot6d_to_matrix(out[:, 0].movedim(-1, -2)))
    terms["orient"] = masked_l2(angle_t[:, None], angle_o[:, None], mask[:, 0])
    xyz_t, xyz_o, xyz_c = (decode_joints(v, rest, precision) for v in (target, out, cm))
    terms["body"] = masked_l2(torch.linalg.vector_norm(xyz_c - xyz_t, dim=2),
                              torch.linalg.vector_norm(xyz_c - xyz_o, dim=2), mask[:, 0])
    last = target.shape[1] - 1
    tr = cm[:, last:, :3]
    terms["transl"] = masked_l2(torch.linalg.vector_norm(tr - target[:, last:, :3], dim=2),
                                torch.linalg.vector_norm(tr - out[:, last:, :3], dim=2),
                                mask[:, 0])
    for name in ("vel", "orient", "body", "transl"):
        loss = loss + lam[name] * terms[name]
    return loss


def uniform_timesteps(rng: np.random.Generator, rows: int, steps: int) -> np.ndarray:
    """The uniform schedule sampler's draw: numpy's Generator.choice with
    equal probabilities."""
    p = np.ones([steps]) / steps
    return rng.choice(steps, size=(rows,), p=p)


def follow(weights: Dict[str, torch.Tensor], cfg: dict, batches: List[dict], seed: int,
           device, precision: str = "float32", keep: Sequence[int] = ()) -> dict:
    """The first len(batches) steps of a run seeded `seed` on `batches`
    (each {'motion', 'cond'} of device tensors, cond holding 'mask',
    'cmotion' and 'action' or 'text_emb').

    Returns {"loss": [per step], "grad": {leaf: first gradient},
    "at": {step: {"change": {leaf: parameter change}, "ema_change": {leaf:
    EMA change}}}} for each step in `keep` (and the last)."""
    numerics.pinned_f32()
    w = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
    ema = {k: v.detach().clone() for k, v in weights.items()}
    m = {k: torch.zeros_like(v) for k, v in w.items()}
    v2 = {k: torch.zeros_like(v) for k, v in w.items()}
    rest = torch.tensor(synthetic_rest_joints(), device=device, dtype=batches[0]["motion"].dtype)
    sched = numerics.cosine_schedule(cfg["diffusion_steps"], device)
    host_rng = np.random.default_rng(seed)
    draws = model.Draws(torch.Generator(device=device).manual_seed(seed), device)
    lr, wd, rate = cfg["lr"], cfg["weight_decay"], cfg["ema_rate"]
    out = {"loss": [], "grad": None, "at": {}}
    keep = set(keep) | {len(batches)}
    # the host draws every step's timesteps before the block
    ts = [uniform_timesteps(host_rng, b["motion"].shape[0], cfg["diffusion_steps"])
          for b in batches]
    for step, (batch, t_np) in enumerate(zip(batches, ts), start=1):
        x0 = batch["motion"]
        t = torch.as_tensor(t_np, device=device).long()
        noise = draws.randn(x0.shape)
        shape = (-1,) + (1,) * (x0.dim() - 1)
        x_t = (sched["sqrt_ab"][t].view(shape) * x0
               + sched["sqrt_one_minus_ab"][t].view(shape) * noise)
        pred = model.denoise(w, cfg, x_t, t, batch["cond"], draws, precision)
        loss = loss_terms(cfg, x0, pred, batch["cond"], rest, precision).mean()
        grads = torch.autograd.grad(loss, list(w.values()), allow_unused=True)
        out["loss"].append(float(loss.detach()))
        with torch.no_grad():
            grads = {k: torch.zeros_like(p) if g is None else g
                     for (k, p), g in zip(w.items(), grads)}
            if out["grad"] is None:
                out["grad"] = {k: g.clone() for k, g in grads.items()}
            for k, p in w.items():
                g = grads[k]
                p.mul_(1.0 - lr * wd)
                m[k].mul_(ADAM_BETAS[0]).add_(g, alpha=1.0 - ADAM_BETAS[0])
                v2[k].mul_(ADAM_BETAS[1]).addcmul_(g, g, value=1.0 - ADAM_BETAS[1])
                mhat = m[k] / (1.0 - ADAM_BETAS[0] ** step)
                vhat = v2[k] / (1.0 - ADAM_BETAS[1] ** step)
                p.sub_(lr * mhat / (vhat.sqrt() + ADAM_EPS))
                ema[k].mul_(rate).add_(p, alpha=1.0 - rate)
            if step in keep:
                out["at"][step] = {"change": {k: p.detach() - weights[k] for k, p in w.items()},
                                   "ema_change": {k: ema[k] - weights[k] for k in w}}
    return out
