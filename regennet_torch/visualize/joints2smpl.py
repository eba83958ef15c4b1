"""Fit SMPL / SMPL-X pose parameters to 3-D joint trajectories (the port's
counterpart of regennet_tpu/visualize/joints2smpl.py), so that
xyz-representation outputs can be shown as meshes.

One Adam optimisation over the whole sequence (all frames at once, on the
body model's device) of

    Geman-McClure joint error    500^2 gmof(joints - target, 100)
  + GMM max-mixture pose prior   (visualize/pose_prior.py)
  + knee/elbow angle prior
  + w_smooth ||d theta / dt||^2  (temporal smoothness)
  + w_prior ||theta - rest||^2   (rot6d regulariser)

with theta = (rot6d per joint per frame, root translation per frame), the
joints from `lbs.joints` (no vertices) and the betas at the mean shape.
Adam as optax.adam steps (eps outside the square root, no weight decay).
The initial pose is the identity plus 0.01 noise from a torch.Generator
seeded by `seed`, or `init_pose6d`.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from regennet_torch.ops import lbs
from regennet_torch.ops import rotations as geo
from regennet_torch.ops.body_model import BodyModel
from regennet_torch.visualize.pose_prior import gmof, make_pose_prior_fn

# SMPLify's 3-D fitting weights
JOINT_LOSS_WEIGHT = 500.0
GMOF_SIGMA = 100.0


def fit_sequence(model: BodyModel, target_joints, num_steps: int = 300, lr: float = 0.05,
                 w_smooth: float = 1.0, w_prior: float = 1e-3,
                 init_pose6d: Optional[np.ndarray] = None, seed: int = 0,
                 pose_prior: str = "gmm", gmm_path: Optional[str] = None
                 ) -> Dict[str, np.ndarray]:
    """target_joints [T, K, 3], K <= model.num_joints. Returns {'pose6d' [T,
    J, 6], 'transl' [T, 3], 'losses' [num_steps]} as numpy."""
    device = model.v_template.device
    target = torch.as_tensor(np.asarray(target_joints), dtype=torch.float32, device=device)
    T, K, _ = target.shape
    J = model.num_joints
    # the priors act on the flattened axis-angle body pose (no global
    # orient); SMPL's body is 23 joints, 69 dims
    n_prior_joints = min(J - 1, 23)
    prior_fn = make_pose_prior_fn(pose_prior, 3 * n_prior_joints, gmm_path=gmm_path,
                                  device=device)
    # the 500^2-weighted sum scaled down by one constant: the optimum is kept
    scale = 1.0 / (JOINT_LOSS_WEIGHT ** 2 * K * 3)

    identity6d = torch.tensor([1.0, 0, 0, 0, 1.0, 0], device=device).expand(T, J, 6)
    if init_pose6d is not None:
        pose0 = torch.as_tensor(np.asarray(init_pose6d), dtype=torch.float32, device=device)
    else:
        gen = torch.Generator(device=device).manual_seed(int(seed))
        pose0 = identity6d + 0.01 * torch.randn((T, J, 6), generator=gen, device=device)
    pose6d = pose0.clone().requires_grad_(True)
    transl = torch.zeros((T, 3), device=device, requires_grad=True)

    def loss_fn():
        rotmats = geo.rotation_6d_to_matrix(pose6d)
        joints = lbs.joints(model, rotmats)  # [T, J, 3]
        joints = joints - joints[:, :1]  # root-centred, as the decoder gives them
        joints = joints[:, :K] + transl[:, None, :]
        data_term = JOINT_LOSS_WEIGHT ** 2 * gmof(joints - target, GMOF_SIGMA).sum(dim=(1, 2))
        body_aa = geo.matrix_to_axis_angle(rotmats[:, 1:1 + n_prior_joints]).reshape(T, -1)
        total = scale * torch.mean(data_term + prior_fn(body_aa))
        smooth = torch.mean((pose6d[1:] - pose6d[:-1]) ** 2) if T > 1 else 0.0
        reg = torch.mean((pose6d - identity6d) ** 2)
        return total + w_smooth * smooth + w_prior * reg

    optimizer = torch.optim.Adam([pose6d, transl], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for _ in range(num_steps):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
        optimizer.step()
        losses.append(loss.detach())
    losses = torch.stack(losses) if losses else torch.zeros(0)
    return {"pose6d": pose6d.detach().cpu().numpy(), "transl": transl.detach().cpu().numpy(),
            "losses": losses.cpu().numpy()}


def export_obj(vertices: np.ndarray, faces: Optional[np.ndarray], path: str):
    """Write one mesh (or point-cloud) frame as a Wavefront OBJ."""
    with open(path, "w") as f:
        for v in vertices:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        if faces is not None:
            for face in faces + 1:
                f.write(f"f {face[0]} {face[1]} {face[2]}\n")
