"""Training losses and the variational-bound terms (counterpart of
regennet_tpu/diffusion/losses.py): masked rotation MSE plus the geometric
and interaction terms, with the joints decoded by `rot2xyz`; the 'kl'
losses and a learned variance's 'vb' term; the bits-per-dim evaluation.

Every per-example term has shape [B]. Masking is a dense multiply; the
normalisers are those of `masked_l2` (sum of the mask times the product
of dims 1 and 2 of the compared tensors).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from regennet_torch.diffusion import gaussian
from regennet_torch.diffusion.schedule import DiffusionConfig, Schedule
from regennet_torch.ops import rotations as geo


def sum_flat(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dim=tuple(range(1, x.dim())))


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=tuple(range(1, x.dim())))


def masked_l2(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean squared error over unmasked entries: a, b [B, J, F, T] (or
    [B, J, T] with mask [B, 1, T]); the normaliser is sum(mask) times
    a.shape[1] * a.shape[2], for 3-D inputs too, as in the JAX package."""
    loss = (a - b) ** 2
    mask = mask.to(loss.dtype)
    n_entries = float(a.shape[1] * a.shape[2])
    return sum_flat(loss * mask) / (sum_flat(mask) * n_entries)


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL between two diagonal Gaussians, in nats (any argument may be a
    python float)."""
    logvar1, logvar2 = (torch.as_tensor(v) for v in (logvar1, logvar2))
    return 0.5 * (
        -1.0
        + logvar2
        - logvar1
        + torch.exp(logvar1 - logvar2)
        + ((mean1 - mean2) ** 2) * torch.exp(-logvar2)
    )


def _approx_standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x**3)))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """Log-likelihood of a Gaussian discretized into bins of 2/255."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = _approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = _approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_cdf_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta))


def vb_terms_bpd(sched, cfg, model_fn, x_start, x_t, t, cond, clip_denoised=True):
    """The variational-bound term of one timestep, in bits per dim: the
    decoder NLL at t = 0, else KL(q(x_{t-1} | x_t, x_0) || p(x_{t-1} | x_t))."""
    true_mean, _, true_logvar = gaussian.q_posterior_mean_variance(sched, x_start, x_t, t)
    out = gaussian.p_mean_variance(sched, cfg, model_fn, x_t, t, cond, clip_denoised)
    kl = normal_kl(true_mean, true_logvar, out["mean"], out["log_variance"])
    kl = mean_flat(kl) / math.log(2.0)
    decoder_nll = -discretized_gaussian_log_likelihood(
        x_start, means=out["mean"], log_scales=0.5 * out["log_variance"])
    decoder_nll = mean_flat(decoder_nll) / math.log(2.0)
    return {"output": torch.where(t == 0, decoder_nll, kl),
            "pred_xstart": out["pred_xstart"]}


def prior_bpd(sched, x_start):
    """KL(q(x_T | x_0) || N(0, I)) in bits per dim."""
    t = torch.full((x_start.shape[0],), sched.num_timesteps - 1, dtype=torch.long,
                   device=x_start.device)
    mean, _, log_variance = gaussian.q_mean_variance(sched, x_start, t)
    return mean_flat(normal_kl(mean, log_variance, 0.0, 0.0)) / math.log(2.0)


@torch.no_grad()
def calc_bpd_loop(sched, cfg, model_fn, x_start, cond, clip_denoised=True,
                  generator: Optional[torch.Generator] = None, step_noise=None):
    """The whole variational bound, one model call per timestep from
    t = T-1 down to 0. Returns total_bpd [N], prior_bpd [N], and vb,
    xstart_mse and mse as [N, T] tensors whose column 0 is t = T-1.
    step_noise: the q_sample draw of each step in loop order, else drawn
    from `generator`."""
    B = x_start.shape[0]
    steps = None if step_noise is None else iter(step_noise)
    vb, xstart_mse, mse = [], [], []
    for i in range(sched.num_timesteps - 1, -1, -1):
        if steps is None:
            noise = torch.randn(x_start.shape, generator=generator,
                                device=x_start.device, dtype=x_start.dtype)
        else:
            noise = next(steps).to(x_start.device, x_start.dtype)
        t = torch.full((B,), i, dtype=torch.long, device=x_start.device)
        x_t = gaussian.q_sample(sched, x_start, t, noise)
        out = vb_terms_bpd(sched, cfg, model_fn, x_start, x_t, t, cond, clip_denoised)
        vb.append(out["output"])
        xstart_mse.append(mean_flat((out["pred_xstart"] - x_start) ** 2))
        eps = gaussian.predict_eps_from_xstart(sched, x_t, t, out["pred_xstart"])
        mse.append(mean_flat((eps - noise) ** 2))
    vb, xstart_mse, mse = (torch.stack(v, dim=1) for v in (vb, xstart_mse, mse))
    prior = prior_bpd(sched, x_start)
    return {"total_bpd": vb.sum(dim=1) + prior, "prior_bpd": prior, "vb": vb,
            "xstart_mse": xstart_mse, "mse": mse}


def _fc_loss(cfg: DiffusionConfig, target_xyz, output_xyz, mask):
    """Foot contact: penalise predicted foot velocity where the target's
    feet are static."""
    l_ankle, r_ankle, l_foot, r_foot = 7, 8, 10, 11
    idx = [l_ankle, l_foot, r_ankle, r_foot]
    gt = target_xyz[:, idx]  # [B, 4, 3P, T]
    gt_vel = torch.linalg.vector_norm(gt[..., 1:] - gt[..., :-1], dim=2)
    fc_mask = (gt_vel <= cfg.vel_threshold)[:, :, None, :]
    pred = output_xyz[:, idx]
    pred_vel = (pred[..., 1:] - pred[..., :-1]) * fc_mask.to(pred.dtype)
    return masked_l2(pred_vel, torch.zeros_like(pred_vel), mask[..., 1:])


def _orient_loss(target, output, cmotion, mask):
    """Relative global orientation of the reactor to the actor."""

    def rel_angle(ref_rm, rm):
        rel = torch.einsum("...ij,...ik->...jk", ref_rm, rm)  # ref^T @ rm
        return torch.linalg.vector_norm(geo.matrix_to_axis_angle(rel), dim=-1)

    def to_rm(x_orient):  # [B, 1, 6, T] -> [B, 1, T, 3, 3]
        return geo.rotation_6d_to_matrix(x_orient.movedim(-1, -2))

    cm_rm = to_rm(cmotion[:, 0:1])
    gt_diff = rel_angle(cm_rm, to_rm(target[:, 0:1]))
    out_diff = rel_angle(cm_rm, to_rm(output[:, 0:1]))
    return masked_l2(gt_diff, out_diff, mask[:, 0])


def training_losses(
    sched: Schedule,
    cfg: DiffusionConfig,
    model_fn: gaussian.ModelFn,
    x_start: torch.Tensor,
    t: torch.Tensor,
    cond: Dict,
    noise: torch.Tensor,
    rot2xyz_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """All loss terms of one batch of timesteps t [B]; each term is [B].

    noise: the N(0, 1) draw of q_sample, shaped like x_start.
    rot2xyz_fn(x) decodes [B, J, F, T] pose tensors to joints. 'kl' and
    'rescaled_kl' return the variational-bound term alone; a learned
    variance adds the 'vb' term, whose gradient reaches the variance
    channels only."""
    mask = cond["mask"]  # [B, 1, 1, T]
    x_t = gaussian.q_sample(sched, x_start, t, noise)

    if cfg.loss_type in ("kl", "rescaled_kl"):
        loss = vb_terms_bpd(sched, cfg, model_fn, x_start, x_t, t, cond,
                            clip_denoised=False)["output"]
        if cfg.loss_type == "rescaled_kl":
            loss = loss * sched.num_timesteps
        return {"loss": loss}

    model_output = model_fn(x_t, gaussian.scale_timesteps(sched, cfg, t), cond)
    vb = None
    if cfg.model_var_type in ("learned", "learned_range"):
        C = x_t.shape[1]
        model_output, model_var_values = model_output[:, :C], model_output[:, C:]
        frozen = torch.cat([model_output.detach(), model_var_values], dim=1)
        vb = vb_terms_bpd(sched, cfg, lambda *a, **k: frozen, x_start, x_t, t, cond,
                          clip_denoised=False)["output"]
        if cfg.loss_type == "rescaled_mse":
            vb = vb * (sched.num_timesteps / 1000.0)

    if cfg.model_mean_type == "previous_x":
        target = gaussian.q_posterior_mean_variance(sched, x_start, x_t, t)[0]
    elif cfg.model_mean_type == "start_x":
        target = x_start
    else:
        target = noise

    terms: Dict[str, torch.Tensor] = {"rot_mse": masked_l2(target, model_output, mask)}
    if vb is not None:
        terms["vb"] = vb

    target_xyz = output_xyz = None
    if cfg.lambda_rcxyz or cfg.lambda_vel_rcxyz or cfg.lambda_fc or cfg.lambda_body:
        if rot2xyz_fn is None:
            raise ValueError("geometric losses need a rot2xyz decoder")
        target_xyz = rot2xyz_fn(target)
        output_xyz = rot2xyz_fn(model_output)

    if cfg.lambda_rcxyz > 0:
        terms["rcxyz_mse"] = masked_l2(target_xyz, output_xyz, mask)

    if cfg.lambda_vel_rcxyz > 0 and cfg.data_rep == "rot6d":
        t_vel = target_xyz[..., 1:] - target_xyz[..., :-1]
        o_vel = output_xyz[..., 1:] - output_xyz[..., :-1]
        terms["vel_xyz_mse"] = masked_l2(t_vel, o_vel, mask[..., 1:])

    if cfg.lambda_fc > 0:
        if cfg.data_rep == "rot6d":
            terms["fc"] = _fc_loss(cfg, target_xyz, output_xyz, mask)
        elif cfg.data_rep == "xyz":
            terms["fc"] = _fc_loss(cfg, target, model_output, mask)

    if cfg.lambda_vel > 0:
        target_vel = target[..., 1:] - target[..., :-1]
        output_vel = model_output[..., 1:] - model_output[..., :-1]
        # the last "joint" row is the root translation channel
        terms["vel_mse"] = masked_l2(target_vel[:, :-1], output_vel[:, :-1],
                                     mask[..., 1:])

    if cfg.lambda_orient or cfg.lambda_body or cfg.lambda_transl:
        cmotion = cond["cmotion"]
        mask3 = mask[:, 0]  # [B, 1, T]
        if cfg.lambda_orient > 0:
            terms["orient"] = _orient_loss(target, model_output, cmotion, mask)
        if cfg.lambda_body > 0:
            cmotion_xyz = rot2xyz_fn(cmotion)
            gt_diff = torch.linalg.vector_norm(cmotion_xyz - target_xyz, dim=2)
            out_diff = torch.linalg.vector_norm(cmotion_xyz - output_xyz, dim=2)
            terms["body"] = masked_l2(gt_diff, out_diff, mask3)
        if cfg.lambda_transl > 0:
            last = x_start.shape[1] - 1  # the translation row
            cm_tr = cmotion[:, last:, 0:3]
            gt_tr = torch.linalg.vector_norm(cm_tr - target[:, last:, 0:3], dim=2)
            out_tr = torch.linalg.vector_norm(cm_tr - model_output[:, last:, 0:3], dim=2)
            terms["transl"] = masked_l2(gt_tr, out_tr, mask3)

    loss = terms["rot_mse"]
    if vb is not None:
        loss = loss + vb
    for name, lam in (("vel_mse", cfg.lambda_vel), ("rcxyz_mse", cfg.lambda_rcxyz),
                      ("fc", cfg.lambda_fc), ("orient", cfg.lambda_orient),
                      ("body", cfg.lambda_body), ("transl", cfg.lambda_transl)):
        if name in terms:
            loss = loss + lam * terms[name]
    terms["loss"] = loss
    return terms
