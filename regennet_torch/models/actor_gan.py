"""Conditional motion GAN, the adversarial baseline family (counterpart of
regennet_tpu/models/actor_gan.py).

A token-upsampling transformer generator and a projection-conditional
discriminator (logit = psi(f(x)) + <phi(y), f(x)>), both on the port's
post-LN `transformer.Encoder` with dropout 0 and the erf GELU; the noise,
frame and output embeddings, the label tables and psi are drawn from
normal(0, 0.02) by `random_init_`, the encoder by Flax's defaults.
Training uses hinge losses (`loss_mode="hinge"`) or a Wasserstein critic
with a gradient penalty (`"wgan-gp"`), with AdamW
optimisers (betas (beta1, 0.999), a discriminator lr multiplier) and the
structured noise family (`gen_noise`, host numpy).

Attention routes: a forward with a torch.Generator (every training
forward) takes the encoder's train route, so each self-attention runs B2
`fused_attention_btd_train` at rate 0, the attention kernel with a
backward; the penalty's `create_graph=True` gradient differentiates B2's
backward once more (`ops.attention._AttentionTrainBackward`). Generation
without a generator runs B1 `fused_attention_btd`. D runs at [B, T, D]
(the clip's frames), G at [B, NN, D] (the noise tokens). The penalty's
alpha comes from a torch.Generator, or from the caller.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from regennet_torch.models import initializers
from regennet_torch.models import transformer as tfm
from regennet_torch.train.training_loop import ADAM_EPS

GAN_INIT_STD = 0.02  # the reference's weights_init


def upsample_linear(h: torch.Tensor, num_frames: int) -> torch.Tensor:
    """[B, N, D] -> [B, num_frames, D] by linear interpolation at half-pixel
    centres, as jax.image.resize(method="linear") upsamples (edges
    included). Downsampling raises: there JAX antialiases and torch does
    not."""
    if h.shape[1] > num_frames:
        raise ValueError(
            f"{h.shape[1]} noise tokens exceed num_frames {num_frames}: the linear "
            "resize would downsample, where jax.image.resize antialiases")
    if h.shape[1] == num_frames:
        return h
    return F.interpolate(h.transpose(1, 2), size=num_frames, mode="linear",
                         align_corners=False).transpose(1, 2)


class Generator(nn.Module):
    """noise [B, Z, P, NN] (or [B, Z]) + label [B] -> motion [B, V, C, T].
    noise_dim is Z * P, the width of a noise token."""

    def __init__(self, njoints: int, nfeats: int, num_actions: int, num_frames: int,
                 noise_dim: int = 32, latent_dim: int = 256, ff_size: int = 512,
                 num_layers: int = 2, num_heads: int = 4):
        super().__init__()
        self.njoints, self.nfeats, self.num_frames = njoints, nfeats, num_frames
        self.latent_dim = latent_dim
        self.noise_embed = nn.Linear(noise_dim, latent_dim)
        self.label_embedding = nn.Parameter(torch.zeros(num_actions, latent_dim))
        self.encoder = tfm.Encoder(num_layers, latent_dim, num_heads, ff_size,
                                   tfm.gelu_exact, 0.0)
        self.output_head = nn.Linear(latent_dim, njoints * nfeats)

    def forward(self, noise, label, generator: Optional[torch.Generator] = None):
        B, NN = noise.shape[0], noise.shape[-1]
        tokens = noise.reshape(B, -1, NN).transpose(1, 2)  # [B, NN, Z*P]
        h = self.noise_embed(tokens) + self.label_embedding[label][:, None, :]
        h = h + tfm.sinusoidal_table(max(NN, 1), self.latent_dim).to(h.device)[None]
        h = upsample_linear(self.encoder(h, generator), self.num_frames)
        out = self.output_head(h).reshape(B, self.num_frames, self.njoints, self.nfeats)
        return out.permute(0, 2, 3, 1)  # [B, V, C, T]


class Discriminator(nn.Module):
    """Projection-conditional discriminator: motion [B, V, C, T] + label [B]
    -> logit [B]. The encoder's output is pooled over time in f32."""

    def __init__(self, njoints: int, nfeats: int, num_actions: int, latent_dim: int = 256,
                 ff_size: int = 512, num_layers: int = 2, num_heads: int = 4):
        super().__init__()
        self.latent_dim = latent_dim
        self.frame_embed = nn.Linear(njoints * nfeats, latent_dim)
        self.encoder = tfm.Encoder(num_layers, latent_dim, num_heads, ff_size,
                                   tfm.gelu_exact, 0.0)
        self.psi = nn.Linear(latent_dim, 1)
        self.label_projection = nn.Parameter(torch.zeros(num_actions, latent_dim))

    def forward(self, motion, label, generator: Optional[torch.Generator] = None):
        B, V, C, T = motion.shape
        x = motion.permute(0, 3, 1, 2).reshape(B, T, V * C)
        h = self.frame_embed(x)
        h = h + tfm.sinusoidal_table(T, self.latent_dim).to(h.device)[None]
        feat = self.encoder(h, generator).float().mean(dim=1)  # [B, D]
        proj = (self.label_projection[label] * feat).sum(dim=-1)
        return self.psi(feat)[:, 0] + proj


def random_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw a fresh Generator or Discriminator from `generator` as the
    JAX package's Flax modules are drawn (models/initializers): the
    embedding, head and label tables from normal(0.02) with zero biases,
    the transformer encoder by Flax's defaults."""
    return initializers.init_params_(model, generator, {
        name: GAN_INIT_STD for name in (
            "noise_embed.weight", "output_head.weight", "label_embedding",
            "frame_embed.weight", "psi.weight", "label_projection")})


def loss_hinge_dis(dis_fake, dis_real):
    """(mean relu(1 - D(real)), mean relu(1 + D(fake)))."""
    return torch.mean(F.relu(1.0 - dis_real)), torch.mean(F.relu(1.0 + dis_fake))


def loss_hinge_gen(dis_fake):
    return -torch.mean(dis_fake)


def _rbf_cov(scale: float, length: int, level: int = 2) -> np.ndarray:
    i = np.tile(np.arange(length), (length, 1))
    r = np.abs(i - i.T)
    return np.exp(-((r / scale) ** level))


def gen_noise(rng: np.random.Generator, N: int, NN: int, Z: int,
              lambda_noise: float = 1.0, mode: str = "independent",
              length_scale: float = 10.0, n_person: int = 1) -> np.ndarray:
    """The structured noise family, host numpy: independent ([N, Z, 1|2,
    NN]), the same draw twice (independent_3), constant over tokens,
    gaussian ([N, Z]), or Gaussian processes over the NN tokens with an RBF
    covariance per channel (gp: length scales growing with the channel;
    gp_single_scale; multi_gp: one draw per person)."""
    if mode == "independent":
        return rng.normal(size=(N, Z, 1, NN)).astype(np.float32)
    if mode == "independent_2":
        return rng.normal(size=(N, Z, 2, NN)).astype(np.float32)
    if mode == "independent_3":
        n = rng.normal(size=(N, Z, 1, NN)).astype(np.float32)
        return np.concatenate([n, n], axis=2)
    if mode == "constant":
        n = rng.normal(size=(N, Z, 1, 1)).astype(np.float32)
        return np.broadcast_to(n, (N, Z, 1, NN)).copy()
    if mode == "gaussian":
        return rng.normal(size=(N, Z)).astype(np.float32)
    if mode in ("gp", "multi_gp", "gp_single_scale"):
        persons = n_person if mode == "multi_gp" else 1
        noise = []
        for c in range(Z):
            scale = length_scale if mode == "gp_single_scale" else length_scale * (c + 1) / Z
            cov = _rbf_cov(scale, NN, level=2)
            noise.append(lambda_noise * rng.multivariate_normal(np.zeros(NN), cov,
                                                                size=(N, persons)))
        out = np.stack(noise, 1).astype(np.float32)
        assert out.shape == (N, Z, persons, NN)
        return out
    raise ValueError(f"noise mode {mode} not supported")


def noise_dim(noise_shape) -> int:
    """The width of a noise token, Z * P (1 for [N, Z] gaussian noise)."""
    return int(np.prod(noise_shape[1:-1]))


def make_optimizers(D: Discriminator, G: Generator, base_lr: float, d_lr_mult: float,
                    beta1: float, weight_decay: float):
    """(opt_d, opt_g): AdamW as optax.adamw builds it (eps 1e-8 added to
    sqrt(nu_hat), decoupled weight decay on every parameter), betas (beta1,
    0.999), D's lr times d_lr_mult."""
    opt_d = torch.optim.AdamW(D.parameters(), lr=base_lr * d_lr_mult, betas=(beta1, 0.999),
                              eps=ADAM_EPS, weight_decay=weight_decay)
    opt_g = torch.optim.AdamW(G.parameters(), lr=base_lr, betas=(beta1, 0.999),
                              eps=ADAM_EPS, weight_decay=weight_decay)
    return opt_d, opt_g


def gradient_penalty(D: Discriminator, real, fake, labels, alpha,
                     generator: Optional[torch.Generator] = None):
    """WGAN-GP: mean over the batch of (||dD/dx||_2 - 1)^2 at x = alpha real
    + (1 - alpha) fake, alpha [B, 1, 1, 1]. The input gradient keeps its
    graph (create_graph=True), so the penalty is differentiable in D's
    parameters; the norm keeps the 1e-12 under its square root."""
    inter = (alpha * real + (1.0 - alpha) * fake).detach().requires_grad_(True)
    grads, = torch.autograd.grad(D(inter, labels, generator).sum(), inter, create_graph=True)
    norms = torch.sqrt((grads.reshape(real.shape[0], -1) ** 2).sum(dim=1) + 1e-12)
    return torch.mean((norms - 1.0) ** 2)


def _apply_grads(loss, module: nn.Module, optimizer: torch.optim.Optimizer):
    """Gradients of loss in module's parameters alone, then one step."""
    params = list(module.parameters())
    grads = torch.autograd.grad(loss, params)
    for p, g in zip(params, grads):
        p.grad = g
    optimizer.step()


def make_gan_steps(G: Generator, D: Discriminator, opt_d, opt_g, loss_mode: str = "hinge",
                   lambda_gp: float = 10.0, generator: Optional[torch.Generator] = None):
    """(d_step, g_step), alternating GAN updates.

    d_step(x, y, noise, y_fake, alpha=None): D sees real (x, y) and G(noise,
    y_fake) with G frozen (generated without a graph, through B1); under
    wgan-gp the loss is -mean D(real) + mean D(fake) + lambda_gp times the
    penalty at alpha (drawn U[0, 1) from `generator` when None).
    g_step(noise, y_fake): G minimises -mean D(G(noise, y_fake)) with D
    frozen. Each returns its metrics as 0-d tensors. `generator` also
    seeds the training attention (at rate 0 its bits are unused)."""
    if loss_mode not in ("hinge", "wgan-gp"):
        raise ValueError(f"unknown loss_mode {loss_mode}")

    def d_step(x, y, noise, y_fake, alpha=None):
        with torch.no_grad():
            fake = G(noise, y_fake)
        dis_real = D(x, y, generator)
        dis_fake = D(fake, y_fake, generator)
        if loss_mode == "hinge":
            loss_real, loss_fake = loss_hinge_dis(dis_fake, dis_real)
            loss = loss_real + loss_fake
        else:
            loss_real, loss_fake = -torch.mean(dis_real), torch.mean(dis_fake)
            if alpha is None:
                alpha = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1), generator=generator,
                                   device=x.device, dtype=x.dtype)
            gp = gradient_penalty(D, x, fake, y_fake, alpha, generator)
            loss = loss_real + loss_fake + lambda_gp * gp
        _apply_grads(loss, D, opt_d)
        return {"lossD": loss.detach(), "lossD_real": loss_real.detach(),
                "lossD_fake": loss_fake.detach(),
                "accD_real": (dis_real > 0).float().mean().detach(),
                "accD_fake": (dis_fake < 0).float().mean().detach()}

    def g_step(noise, y_fake):
        dis_fake = D(G(noise, y_fake, generator), y_fake, generator)
        loss = loss_hinge_gen(dis_fake)  # -mean D(fake) in both modes
        _apply_grads(loss, G, opt_g)
        return {"lossG": loss.detach(), "accG": (dis_fake > 0).float().mean().detach()}

    return d_step, g_step


@torch.no_grad()
def gen_samples_per_class(G: Generator, num_classes: int, noise_cfg: Dict,
                          per_class: int = 100, seed: int = 0) -> np.ndarray:
    """[num_classes, per_class, V, C, T] motions, class by class, on G's
    device through B1; the noise from numpy's default_rng(seed)."""
    device = next(G.parameters()).device
    rng = np.random.default_rng(seed)
    out = []
    for c in range(num_classes):
        noise = torch.as_tensor(gen_noise(rng, per_class, **noise_cfg), device=device)
        label = torch.full((per_class,), c, dtype=torch.long, device=device)
        out.append(G(noise, label).cpu().numpy())
    return np.stack(out, 0)


def write_samples_h5(out_path: str, samples: np.ndarray) -> str:
    """gen_samples_per_class's array to an h5 file, one dataset per motion
    keyed 'A{class + 1:03d}_{index}'."""
    import h5py

    with h5py.File(out_path, "w") as f:
        for c in range(samples.shape[0]):
            for i in range(samples.shape[1]):
                f[f"A{c + 1:03d}_{i}"] = samples[c, i]
    return out_path
