"""Operations of one CMDM denoiser forward, counted from its shapes (a
port-shaped rewrite of scripts/flops_handcount.py's `hand_count` at commit
b14d20cb6bbaa9fb4189ca13e12634674eb6d23e, which counted the JAX bench's
batch 128 bf16 forward).

A matrix product [m, k] x [k, n] counts 2 m k n. Counted: every dense
product, the timestep MLP, and the attention's two products over the
(query, key) pairs its mask needs (T (T + 1) / 2 causal, T^2 not).
Not counted: LayerNorm, softmax, activations, dropout, the loss and the
joint decode, the CLIP text tower. In sampling the actor's half of the
fused input projection is loop-invariant, so a denoiser step counts the
pose half alone; in training every projection counts. The single-token
cross-attention reads v(memory) only: its v projection counts on one
token per row, and its output projection on one token per row when
sampling and on every query in training (the weight dropout makes the
queries differ).
"""

from __future__ import annotations

PEAK_F32 = 67e12  # H100 SXM float32 off the tensor cores, dense (NVIDIA's data sheet)


def mm(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


def denoiser_forward(cfg: dict, rows: int, train: bool) -> int:
    """Operations of one forward over `rows` sequences of the config's
    shapes (`arch`, `layers`, `latent_dim`, `ff_size`, `num_frames`,
    `njoints`, `nfeats`, `cond_mode`)."""
    T, D, FF, L = cfg["num_frames"], cfg["latent_dim"], cfg["ff_size"], cfg["layers"]
    f_in = cfg["njoints"] * cfg["nfeats"]
    frames = rows * T
    total = mm(frames, f_in, D) + mm(rows, D, D) * 2 + mm(frames, D, f_in)
    if train:
        total += mm(frames, f_in, D) + mm(frames, 2 * D, D)
    if cfg["cond_mode"] == "text":
        total += mm(rows, 512, D)
    decoder = cfg["arch"] in ("online", "trans_dec")
    if decoder:
        tokens, pairs = T, T * (T + 1) // 2
    else:
        tokens = T + 1
        pairs = tokens * tokens
    n = rows * tokens
    layer = mm(n, D, 3 * D) + 2 * 2 * rows * pairs * D + mm(n, D, D) + mm(n, D, FF) + mm(n, FF, D)
    if decoder:
        layer += mm(rows, D, D) + (mm(frames, D, D) if train else mm(rows, D, D))
    return total + L * layer


def train_step(cfg: dict, rows: int) -> int:
    """Forward and backward of one optimizer step: three times the
    training forward (no recompute)."""
    return 3 * denoiser_forward(cfg, rows, train=True)
