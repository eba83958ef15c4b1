#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (regennet_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):
  1. the card's name and power limit; build every CUDA kernel with nvcc;
  2. the sampling attention kernel against its plain PyTorch version on
     the card, at the sampler's shapes, with the kernel's, the plain
     version's and one PyTorch library call's times beside its bound;
  2b. the training attention kernels (the forward of attention_fwd.cu with
     dropout, the backward of attention_btd_train.cu) against autograd of
     their plain version fed the same dropout bits, and the backward
     against its own plain version, at the training shapes and at T 200
     (the backward's long-row route); the forward's dropout mask against
     dropout_bits on each route of the kernel (T 48, 128, 200), its keep
     fraction, bit-identical repeats and the adjoint identity; their times
     at the flagship training shape, f32 and bf16, by device time under
     torch.profiler with the wall of back-to-back calls beside it (the
     forward also at rate 0, the backward also by pass, row and column);
  2c. the [B, H, T, hd] attention kernel (fused_causal_attention, which no
     model path reaches) driven through its entry point at its path's
     shapes (those of the JAX package's tests, and B 2 and 128, T 16, 150,
     151, causal or not, f32 and bf16), each call against its plain
     version, and timed at bf16 [128, 4, 150, 128];
  2d. B1 and B2 at phase 10's f32 [64, 61, 512], non-causal, timed by
     device time under torch.profiler beside their plain versions, SDPA and
     the bounds;
  3. the sampling path, `regennet_torch.sample.cgenerate.main`, on the flagship
     online CMDM (8 layers, latent 512, 4 heads, ff 1024, Chi3D SMPL-X
     56x6, T=150, random weights from a seed) for three requests built from
     in-memory synthetic clips: f32 batch 16, the same with CFG 2.5, and
     bf16 batch 128, each 1000 DDPM steps, then smoothing and the joint
     decode; the kernels' launch counts over the three requests; one
     denoiser forward through the kernels against the same forward through
     the plain versions;
  4. the training path, `regennet_torch.train.train_mdm.main`, on the
     flagship training configuration (the same model with dropout 0.1,
     lambda_vel and the orient/body/transl terms on, AdamW lr 1e-4, EMA
     0.9999, f32 batch 64) for 40 steps in blocks of 8 into a temporary
     save_dir; the training kernels' launch counts; one training step
     through the kernels against the same step through the plain
     attention; the device time per kernel group of a few steps under
     torch.profiler; cgenerate (DDIM 50) from the trained checkpoint;
  5. the offline CMDM (trans_enc, the CLIs' default --arch) at the same
     width: train_mdm for 16 steps, a step through the kernels against the
     plain attention, a DDPM-1000 cgenerate request (f32 batch 16) from its
     checkpoint, one denoiser forward through the kernels against the
     plain one at f32 and bf16;
  6. the evaluation CLI, `regennet_torch.eval.eval_cmdm.main`, in debug
     mode on phase 4's checkpoint with CFG 2.5 and a random ST-GCN, on 128
     in-memory clips: metrics, results file, times, launches; then the
     ST-GCN on the card against a CPU copy;
  7. the gru and mlp trunks (cm_mode add) at the flagship width, each:
     train_mdm for 16 steps (f32 batch 64), a DDPM-1000 cgenerate request
     (f32 batch 16) from its checkpoint, one denoiser forward on the card
     against a CPU copy; the GRU's bias_hh r/z slices unchanged by training;
  8. the learning guard, scripts/capability_study_torch.py at its smokefit
     scale (a reduced ST-GCN trained on learnable clips, the online CMDM at
     latent 64 trained 800 steps, the eval_cmdm protocol for the trained,
     random-init and oracle rows), held to the six thresholds of
     tests/test_capability_smoke.py; before it, B1 and B2 at its shapes
     (head dim 16: [32, 24 and 25, 64], 4 heads) against their plain
     versions;
  9. bf16 training at the flagship width: train_mdm --compute_dtype
     bfloat16 on phase 4's configuration (40 steps) with the in-training
     evaluation (random ST-GCN, 32 samples) after each save; the state and
     checkpoint f32; a bf16 step through the kernels against the plain
     attention, at phase 2b's bf16 bound; the bf16 step's kernel groups
     and GEMM kernels under torch.profiler; a bf16 DDIM-50 request from
     the checkpoint; then the offline, gru and mlp trunks, 16 bf16 steps
     each, each with a bf16 forward of its trained weights on the card
     against the f32 forward of a CPU copy and its bf16 step time;
  10. the single-person a2m path at the a2m CMDM's width (the offline
     trunk, 8 layers, latent 512, SMPL 25x6, T 60: 61 tokens, non-causal):
     B1 (B 32, 64, 128) and B2 (B 64) there against their plain versions;
     synthetic HumanAct12 and UESTC archives written by the
     port's writers; train_mdm on HumanAct12 from --data_path (16 f32
     steps at batch 64, the legacy in-training evaluation after each save,
     a random GRU classifier); eval_humanact12_uestc (debug) on its
     checkpoint; an --unconstrained model (a 50-step schedule) through the
     unconstrained protocol (1000 samples, a random openpose ST-GCN saved as
     the port's .pt, a synthetic modi-struct array); UESTC (8 steps, then
     its evaluation route); compute_accuracy on a random full-width ST-GCN
     over in-memory Chi3D clips; the GRU classifier and the openpose ST-GCN
     on the card against CPU copies.
Each kernel's launches are read around each path that runs it (phases 3,
5, 6, 8, 9 and 10 for B1; 4, 5, 8, 9 and 10 for B2; 2c for B3) and summed
in the kernel line;
B1 has a second row at the evaluation's f32 batch-64 shape, with phase 6's
launches, and a third at the a2m evaluations' [64, 61, 512], with phase
10's; B2 has bf16 rows at [64, 150, 512], with phase 9's launches, and
f32 rows at [64, 61, 512], with phase 10's.
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.
Exits non-zero without CUDA, or without the regennet_torch package beside it.
"""

from __future__ import annotations

import functools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from argparse import Namespace
from pathlib import Path

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor / f32 CUDA-core
TOLERANCE = {"float32": 1e-5, "bfloat16": 2.0 ** -6}  # x max(1, max|plain|)
# the backward kernel against its own plain version, which rounds at the
# same points: at bf16 one ulp of the largest gradient (rounding flips only)
TOLERANCE_VJP = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# fused_causal_attention rounds where its plain version does: at bf16 one
# output ulp (2^-8 below 1), not the sampling kernel's 2^-6
TOLERANCE_B3 = {"float32": 1e-5, "bfloat16": 2.0 ** -8}
FLAGSHIP = dict(layers=8, latent_dim=512, heads=4, T=150, steps=1000)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3, blocks: int = 5) -> float:
    """Device time of fn() in ms: the mean over `iters` back-to-back calls,
    the median of `blocks` such runs (a host stall on this shared machine
    delays the launches of one run, not the median)."""
    import torch

    for _ in range(warmup):
        fn()
    means = []
    for _ in range(blocks):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / iters)
    return sorted(means)[blocks // 2]


def attention_bound_ms(B, T, D, H, dtype, causal, kv_len, tensors=4, products=2):
    """Least time for an attention function: its `tensors` [B, T, D]
    inputs and outputs moved once over the memory rate, or the `products`
    [pairs x D] matrix products this mask needs (2 flops per multiply-add)
    over the peak rate of the dtype; the larger, and which it is. The
    forward moves q, k, v, out (4) and computes QK^T and AV (2); the
    backward moves q, k, v, dO, dq, dk, dv (7) and computes QK^T, dO V^T,
    dV, dQ and dK (5)."""
    itemsize = 2 if dtype == "bfloat16" else 4
    bytes_moved = tensors * B * T * D * itemsize
    pairs = T * (T + 1) // 2 if causal else T * (kv_len or T)
    flops = 2 * products * B * pairs * D
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_attention_kernel(report, card):
    """Phase 2: the attention kernel against its plain version."""
    import torch
    import torch.nn.functional as F

    from regennet_torch.ops import attention

    D, H = FLAGSHIP["latent_dim"], FLAGSHIP["heads"]
    hd = D // H
    modes = [  # (dtype, causal, softmax_f32, kv_len offset)
        ("float32", True, False, None),
        ("bfloat16", True, False, None),
        ("bfloat16", True, True, None),
        ("float32", False, False, 10),
        ("bfloat16", False, False, 10),
    ]
    # the shapes the sampler gives the kernel: f32 batch 16 and 32 (CFG),
    # 64 (the evaluation's batch 32 under CFG), bf16 batch 16 and 32 (phase
    # 9's sample and in-training evaluation), 128 (and 256 under CFG), T =
    # 150 (Chi3D), 60 (NTU), 151 (the offline trunk)
    timed = {("float32", 16), ("float32", 32), ("float32", 64), ("bfloat16", 128),
             ("bfloat16", 256)}
    cases, worst = [], 0.0
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B in (16, 32, 64, 128, 256):
        for T in (150, 60, 151):
            for dtype, causal, softmax_f32, kv_off in modes:
                if B == 64 and (dtype != "float32" or T != 150):
                    continue
                if B in (16, 32) and dtype == "float32" and T != 150:
                    continue
                kv_len = None if kv_off is None else T - kv_off
                td = getattr(torch, dtype)
                packed = torch.randn(B, T, 3 * D, device="cuda", generator=gen).to(td)
                q, k, v = packed.split(D, dim=-1)  # strided views, as the model passes
                out = attention.fused_attention_btd(q, k, v, H, causal, softmax_f32, kv_len)
                ref = attention.attention_btd_reference(q, k, v, H, causal, softmax_f32, kv_len)
                torch.cuda.synchronize()
                err = float((out.float() - ref.float()).abs().max())
                tol = TOLERANCE[dtype] * max(1.0, float(ref.float().abs().max()))
                case = dict(B=B, T=T, dtype=dtype, causal=causal,
                            softmax_f32=softmax_f32, kv_len=kv_len,
                            max_abs_err=err, tolerance=tol)
                if not (err <= tol and math.isfinite(err)):
                    raise AssertionError(f"attention kernel disagrees: {case}")
                worst = max(worst, err)
                if (dtype, B) in timed and T == 150 and causal and not softmax_f32:
                    q4, k4, v4 = (x.view(B, T, H, hd).transpose(1, 2) for x in (q, k, v))
                    case["ms"] = time_ms(lambda: attention.fused_attention_btd(
                        q, k, v, H, causal, softmax_f32, kv_len))
                    case["plain_ms"] = time_ms(lambda: attention.attention_btd_reference(
                        q, k, v, H, causal, softmax_f32, kv_len), iters=5)
                    case["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
                        q4, k4, v4, is_causal=True))
                    case["bound_ms"], case["bound_by"] = attention_bound_ms(
                        B, T, D, H, dtype, causal, kv_len)
                    print(f"  attention {dtype} B={B} T={T} causal: kernel "
                          f"{case['ms']:.4f} ms, plain {case['plain_ms']:.4f} ms, "
                          f"sdpa {case['library_ms']:.4f} ms, bound "
                          f"{case['bound_ms']:.4f} ms ({case['bound_by']}), "
                          f"max_abs_err {err:.3g} [{card}]")
                cases.append(case)
    print(f"  attention kernel matches its plain version in {len(cases)} cases "
          f"(worst max_abs_err {worst:.3g}; tolerance 1e-5 f32, 2^-6 bf16, "
          "x max(1, max|plain|))")
    report["attention_cases"] = cases
    timed = {(c["dtype"], c["B"]): c for c in cases if "ms" in c}
    # the flagship sampling shape and the evaluation's (batch 32 under CFG)
    return worst, timed[("bfloat16", 128)], timed[("float32", 64)]


# B3's own entry point is its path (no model reaches it): the shapes the
# JAX package's tests give it (tests/test_pallas_attention.py), then B in
# {2, 128}, H = 4, hd = 128, T in {16, 150, 151}, causal and not, f32 and
# bf16; (B, H, T, hd, causal, dtype)
CAUSAL_PATH = [(1, 2, 24, 128, False, "float32"), (1, 2, 20, 128, True, "float32")] + [
    (B, 4, T, 128, causal, dtype) for B in (2, 128) for T in (16, 150, 151)
    for causal in (True, False) for dtype in ("float32", "bfloat16")]


def check_causal_attention(report, card):
    """Phase 2c: kernel B3, fused_causal_attention on [B, H, T, hd]: its
    entry point driven at every shape of CAUSAL_PATH with the launch count
    read around the loop, each call against its plain version at
    TOLERANCE_B3; then its time at bf16 [128, 4, 150, 128] causal beside
    the plain version's, SDPA's and the bound."""
    import torch
    import torch.nn.functional as F

    from regennet_torch.ops import attention

    fn = attention.fused_causal_attention
    gen = torch.Generator(device="cuda").manual_seed(5)

    def inputs(B, H, T, hd, dtype):
        return [torch.randn(B, H, T, hd, device="cuda", generator=gen).to(getattr(torch, dtype))
                for _ in range(3)]

    cases, worst = [], 0.0
    fn.launches = 0
    for B, H, T, hd, causal, dtype in CAUSAL_PATH:
        q, k, v = inputs(B, H, T, hd, dtype)
        out = fn(q, k, v, causal)
        ref = attention.attention_reference(q, k, v, causal)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = TOLERANCE_B3[dtype] * max(1.0, float(ref.float().abs().max()))
        case = dict(B=B, H=H, T=T, hd=hd, dtype=dtype, causal=causal,
                    max_abs_err=err, tolerance=tol)
        if out.shape != q.shape or out.dtype != q.dtype or not (
                err <= tol and math.isfinite(err)):
            raise AssertionError(f"fused_causal_attention gave {out.dtype} "
                                 f"{tuple(out.shape)} or disagrees: {case}")
        worst = max(worst, err)
        cases.append(case)
    launches = fn.launches
    print(f"  fused_causal_attention: {launches} launches over the {len(CAUSAL_PATH)} "
          f"calls of its path, each matching its plain version (worst max_abs_err "
          f"{worst:.3g}; tolerance 1e-5 f32, 2^-8 bf16, x max(1, max|plain|))")
    if launches != len(CAUSAL_PATH):
        raise AssertionError(f"fused_causal_attention launches {launches}")

    B, H, T, hd = 128, 4, 150, 128
    q, k, v = inputs(B, H, T, hd, "bfloat16")
    timing = dict(B=B, H=H, T=T, hd=hd, dtype="bfloat16", causal=True)
    timing["ms"] = time_ms(lambda: fn(q, k, v, True))
    timing["plain_ms"] = time_ms(lambda: attention.attention_reference(q, k, v, True), iters=5)
    timing["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    timing["bound_ms"], timing["bound_by"] = attention_bound_ms(
        B, T, H * hd, H, "bfloat16", True, None)
    print(f"  fused_causal_attention bf16 [{B}, {H}, {T}, {hd}] causal: kernel "
          f"{timing['ms']:.4f} ms, plain {timing['plain_ms']:.4f} ms, sdpa "
          f"{timing['library_ms']:.4f} ms, bound {timing['bound_ms']:.4f} ms "
          f"({timing['bound_by']}) [{card}]")
    report["causal_attention"] = dict(launches=launches, cases=cases, timing=timing)
    return launches, worst, timing


TRAIN = dict(batch=64, steps=40, steps_per_call=8, rate=0.1)


def _train_pair(B, T, dtype, causal, kv_len, rate, gen, softmax_f32=False, D=None, H=None):
    """The training kernels and autograd of their plain version on one
    packed [B, T, 3D] input (q, k, v as strided column views), with the
    same seeds and dO: (out, dq, dk, dv) of the kernels, the same of the
    plain version, and (dq, dk, dv) of the backward kernel's plain version
    (the TPU kernel's rounding points); the softmax in f32 if softmax_f32.
    D and H default to the flagship's."""
    import torch

    from regennet_torch.ops import attention

    D, H = D or FLAGSHIP["latent_dim"], H or FLAGSHIP["heads"]
    td = getattr(torch, dtype)
    packed = torch.randn(B, T, 3 * D, device="cuda", generator=gen).to(td)
    dout = torch.randn(B, T, D, device="cuda", generator=gen).to(td)
    seeds = torch.randint(-2 ** 31, 2 ** 31, (B, 2), device="cuda", generator=gen,
                          dtype=torch.int32)
    results = []
    for fn in (attention.fused_attention_btd_train,
               attention.attention_btd_train_reference):
        x = packed.clone().requires_grad_()
        q, k, v = x.split(D, dim=-1)
        out = fn(q, k, v, H, rate, seeds, causal, softmax_f32, kv_len)
        out.backward(dout)
        results.append((out.detach(), *x.grad.split(D, dim=-1)))
    q, k, v = packed.split(D, dim=-1)
    results.append(attention.attention_btd_train_backward_reference(
        q, k, v, dout, H, rate, seeds, causal, softmax_f32, kv_len))
    return results


# Phase 2b's (B, sequence lengths) in the order their inputs are drawn. The
# backward's row pass takes T 60 at 64 keys and 150, 151 at 160 on tensor
# cores, T 200 on its long-row route. T 200 is drawn last, so the cases
# before it keep their inputs: drawn after the B 8 cases, it gives the B 64
# bf16 cases other inputs, on some of which the plain backward, whose
# rounding points the kernel keeps, is itself more than 2^-6 from autograd
# (ROADMAP C; scripts/train_backward_errors.py --t200-inside shows it).
TRAIN_CASES = ((8, (150, 60, 151)), (TRAIN["batch"], (150, 60, 151)), (8, (200,)))


def train_cases(order=TRAIN_CASES):
    """Phase 2b's cases (B, T, causal, kv_len, dtype, rate) in drawing
    order: for each (B, lengths) of `order`, each T, causal or with a key
    mask of T - 10, f32 and bf16, dropout rate 0, 0.1 and 0.5."""
    for B, lengths in order:
        for T in lengths:
            for causal in (True, False):
                for dtype in ("float32", "bfloat16"):
                    for rate in (0.0, 0.1, 0.5):
                        yield B, T, causal, None if causal else T - 10, dtype, rate


def hold(what, err, tol):
    """Raises AssertionError unless err is finite and within tol."""
    if not (err <= tol and math.isfinite(err)):
        raise AssertionError(f"{what} disagrees: max_abs_err {err} > {tol}")


def max_abs_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def gradient_tolerance(autograd, plain_backward, dtype):
    """The tolerance of a backward kernel's gradient against autograd of
    the plain forward, and its terms. f32: TOLERANCE x max(1, max|autograd|)
    (terms None). bf16: the plain backward's own distance from autograd (it
    keeps the kernel's rounding points; autograd rounds the bf16 softmax's
    VJP at more of them) plus the kernel's allowance against the plain
    backward, TOLERANCE_VJP x max(1, max|plain backward|) (terms: the two)."""
    if dtype != "bfloat16":
        return TOLERANCE[dtype] * max(1.0, float(autograd.float().abs().max())), None
    own = max_abs_err(plain_backward, autograd)
    allowance = TOLERANCE_VJP[dtype] * max(1.0, float(plain_backward.float().abs().max()))
    return own + allowance, (own, allowance)


def hold_gradient(what, kernel, autograd, plain_backward, dtype):
    """The kernel's gradient against autograd within gradient_tolerance:
    raises AssertionError past it; returns (error, tolerance, terms)."""
    err = max_abs_err(kernel, autograd)
    tol, terms = gradient_tolerance(autograd, plain_backward, dtype)
    hold(what, err, tol)
    return err, tol, terms


def check_train_kernels(report, card):
    """Phase 2b: the training kernels against their plain version, the
    dropout mask, determinism, the adjoint identity, and timings. The
    output is held against the plain forward; the gradients against
    autograd of the plain forward (hold_gradient) and against the backward
    kernel's plain version, which rounds where the kernel does."""
    import torch

    cases = []
    by_dtype = {dtype: {"forward": 0.0, "backward": 0.0, "backward_vjp": 0.0}
                for dtype in ("float32", "bfloat16")}
    gen = torch.Generator(device="cuda").manual_seed(1)
    for B, T, causal, kv_len, dtype, rate in train_cases():
        worst = by_dtype[dtype]
        ours, plain, vjp = _train_pair(B, T, dtype, causal, kv_len, rate, gen)
        case = dict(B=B, T=T, dtype=dtype, causal=causal, kv_len=kv_len, rate=rate)

        def what(name):
            return f"training attention {name} ({case})"

        err = max_abs_err(ours[0], plain[0])
        hold(what("out"), err,
             TOLERANCE[dtype] * max(1.0, float(plain[0].float().abs().max())))
        case["out_err"] = err
        worst["forward"] = max(worst["forward"], err)
        for name, a, b, c in zip(("dq", "dk", "dv"), ours[1:], plain[1:], vjp):
            err, _, terms = hold_gradient(what(name), a, b, c, dtype)
            case[f"{name}_err"], case[f"{name}_terms"] = err, terms
            err_vjp = max_abs_err(a, c)
            hold(what(name + " against the plain backward"), err_vjp,
                 TOLERANCE_VJP[dtype] * max(1.0, float(c.float().abs().max())))
            case[f"{name}_vjp_err"] = err_vjp
            worst["backward"] = max(worst["backward"], err)
            worst["backward_vjp"] = max(worst["backward_vjp"], err_vjp)
        cases.append(case)
    worst = {k: max(w[k] for w in by_dtype.values()) for k in by_dtype["float32"]}
    print(f"  training attention kernels match their plain version in {len(cases)} "
          f"cases (worst max_abs_err forward {worst['forward']:.3g}; backward "
          f"{worst['backward']:.3g} against autograd of the plain forward, "
          f"{worst['backward_vjp']:.3g} against the plain backward; tolerance "
          "1e-5 f32 x max(1, max|plain|); bf16 forward 2^-6 x max(1, max|plain|), "
          "gradients 2^-7 x max(1, max|plain backward|) from the plain backward, "
          "and that plus the plain backward's own distance from autograd)")
    bf16 = [c for c in cases if c["dtype"] == "bfloat16"]
    for ref in ("", "_vjp"):
        top = max(bf16, key=lambda c: max(c[f"d{x}{ref}_err"] for x in "qkv"))
        terms = "" if ref else " (tolerance = the plain backward's distance + 2^-7 x " \
            "max(1, max|plain backward|): " + ", ".join(
                "d{} {:.3g} + {:.3g}".format(x, *top[f"d{x}_terms"]) for x in "qkv") + ")"
        print(f"    worst bf16 backward case against "
              f"{'the plain backward' if ref else 'autograd'}: "
              + ", ".join(f"d{x} {top[f'd{x}{ref}_err']:.3g}" for x in "qkv")
              + f" at B={top['B']} T={top['T']} causal={top['causal']} rate {top['rate']}"
              + terms)
    report["train_attention_cases"] = cases
    report["train_mask"] = check_train_mask()
    timing = {dtype: time_train_kernels(card, dtype) for dtype in ("float32", "bfloat16")}
    report["train_attention_timing"] = timing
    return by_dtype, timing


def train_mask(B, T, rate, seeds, causal):
    """The training forward's dropout mask [B, H, query, key], read from its
    output: with q = k = 0 every weight a query sees is 1 / (the keys it
    sees), and v one-hot in each head's columns (v[j, c] = 1 iff j = off +
    c) makes out[b, i, h, c] the weight of key off + c after dropout, or 0:
    one call for each hd keys."""
    import torch

    from regennet_torch.ops import attention

    D, H = FLAGSHIP["latent_dim"], FLAGSHIP["heads"]
    hd = D // H
    zeros = torch.zeros(B, T, D, device="cuda")
    keys, cols = torch.arange(T, device="cuda"), torch.arange(hd, device="cuda")
    kept = []
    for off in range(0, T, hd):
        onehot = (keys[:, None] == off + cols[None, :]).float()
        v = onehot.view(1, T, 1, hd).expand(B, T, H, hd).reshape(B, T, D).contiguous()
        with torch.no_grad():
            y = attention.fused_attention_btd_train(zeros, zeros, v, H, rate, seeds,
                                                    causal=causal)
        kept.append((y.view(B, T, H, hd) != 0).permute(0, 2, 1, 3)[..., :T - off])
    return torch.cat(kept, dim=-1)


def check_train_mask():
    """The forward kernel's dropout mask on each of its routes (T = 48: one
    chunk of 64 keys; 128: one chunk of 160; 200: chunks over three
    passes), causal or not, against dropout_bits >= threshold on the keys
    each query sees; its keep fraction; bit-identical repeats; and the
    adjoint identity of the backward."""
    import torch

    from regennet_torch.ops import attention

    B, D, H = TRAIN["batch"], FLAGSHIP["latent_dim"], FLAGSHIP["heads"]
    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {"masks": []}
    for rate in (0.1, 0.5):
        fracs = []
        for T in (48, 128, 200):
            for causal in (False, True):
                seeds = torch.randint(-2 ** 31, 2 ** 31, (B, 2), device="cuda",
                                      generator=gen, dtype=torch.int32)
                kept = train_mask(B, T, rate, seeds, causal)
                seen = torch.ones(T, T, dtype=torch.bool, device="cuda")
                if causal:
                    seen = seen.tril()
                bits = attention.dropout_bits(seeds, B, H, T)
                want = (bits >= attention.dropout_threshold(rate)) & seen
                frac = float(kept.sum()) / (B * H * float(seen.sum()))
                if abs(frac - (1 - rate)) > 0.005 or not torch.equal(kept, want):
                    raise AssertionError(
                        f"dropout mask at rate {rate}, T {T}, causal {causal}: keep "
                        f"fraction {frac} or its bits differ from dropout_bits")
                out["masks"].append(dict(rate=rate, T=T, causal=causal, keep_fraction=frac))
                fracs.append(f"{frac:.5f}")
        print(f"  rate {rate}: masks equal to dropout_bits at T 48, 128, 200, not causal "
              f"and causal; keep fractions {', '.join(fracs)} (within 0.005 of 1 - rate)")

    # bit-identical repeats (f32 and bf16) of forward and gradients
    for dtype in ("float32", "bfloat16"):
        first = _train_pair(B, 150, dtype, True, None, 0.1,
                            torch.Generator(device="cuda").manual_seed(3))[0]
        again = _train_pair(B, 150, dtype, True, None, 0.1,
                            torch.Generator(device="cuda").manual_seed(3))[0]
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise AssertionError(f"training kernels not deterministic at {dtype}")
    print("  a second call with the same seeds gives bit-identical outputs and "
          "gradients (f32 and bf16)")

    # out is linear in v: <dO, f(v + dv) - f(v)> = <dv, grad_v <dO, f(v)>>
    # holds only if the backward regenerates the forward's mask
    q, k, v, do, dv = (torch.randn(B, 150, D, device="cuda", generator=gen)
                       for _ in range(5))
    seeds = torch.randint(-2 ** 31, 2 ** 31, (B, 2), device="cuda", generator=gen,
                          dtype=torch.int32)

    def f(vv):
        return attention.fused_attention_btd_train(q, k, vv, H, 0.1, seeds)

    vl = v.clone().requires_grad_()
    (grad_v,) = torch.autograd.grad(f(vl), vl, do)
    with torch.no_grad():
        lin = float((do.double() * (f(v + dv).double() - f(v).double())).sum())
    adj = float((dv.double() * grad_v.double()).sum())
    rel = abs(lin - adj) / abs(adj)
    if not rel <= 1e-4:
        raise AssertionError(f"adjoint identity fails: {lin} vs {adj} (rel {rel})")
    print(f"  adjoint identity: {lin:.6g} vs {adj:.6g} (relative {rel:.2g} <= 1e-4)")
    out["adjoint_rel"] = rel
    return out


def _sdpa_backend(q4, k4, v4, rate, causal=True):
    """The first SDPA backend, in torch's order of preference, that takes
    these inputs with this dropout."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                F.scaled_dot_product_attention(q4, k4, v4, dropout_p=rate, is_causal=causal)
            return backend.name
        except RuntimeError:
            continue
    return "none"


def backward_pass_ms(fn, iters=20):
    """Device time per call of fn() in each pass of B2's backward kernel,
    {"rows": ms, "cols": ms}: the row pass (attention_train_rows, on either
    route) and the column pass (attention_train_cols), by kernel name
    (kernel_times)."""
    by_name = kernel_times(fn, iters)[1]
    found = {part: sum(ms for name, ms in by_name.items() if f"attention_train_{part}" in name)
             for part in ("rows", "cols")}
    if not all(found.values()):
        raise AssertionError(f"the profiler recorded no time for a backward pass: {found}")
    return found


def kernel_times(fn, iters=20):
    """Device time per call of fn() in ms, and per kernel name (the longest
    first): every CUDA kernel and memory operation of `iters` calls after a
    warm-up, summed under torch.profiler, over `iters`. The host's time
    between launches is not in it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = {evt.key: evt.device_time_total / 1e3 / iters for evt in prof.key_averages()
               if evt.device_type == torch.autograd.DeviceType.CUDA}
    total = sum(by_name.values())
    if not total > 0:
        raise AssertionError("the profiler recorded no device time")
    return total, dict(sorted(by_name.items(), key=lambda kv: -kv[1]))


def device_ms(fn, iters=20):
    """kernel_times' device time per call in ms."""
    return kernel_times(fn, iters)[0]


def time_train_kernels(card, dtype="float32", T=None, causal=True):
    """Forward and backward times at the flagship training shape (B = 64,
    T = 150, rate 0.1, causal; or T and causal as given) in `dtype`: the
    kernels, autograd of the
    plain version, and F.scaled_dot_product_attention with dropout (its own
    mask: a yardstick, not a check), each by device time under
    torch.profiler (`*_ms`) and by CUDA events around back-to-back calls,
    the host's launch time included (`*_wall_ms`); the device time of
    each backward pass, row and column; and the forward kernel at rate 0
    by CUDA events."""
    import warnings

    import torch
    import torch.nn.functional as F

    from regennet_torch.ops import attention

    B, D, H, rate = TRAIN["batch"], FLAGSHIP["latent_dim"], FLAGSHIP["heads"], TRAIN["rate"]
    T = T or FLAGSHIP["T"]
    hd = D // H
    td = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = (torch.randn(B, T, D, device="cuda", generator=gen).to(td).requires_grad_()
               for _ in range(3))
    dout = torch.randn(B, T, D, device="cuda", generator=gen).to(td)
    seeds = torch.randint(-2 ** 31, 2 ** 31, (B, 2), device="cuda", generator=gen,
                          dtype=torch.int32)
    q4, k4, v4 = (x.view(B, T, H, hd).transpose(1, 2) for x in (q, k, v))
    dout4 = dout.view(B, T, H, hd).transpose(1, 2)

    def kernel():
        return attention.fused_attention_btd_train(q, k, v, H, rate, seeds, causal)

    def plain():
        return attention.attention_btd_train_reference(q, k, v, H, rate, seeds, causal)

    def library():
        return F.scaled_dot_product_attention(q4, k4, v4, dropout_p=rate, is_causal=causal)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        backend = _sdpa_backend(q4.detach(), k4.detach(), v4.detach(), rate, causal)
    res = {"shape": dict(B=B, T=T, D=D, heads=H, dtype=dtype, rate=rate,
                         causal=causal), "library_backend": backend}
    for name, fn, grad_out, iters in (("kernel", kernel, dout, 20),
                                      ("plain", plain, dout, 5),
                                      ("library", library, dout4, 20)):
        with torch.no_grad():
            res[f"{name}_forward_ms"] = device_ms(fn, iters=iters)
            res[f"{name}_forward_wall_ms"] = time_ms(fn, iters=iters)
        out = fn()

        def backward():
            return torch.autograd.grad(out, (q, k, v), grad_out, retain_graph=True)

        res[f"{name}_backward_ms"] = device_ms(backward, iters=iters)
        res[f"{name}_backward_wall_ms"] = time_ms(backward, iters=iters)
    out = kernel()
    res["kernel_backward_passes_ms"] = backward_pass_ms(lambda: torch.autograd.grad(
        out, (q, k, v), dout, retain_graph=True))
    with torch.no_grad():
        # by CUDA events, as B1's rows are timed
        res["kernel_forward_rate0_ms"] = time_ms(
            lambda: attention.fused_attention_btd_train(q, k, v, H, 0.0, seeds, causal))
    res["forward_bound_ms"], res["forward_bound_by"] = attention_bound_ms(
        B, T, D, H, dtype, causal, None)
    res["backward_bound_ms"], res["backward_bound_by"] = attention_bound_ms(
        B, T, D, H, dtype, causal, None, tensors=7, products=5)
    # the row pass moves q, k, v, dO, dQ and computes QK^T, dO V^T, dS K; the
    # column pass moves q, k, v, dO, dK, dV and computes QK^T, dO V^T, dV, dK
    # (the [3, B, H, T] statistics between them are 0.5% of either's bytes)
    res["backward_pass_bound_ms"] = {
        "rows": attention_bound_ms(B, T, D, H, dtype, causal, None, tensors=5, products=3),
        "cols": attention_bound_ms(B, T, D, H, dtype, causal, None, tensors=6, products=4)}
    for which in ("forward", "backward"):
        print(f"  training attention {which}, {dtype} B={B} T={T} rate {rate} "
              f"{'causal' if causal else 'non-causal'}, "
              f"device time (wall with launches): kernel "
              + ", ".join(f"{label}{res[name + '_' + which + '_ms']:.4f} ms "
                          f"({res[name + '_' + which + '_wall_ms']:.4f})"
                          for name, label in (("kernel", ""), ("plain", "plain "),
                                              ("library", f"sdpa ({backend}) ")))
              + f", bound {res[which + '_bound_ms']:.4f} ms ({res[which + '_bound_by']}) "
              f"[{card}]")
    passes, bounds = res["kernel_backward_passes_ms"], res["backward_pass_bound_ms"]
    print(f"  training attention backward by pass ({dtype}, device time): "
          + ", ".join(f"{name} pass {passes[part]:.4f} ms (bound {bounds[part][0]:.4f} ms, "
                      f"{bounds[part][1]})" for name, part in (("row", "rows"),
                                                                ("column", "cols")))
          + f" [{card}]")
    print(f"  training attention forward at rate 0 ({dtype}): kernel "
          f"{res['kernel_forward_rate0_ms']:.4f} ms [{card}]")
    return res


def request_args(out_dir, num_samples, guidance, compute_dtype, seed, arch="online",
                 cm_mode="concat"):
    return Namespace(
        seed=seed, device=0, batch_size=num_samples, use_ddim=False,
        timestep_respacing="", noise_schedule="cosine",
        diffusion_steps=FLAGSHIP["steps"], sigma_small=True, setting="cmdm",
        arch=arch, emb_trans_dec=False, wo_pos_emb=False, cm_mode=cm_mode,
        layers=FLAGSHIP["layers"], latent_dim=FLAGSHIP["latent_dim"],
        cond_mask_prob=0.1, lambda_rcxyz=0.0, lambda_vel=0.0, lambda_fc=0.0,
        lambda_orient=1.0, lambda_body=1.0, lambda_transl=1.0,
        unconstrained=False, dataset="chi3d", data_dir="", num_person=2,
        data_path="", pose_rep="rot6d", body_model="smplx",
        vel_threshold=0.01, shuffle=False, model_path="random",
        output_dir=str(out_dir), num_samples=num_samples, num_repetitions=1,
        guidance_param=guidance, motion_length=60, input_text="",
        action_file="", text_prompt="", action_name="",
        num_frames=FLAGSHIP["T"], compute_dtype=compute_dtype,
    )


def run_requests(report, card):
    """Phase 3: three cgenerate requests at the flagship width."""
    import numpy as np

    from regennet_torch.data import synthetic
    from regennet_torch.data.feeder import Feeder
    from regennet_torch.ops import attention
    from regennet_torch.sample import cgenerate

    T = FLAGSHIP["T"]
    # the batch is built in memory: synthetic clips through the feeder's
    # pose-rep conversion (no h5 file) and ccollate inside cgenerate
    data = Feeder(
        clips=synthetic.make_clips("chi3d", "test", num_clips=16,
                                   min_len=T + 10, max_len=2 * T),
        dataname="chi3d", split="test", num_frames=T, num_person=2,
        pose_rep="rot6d",
    )
    requests = [
        ("f32 batch 16, guidance 1", 16, 1.0, "float32"),
        ("f32 batch 16, CFG 2.5 (2B forward)", 16, 2.5, "float32"),
        ("bf16 batch 128, guidance 1", 128, 1.0, "bfloat16"),
    ]
    rows = []
    attention.fused_attention_btd.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        for i, (label, n, guidance, dtype) in enumerate(requests):
            args = request_args(Path(tmp) / f"req{i}", n, guidance, dtype, seed=i)
            times = []
            t0 = time.perf_counter()
            npy_path = cgenerate.main(args, data=data, generate_ms=times)
            wall = time.perf_counter() - t0
            res = np.load(npy_path, allow_pickle=True).item()
            expect = {"output": (n, 56, 6, T), "cmotion": (n, 56, 6, T),
                      "motion": (n, 55, 3, T)}
            for key, shape in expect.items():
                if res[key].shape != shape or not np.isfinite(res[key]).all():
                    raise AssertionError(
                        f"request {i}: {key} has shape {res[key].shape} "
                        f"(want {shape}) or non-finite values")
            if len(res["text"]) != n:
                raise AssertionError(f"request {i}: {len(res['text'])} texts")
            gen_ms = times[0]
            row = dict(request=label, batch=n, dtype=dtype, guidance=guidance,
                       steps=FLAGSHIP["steps"], generate_ms=gen_ms,
                       seqs_per_s=n / (gen_ms / 1e3),
                       ms_per_step=gen_ms / FLAGSHIP["steps"],
                       request_wall_s=wall)
            rows.append(row)
            print(f"  request {i} ({label}): {row['seqs_per_s']:.3f} seqs/s, "
                  f"{row['ms_per_step']:.3f} ms/step, generate {gen_ms / 1e3:.2f} s, "
                  f"request {wall:.2f} s [{card}]")
    launches = attention.fused_attention_btd.launches
    expected = FLAGSHIP["layers"] * FLAGSHIP["steps"] * len(requests)
    print(f"  attention kernel launches over the three requests: {launches} "
          f"(layers x steps x requests = {expected})")
    if launches != expected:
        raise AssertionError(f"attention launches {launches} != {expected}")
    report["requests"] = rows
    report["launches"] = {"fused_attention_btd": launches}
    return data, launches


def check_forward(report, data, arch="online", key="forward_checks"):
    """One denoiser forward of the `arch` trunk through the kernel against
    the same forward through the plain attention, on the same weights on
    the card."""
    import numpy as np
    import torch

    from regennet_torch.data.collate import ccollate
    from regennet_torch.models import cmdm, transformer
    from regennet_torch.ops import attention
    from regennet_torch.utils.model_util import create_model_and_diffusion

    # bf16 through 8 layers: a bf16 rounding flip in one attention score
    # moves later activations by bf16-level amounts; f32 sums differ in order
    tol = {"float32": 1e-4, "bfloat16": 2.0 ** -3}
    out = []
    for dtype, n in (("float32", 16), ("bfloat16", 128)):
        args = request_args("", n, 1.0, dtype, seed=7, arch=arch)
        torch.manual_seed(7)
        model, _, _ = create_model_and_diffusion(args, data)
        model = model.to(device="cuda", dtype=getattr(torch, dtype)).eval()
        motion, cond_np = ccollate([data.get_cmotion(i % 8, "appointed", 0)
                                    for i in range(n)])
        gen = torch.Generator(device="cuda").manual_seed(7)
        x = torch.randn(motion.shape, device="cuda", generator=gen)
        t = torch.randint(0, 1000, (n,), device="cuda", generator=gen)
        fn = cmdm.make_model_fn(model)
        cond = fn.prepare({
            "cmotion": torch.as_tensor(cond_np["y"]["cmotion"], device="cuda"),
            "action": torch.as_tensor(cond_np["y"]["action"], device="cuda"),
        })
        fused = fn(x, t, cond)
        transformer.fused_attention_btd = attention.attention_btd_reference
        try:
            plain = fn(x, t, cond)
        finally:
            transformer.fused_attention_btd = attention.fused_attention_btd
        torch.cuda.synchronize()
        err = float((fused - plain).abs().max())
        bound = tol[dtype] * max(1.0, float(plain.abs().max()))
        row = dict(dtype=dtype, batch=n, max_abs_err=err, tolerance=bound,
                   mean_abs_err=float((fused - plain).abs().mean()))
        print(f"  {arch} denoiser forward {dtype} batch {n}: kernel vs plain attention "
              f"max_abs_err {err:.3g} (tolerance {bound:.3g}), mean "
              f"{row['mean_abs_err']:.3g}")
        if not (err <= bound and np.isfinite(err)):
            raise AssertionError(f"denoiser forward disagrees: {row}")
        out.append(row)
    report[key] = out


def train_args(save_dir):
    """The flagship training configuration as train_mdm arguments."""
    args = request_args("", TRAIN["batch"], 1.0, "float32", seed=0)
    for name in ("output_dir", "num_samples", "num_repetitions", "guidance_param",
                 "motion_length", "input_text", "action_file", "text_prompt",
                 "action_name", "model_path"):
        delattr(args, name)
    args.lambda_vel = 1.0
    vars(args).update(
        save_dir=str(save_dir), overwrite=False, train_platform_type="NoPlatform",
        lr=1e-4, weight_decay=0.0, lr_anneal_steps=0, ema_rate=0.9999,
        eval_batch_size=32, eval_split="test", eval_during_training=False,
        rec_model_path="", nan_guard=False, eval_rep_times=3, eval_num_samples=1000,
        log_interval=TRAIN["steps_per_call"], save_interval=TRAIN["steps"],
        num_steps=TRAIN["steps"], profile_steps=0, profile_start=10,
        resume_checkpoint="", data_parallel=-1, tensor_parallel=1,
        param_sharding="replicated", steps_per_call=TRAIN["steps_per_call"],
    )
    return args


def run_training(report, card, save_dir, device="cuda", args=None, key="training"):
    """Phase 4 (and 5, 7, 9, 10): train_mdm.main on the flagship training
    configuration, or on `args` (device "cpu" rehearses it at a cut size,
    through the plain attention, which launches nothing). The Chi3D clips
    are built in memory; HumanAct12 and UESTC (phase 10) are read from
    --data_path, as a user's run reads them."""
    import numpy as np
    import torch

    from regennet_torch.data import synthetic
    from regennet_torch.data.feeder import Feeder
    from regennet_torch.data.get_data import BatchLoader, get_collate_fn
    from regennet_torch.models.cmdm import TRANSFORMER_ARCHS
    from regennet_torch.ops import attention
    from regennet_torch.train import train_mdm, training_loop
    from regennet_torch.utils.fixseed import fixseed
    from regennet_torch.utils.model_util import create_model_and_diffusion

    args = args or train_args(save_dir)
    T, B, steps, K = args.num_frames, args.batch_size, args.num_steps, args.steps_per_call
    t0 = time.perf_counter()
    loader = None
    if args.dataset == "chi3d":
        # steps batches in one epoch: the loop's epoch count is steps // (len + 1)
        clips = synthetic.make_clips("chi3d", "train", num_clips=B * steps,
                                     min_len=T + 10, max_len=T + 60)
        feeder = Feeder(clips=clips, dataname="chi3d", split="train", num_frames=T,
                        num_person=2, pose_rep="rot6d")
        loader = BatchLoader(feeder, B, get_collate_fn("chi3d", "cmdm"))
    data_s = time.perf_counter() - t0
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)

    # device-synchronised time of each K-step block (the batches are
    # collated before the block, outside it)
    block_ms = []
    run_block = training_loop.TrainLoop.run_block

    def timed_block(self, items):
        sync()
        start = time.perf_counter()
        per_step = run_block(self, items)
        sync()
        block_ms.append((time.perf_counter() - start) * 1e3 / len(items))
        return per_step

    # progress.json gets one line per logged step (progress.csv keeps the last)
    os.environ["REGENNET_LOG_FORMAT"] = "human,json"
    fn = attention.fused_attention_btd_train
    fn.launches = fn.backward_launches = 0
    training_loop.TrainLoop.run_block = timed_block
    try:
        t0 = time.perf_counter()
        loop = train_mdm.main(args, device=device, data=loader)
        sync()
        wall_s = time.perf_counter() - t0
    finally:
        training_loop.TrainLoop.run_block = run_block
    loader = loop.data
    launches = {"forward": fn.launches, "backward": fn.backward_launches}
    # the gru and mlp trunks attend nothing
    expected = args.layers * steps if device != "cpu" and args.arch in TRANSFORMER_ARCHS \
        else 0
    print(f"  training kernel launches over {steps} steps: forward "
          f"{launches['forward']}, backward {launches['backward']} (layers x steps "
          f"= {expected} each)")
    if launches != {"forward": expected, "backward": expected}:
        raise AssertionError(f"training kernel launches {launches} != {expected}")
    if loop.state_step != steps or len(block_ms) != steps // K:
        raise AssertionError(f"ran {loop.state_step} steps in {len(block_ms)} blocks")
    for name in (f"model{steps:09d}.pt", f"opt{steps:09d}.pt"):
        if not (save_dir / name).is_file():
            raise AssertionError(f"{name} was not written")

    with open(save_dir / "progress.json") as f:
        logged = [json.loads(line) for line in f]
    for row in logged:
        if not (math.isfinite(float(row["loss"])) and math.isfinite(float(row["grad_norm"]))):
            raise AssertionError(f"non-finite logged step: {row}")
    first, last = logged[0], logged[-1]

    # the parameters moved from their seeded initialisation, and the EMA
    # lags them: ema - p0 = (1 - r) sum_k r^(n-k) (p_k - p0), so its
    # distance from p0 lies between (1 - r) and 1 - r^n of |p_n - p0|
    fixseed(args.seed)
    init, _, _ = create_model_and_diffusion(args, loader)
    init = dict(init.named_parameters())
    moved, ema_moved, unchanged = 0.0, 0.0, []
    for name, p in loop.model.named_parameters():
        d = (p.detach().cpu() - init[name].detach()).double()
        if not d.abs().max() > 0:
            unchanged.append(name)
        moved += float((d ** 2).sum())
        ema_moved += float(((loop.ema[name].cpu() - init[name].detach()).double() ** 2).sum())
    rate = args.ema_rate
    ema_ratio = math.sqrt(ema_moved / moved)
    # the mdm setting's actor input is zero: the weight that projects it
    # gets a zero gradient (its bias does not)
    if args.setting == "mdm" and unchanged == ["cmo_process.poseEmbedding.weight"]:
        unchanged = []
    if unchanged or not (1 - rate) <= ema_ratio <= 1 - rate ** steps:
        raise AssertionError(f"unchanged parameters {unchanged} or EMA ratio {ema_ratio}")

    # the master weights, their EMA and AdamW's moments stay f32 at any
    # compute dtype, in memory and in the checkpoint
    state = [("parameter", n, p) for n, p in loop.model.named_parameters()]
    state += [("EMA", n, e) for n, e in loop.ema.items()]
    state += [(f"AdamW {m}", n, loop.optimizer.state[p][m])
              for n, p in loop.model.named_parameters() for m in ("exp_avg", "exp_avg_sq")]
    saved = torch.load(save_dir / f"model{steps:09d}.pt", map_location="cpu",
                       weights_only=True)
    state += [("checkpoint", n, v) for n, v in saved.items()]
    not_f32 = [f"{kind} {n}" for kind, n, v in state if v.dtype != torch.float32]
    if not_f32:
        raise AssertionError(f"not float32 after training: {not_f32[:5]}")

    ms_per_step = float(np.mean(block_ms[1:] or block_ms))  # the first only if alone
    row = dict(arch=args.arch, compute_dtype=args.compute_dtype, steps=steps, batch=B,
               steps_per_call=K,
               block_ms_per_step=block_ms, ms_per_step=ms_per_step,
               samples_per_s=B / (ms_per_step / 1e3), wall_s=wall_s,
               wall_ms_per_step=wall_s * 1e3 / steps, data_build_s=data_s,
               first_logged=dict(step=int(first["step"]), loss=float(first["loss"]),
                                 grad_norm=float(first["grad_norm"])),
               last_logged=dict(step=int(last["step"]), loss=float(last["loss"]),
                                grad_norm=float(last["grad_norm"])),
               ema_ratio=ema_ratio, launches=launches)
    print(f"  {steps} flagship training steps ({args.arch}, batch {B}, "
          f"{args.compute_dtype}, K = {K}): {ms_per_step:.2f} ms/step and "
          f"{row['samples_per_s']:.1f} samples/s over the device-synchronised "
          f"blocks after the first; {row['wall_ms_per_step']:.1f} ms/step wall with "
          f"batch collation and set-up [{card}]")
    print(f"  loss {row['first_logged']['loss']:.5f} at step {row['first_logged']['step']}"
          f", {row['last_logged']['loss']:.5f} at step {row['last_logged']['step']}; "
          f"grad_norm finite; EMA distance / parameter distance from init "
          f"{ema_ratio:.5f} (within [{1 - rate:.4g}, {1 - rate ** steps:.4g}]); "
          f"parameters, EMA, AdamW moments and {steps:09d}.pt all float32")
    report[key] = row
    return loop, loader, launches


def plain_backward_attention(q, k, v, num_heads, dropout_rate, seed, causal=True,
                             softmax_f32=False, kv_len=None):
    """B2 through its plain versions only: the plain forward, and as its
    gradient the backward kernel's plain version, which rounds where the
    kernel does (phase 2b's third reading)."""
    import torch

    from regennet_torch.ops import attention

    rest = (num_heads, dropout_rate, seed, causal, softmax_f32, kv_len)

    class PlainBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            ctx.save_for_backward(q, k, v)
            return attention.attention_btd_train_reference(q, k, v, *rest)

        @staticmethod
        def backward(ctx, dout):
            return attention.attention_btd_train_backward_reference(
                *ctx.saved_tensors, dout, *rest)

    return PlainBackward.apply(q, k, v)


def check_train_step(report, loop, loader, key="train_step_check"):
    """One training step at the loop's compute dtype through the kernels
    against the same step (same weights, batch, t, noise and generator)
    through the plain attention under autograd; and the EMA update of that
    step. f32: the loss within 1e-4 relative, each gradient within 1e-4 x
    max(1, max|g|). bf16: the loss within 2^-6 x max(1, |loss|), and each
    gradient within the bound gradient_tolerance builds for phase 2b, from
    a third step through plain_backward_attention: that step's distance
    from the plain step plus 2^-7 x max(1, max|its gradient|)."""
    import torch

    from regennet_torch.models import transformer
    from regennet_torch.ops import attention
    from regennet_torch.train import training_loop

    motion, cond = next(iter(loader))
    batch = loop._to_device(loop._make_host_batch(motion, cond))
    device = loop.device
    noise = torch.randn(batch["motion"].shape, device=device,
                        generator=torch.Generator(device=device).manual_seed(11))
    model = loop.model
    dtype = "bfloat16" if loop.dtype == torch.bfloat16 else "float32"
    routes = {"kernel": attention.fused_attention_btd_train,
              "plain": attention.attention_btd_train_reference}
    if dtype == "bfloat16":
        routes["plain backward"] = plain_backward_attention
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    runs = {}
    for route, attend in routes.items():
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(start[n])
        optimizer = training_loop.make_optimizer(model.parameters(), 1e-4, 0.0)
        ema = {n: (p * 0.5).detach() for n, p in model.named_parameters()}
        ema_before = {n: e.clone() for n, e in ema.items()}
        step = training_loop.make_train_step(model, loop.sched, loop.cfg, optimizer,
                                             loop.rot2xyz_fn, ema, dtype=loop.dtype)
        transformer.fused_attention_btd_train = attend
        try:
            metrics = step(batch, torch.Generator(device=device).manual_seed(12), 0, noise)
        finally:
            transformer.fused_attention_btd_train = attention.fused_attention_btd_train
        runs[route] = (float(metrics["loss"]),
                       {n: p.grad.clone() for n, p in model.named_parameters()})
        if route == "kernel":
            # ema <- r ema + (1 - r) p, with the updated parameters
            for n, p in model.named_parameters():
                want = 0.9999 * ema_before[n] + (1 - 0.9999) * p.detach()
                if not torch.allclose(ema[n], want, rtol=1e-6, atol=1e-7):
                    raise AssertionError(f"EMA update of {n} is off")
    (loss_k, grads_k), (loss_p, grads_p) = runs["kernel"], runs["plain"]
    loss_tol = (1e-4 if dtype == "float32" else TOLERANCE[dtype]) * max(1.0, abs(loss_p))
    hold(f"{dtype} training step loss {loss_k} against the plain {loss_p}",
         abs(loss_k - loss_p), loss_tol)
    worst = dict(ratio=0.0)
    for n, g in grads_p.items():
        if dtype == "float32":
            err, tol, terms = max_abs_err(grads_k[n], g), 1e-4 * max(
                1.0, float(g.abs().max())), None
            hold(f"gradient of {n}", err, tol)
        else:
            err, tol, terms = hold_gradient(f"gradient of {n}", grads_k[n], g,
                                            runs["plain backward"][1][n], dtype)
        if err / tol >= worst["ratio"]:
            worst = dict(ratio=err / tol, name=n, max_abs_err=err, tolerance=tol,
                         terms=terms)
    bound = ("1e-4 x max(1, max|g|)" if dtype == "float32" else
             "the plain-backward step's distance + 2^-7 x max(1, max|its gradient|): "
             "{:.3g} + {:.3g}".format(*worst["terms"]))
    print(f"  one {dtype} training step through the kernels vs the plain attention: loss "
          f"{loss_k:.6f} vs {loss_p:.6f}; all {len(grads_p)} parameter gradients "
          f"within their bound; worst {worst['name']}, max_abs_err "
          f"{worst['max_abs_err']:.3g} of {worst['tolerance']:.3g} ({bound}); EMA update "
          "exact")
    report[key] = dict(dtype=dtype, loss_kernel=loss_k, loss_plain=loss_p,
                       worst_gradient=worst)


TRAIN_KERNEL_GROUPS = (  # (group, substrings of CUDA kernel names), first match wins
    ("dense GEMMs (cuBLAS)", ("gemm", "Gemm", "xmma", "cutlass", "nvjet")),
    ("LayerNorm", ("layer_norm", "LayerNorm")),
    ("random draws (dropout masks, seeds, noise)", ("distribution", "philox", "Philox")),
    ("AdamW and EMA (foreach)", ("multi_tensor_apply",)),
    ("indexing (joint decode levels, gathers)", ("index", "gather", "scatter")),
    ("reductions", ("reduce_kernel",)),
)


def _kernel_group(name):
    if "attention_fwd_kernel<" in name:
        # the last template argument is DROP: the training forward's dropout
        # (at rate 0 the training forward runs B1's instantiation)
        args = name.split("attention_fwd_kernel<", 1)[1].split(">", 1)[0]
        return ("training attention forward" if args.endswith("true")
                else "attention forward (B1, B3)")
    if "attention_train_rows" in name or "attention_train_cols" in name:
        return "training attention backward"
    return next((g for g, keys in TRAIN_KERNEL_GROUPS if any(k in name for k in keys)),
                "other elementwise")


def profile_train_step(report, loop, loader, steps=3, key="training"):
    """Device time per kernel group of `steps` training steps of the trained
    loop, under torch.profiler (CUDA activity); the idle share against the
    untraced ms/step of the run report[key]; the GEMM kernels by name,
    which show whether they ran on tensor cores. Into report[key +
    "_profile"]."""
    it = iter(loader)
    # a warm-up step and `steps` profiled ones, each on its own batch
    batches = iter([loop._to_device(loop._make_host_batch(*next(it)))
                    for _ in range(steps + 1)])
    busy, by_name = kernel_times(
        lambda: loop._train_step(next(batches), loop.generator, loop.state_step), steps)
    groups = {}
    for name, ms in by_name.items():
        group = _kernel_group(name)
        groups[group] = groups.get(group, 0.0) + ms
    per_step = dict(sorted(groups.items(), key=lambda kv: -kv[1]))
    gemms = {name: ms for name, ms in by_name.items()
             if _kernel_group(name) == TRAIN_KERNEL_GROUPS[0][0]}
    wall = report[key]["ms_per_step"]
    print(f"  device time per {loop.args.compute_dtype} training step under torch.profiler: "
          f"busy {busy:.2f} ms of {wall:.2f} ms untraced (idle share {1 - busy / wall:.3f})")
    for g, ms in per_step.items():
        print(f"    {g}: {ms:.3f} ms ({ms / busy:.1%})")
    print("    GEMM kernels, the longest first: " + "; ".join(
        f"{name[:90]} {ms:.3f} ms" for name, ms in list(gemms.items())[:6]))
    report[key + "_profile"] = dict(steps=steps, busy_ms=busy, idle_share=1 - busy / wall,
                                    groups_ms=per_step, gemm_kernels_ms=gemms)


def sample_trained(report, save_dir, data, device="cuda", steps=None, ddim=True,
                   key="trained_sample", compute_dtype="float32"):
    """cgenerate from the checkpoint of step `steps` (the last of phase 4
    by default): batch 16 at `compute_dtype`, DDIM 50 or, with ddim False,
    DDPM over every step of the checkpoint's schedule."""
    import numpy as np

    from regennet_torch.sample import cgenerate
    from regennet_torch.utils import parser_util

    ckpt = save_dir / f"model{steps or TRAIN['steps']:09d}.pt"
    args = parser_util.cgenerate_args([
        "--model_path", str(ckpt), "--output_dir", str(save_dir / "samples"),
        "--dataset", "chi3d", "--num_person", "2", "--body_model", "smplx",
        "--num_samples", "16", "--num_repetitions", "1", "--seed", "3",
        "--compute_dtype", compute_dtype,
    ] + (["--use_ddim", "--timestep_respacing", "ddim50"] if ddim else []))
    times = []
    res = np.load(cgenerate.main(args, device=device, data=data, generate_ms=times),
                  allow_pickle=True).item()
    T = FLAGSHIP["T"]
    for name, shape in {"output": (16, 56, 6, T), "motion": (16, 55, 3, T)}.items():
        if res[name].shape != shape or not np.isfinite(res[name]).all():
            raise AssertionError(f"trained-checkpoint sample {name}: {res[name].shape}")
    sampler = "DDIM 50" if ddim else f"DDPM {args.diffusion_steps}"
    print(f"  cgenerate from {ckpt.name} ({args.arch}, {sampler}, batch 16, "
          f"{compute_dtype}, {args.activation}): outputs {res['output'].shape} finite, "
          f"generate {times[0]:.1f} ms")
    report[key] = dict(checkpoint=ckpt.name, arch=args.arch, sampler=sampler,
                       compute_dtype=compute_dtype, generate_ms=times[0],
                       activation=args.activation)


OFFLINE_STEPS = 16


def offline_train_args(save_dir, steps=None, extra=()):
    """Phase 5's train_mdm arguments, as a user passes them: the flagship
    training configuration with no --arch, so the parser's default
    (trans_enc, the offline trunk) is trained; `extra` arguments after
    them (phase 7's --arch and --cm_mode)."""
    from regennet_torch.utils import parser_util

    steps = steps or OFFLINE_STEPS
    return parser_util.train_args([
        "--save_dir", str(save_dir), "--dataset", "chi3d", "--num_person", "2",
        "--body_model", "smplx", "--setting", "cmdm", "--num_frames", str(FLAGSHIP["T"]),
        "--batch_size", str(TRAIN["batch"]), "--num_steps", str(steps),
        "--steps_per_call", str(TRAIN["steps_per_call"]), "--save_interval",
        str(steps), "--log_interval", str(TRAIN["steps_per_call"]),
        "--lambda_vel", "1.0", "--seed", "0", "--layers", str(FLAGSHIP["layers"]),
        "--latent_dim", str(FLAGSHIP["latent_dim"]),
        "--diffusion_steps", str(FLAGSHIP["steps"]), *extra,
    ])


def run_offline(report, card, save_dir, data, device="cuda"):
    """Phase 5: the offline CMDM (trans_enc, the CLIs' default): train_mdm
    for OFFLINE_STEPS flagship steps, one step through the kernels against
    the plain attention, one DDPM-1000 cgenerate request (f32 batch 16)
    from its checkpoint with B1's launch count read around it, and one
    denoiser forward through the kernels against the plain one. Returns
    (B2 launches, B1 launches)."""
    from regennet_torch.ops import attention

    args = offline_train_args(save_dir)
    if args.arch != "trans_enc":
        raise AssertionError(f"the default --arch is {args.arch!r}")
    loop, loader, train_launches = run_training(report, card, save_dir, device, args,
                                                key="offline_training")
    check_train_step(report, loop, loader, key="offline_train_step_check")
    del loop, loader
    fn = attention.fused_attention_btd
    fn.launches = 0
    sample_trained(report, save_dir, data, device, steps=OFFLINE_STEPS, ddim=False,
                   key="offline_sample")
    launches = fn.launches
    expected = FLAGSHIP["layers"] * FLAGSHIP["steps"] if device != "cpu" else 0
    print(f"  attention kernel launches over the offline request: {launches} "
          f"(layers x steps = {expected})")
    if launches != expected:
        raise AssertionError(f"offline attention launches {launches} != {expected}")
    if device != "cpu":
        check_forward(report, data, arch="trans_enc", key="offline_forward_checks")
    return train_launches, launches


def run_eval(report, card, model_path, device="cuda"):
    """Phase 6: eval_cmdm.main in debug mode (100 samples, one seed, batch
    32, accuracy only) on phase 4's online checkpoint with CFG 2.5 (the
    parser's default) and a random ST-GCN from --seed, on synthetic clips
    built in memory: 128, four batches of 32 in each split. The sampling
    calls and the classifier's batches are timed (device-synchronised);
    B1's launches are read around the call. Then the ST-GCN on the card
    against a CPU copy on the same ground-truth batches."""
    import numpy as np
    import torch

    from regennet_torch.data import synthetic
    from regennet_torch.data.collate import collate
    from regennet_torch.data.feeder import Feeder
    from regennet_torch.data.get_data import BatchLoader
    from regennet_torch.eval import eval_cmdm, stgcn_eval, tools
    from regennet_torch.ops import attention
    from regennet_torch.utils import parser_util

    T = FLAGSHIP["T"]
    data = Feeder(clips=synthetic.make_clips("chi3d", "test", num_clips=128,
                                             min_len=T + 10, max_len=2 * T),
                  dataname="chi3d", split="test", num_frames=T, num_person=2,
                  pose_rep="rot6d")
    args = parser_util.evaluation_parser([
        "--model_path", str(model_path), "--rec_model_path", "random", "--seed", "0"])
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    sample_ms, stgcn_ms, rows = [], [], []
    sample_output, evaluator_call = stgcn_eval._sample_output, stgcn_eval.STGCNEvaluator.__call__

    def timed_sample(sample_fn, generator, cond_np, shape, *rest):
        sync()
        t0 = time.perf_counter()
        out = sample_output(sample_fn, generator, cond_np, shape, *rest)
        sample_ms.append((time.perf_counter() - t0) * 1e3)
        rows.append(shape[0])
        return out

    def timed_call(self, batch):
        sync()
        t0 = time.perf_counter()
        out = evaluator_call(self, batch)
        stgcn_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    fn = attention.fused_attention_btd
    stgcn_eval._sample_output, stgcn_eval.STGCNEvaluator.__call__ = timed_sample, timed_call
    fn.launches = 0
    try:
        t0 = time.perf_counter()
        result = eval_cmdm.main(args, device=device, data=data)
        wall_s = time.perf_counter() - t0
    finally:
        stgcn_eval._sample_output, stgcn_eval.STGCNEvaluator.__call__ = (
            sample_output, evaluator_call)
    launches = fn.launches
    steps = args.diffusion_steps
    expected = args.layers * steps * len(sample_ms) if device != "cpu" else 0
    print(f"  attention kernel launches over the evaluation: {launches} (layers x "
          f"steps x sampling calls = {args.layers} x {steps} x {len(sample_ms)})")
    if launches != expected or len(sample_ms) != 8:
        raise AssertionError(f"eval attention launches {launches} != {expected}, or "
                             f"{len(sample_ms)} sampling calls (want 8)")
    path = eval_cmdm.results_path(args)
    if tools.load_metrics(path) != result:
        raise AssertionError(f"{path} does not hold the returned metrics")
    feats = result["feats"]
    want = {f"accuracy_{k}_{s}" for k in ("gen", "gt") for s in ("train", "test")}
    if set(feats) != want or not all(
            len(v) == 1 and 0.0 <= float(v[0]) <= 1.0 for v in feats.values()):
        raise AssertionError(f"evaluation metrics {feats}")
    sampling_s, stgcn_s = sum(sample_ms) / 1e3, sum(stgcn_ms) / 1e3
    row = dict(metrics=feats, results_file=os.path.basename(path), wall_s=wall_s,
               guidance=args.guidance_param, sampling_calls=len(sample_ms),
               sampled_rows=sum(rows), sampling_s=sampling_s,
               sampling_ms_per_step=sampling_s * 1e3 / (len(sample_ms) * steps),
               seqs_per_s=sum(rows) / sampling_s, stgcn_batches=len(stgcn_ms),
               stgcn_ms_per_batch=float(np.mean(stgcn_ms)), stgcn_s=stgcn_s,
               host_s=wall_s - sampling_s - stgcn_s, launches=launches)
    print(f"  metrics {feats}; results in {path}")
    print(f"  eval_cmdm debug (CFG {args.guidance_param}): wall {wall_s:.2f} s; sampling "
          f"{sampling_s:.2f} s over {len(sample_ms)} calls of {rows[0]} sequences "
          f"({row['sampling_ms_per_step']:.3f} ms per step, {row['seqs_per_s']:.3f} "
          f"seqs/s); ST-GCN {row['stgcn_ms_per_batch']:.2f} ms per batch over "
          f"{len(stgcn_ms)} batches; host {row['host_s']:.2f} s [{card}]")

    # the classifier on the card against a CPU copy, same weights and batches
    gt = stgcn_eval.build_gt_batches(BatchLoader(data, 32, collate, shuffle=False),
                                     args.num_samples)
    on_card = eval_cmdm.load_stgcn_evaluator(args, "random", device)
    on_cpu = eval_cmdm.load_stgcn_evaluator(args, "random", "cpu")
    worst = 0.0
    for batch in gt:
        a, b = on_card(batch), on_cpu(batch)
        for key in ("features", "yhat"):
            err = float(np.abs(a[key] - b[key]).max())
            tol = 1e-4 * max(1.0, float(np.abs(b[key]).max()))
            if not (err <= tol and math.isfinite(err)):
                raise AssertionError(f"ST-GCN {key} on the card vs the CPU: {err} > {tol}")
            worst = max(worst, err / max(1.0, float(np.abs(b[key]).max())))
    print(f"  ST-GCN on the card vs a CPU copy over {len(gt)} ground-truth batches: "
          f"features and logits within 1e-4 x max(1, max|cpu|) (worst {worst:.3g})")
    row["stgcn_card_vs_cpu_worst_scaled"] = worst
    report["evaluation"] = row
    return launches


TRUNK_STEPS = 16


def check_gru_rz(loop, args, loader):
    """The GRU's bias_hh r/z slices after training equal their seeded
    initialisation (the gradient hook keeps them still)."""
    import torch

    from regennet_torch.utils.fixseed import fixseed
    from regennet_torch.utils.model_util import create_model_and_diffusion

    fixseed(args.seed)
    init, _, _ = create_model_and_diffusion(args, loader)
    D = args.latent_dim
    for i in range(args.layers):
        name = f"bias_hh_l{i}"
        trained = getattr(loop.model.gru, name).detach().cpu()
        if not torch.equal(trained[: 2 * D], getattr(init.gru, name)[: 2 * D].detach()):
            raise AssertionError(f"gru.{name}'s r/z slices moved in training")
    print(f"  gru: the r/z slices of bias_hh_l0..{args.layers - 1} are unchanged after "
          f"{args.num_steps} {args.compute_dtype} steps")


def run_trunk(report, card, save_dir, data, arch, device="cuda"):
    """Phase 7, one trunk: train_mdm for TRUNK_STEPS flagship steps with
    --arch `arch` --cm_mode add, the GRU's bias_hh r/z slices against its
    initialisation, a forward of the trained weights on the card against a
    CPU copy, and a DDPM cgenerate request (f32 batch 16) from the
    checkpoint."""
    args = offline_train_args(save_dir, TRUNK_STEPS, ("--arch", arch, "--cm_mode", "add"))
    loop, loader, launches = run_training(report, card, save_dir, device, args,
                                          key=f"{arch}_training")
    if arch == "gru":
        check_gru_rz(loop, args, loader)
    if device != "cpu":
        check_trunk_forward(report, card, data, loop.model, arch, "float32", device)
    del loop, loader
    key = f"{arch}_sample"
    sample_trained(report, save_dir, data, device, steps=TRUNK_STEPS, ddim=False, key=key)
    row = report[key]
    row["ms_per_step"] = row["generate_ms"] / FLAGSHIP["steps"]
    row["seqs_per_s"] = 16 / (row["generate_ms"] / 1e3)
    train = report[f"{arch}_training"]
    print(f"  {arch}: training {train['ms_per_step']:.2f} ms/step ({train['samples_per_s']:.1f}"
          f" samples/s); sampling {row['seqs_per_s']:.3f} seqs/s, {row['ms_per_step']:.3f} ms "
          f"per denoiser step [{card}]")
    return launches


def load_capability_study():
    """scripts/capability_study_torch.py as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "capability_study_torch", REPO / "scripts" / "capability_study_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def hold_kernels_at(b1_shapes, b2_shapes, causal, D, H, seed):
    """B1 at each (B, T, dtype) of b1_shapes, and B2 (rate TRAIN["rate"],
    forward and backward) at each of b2_shapes, on [B, T, D] inputs with H
    heads, against their plain versions as phases 2 and 2b hold them.
    Returns (the worst errors: B1, B2's forward, B2's backward against its
    plain backward; the cases)."""
    import torch

    from regennet_torch.ops import attention

    gen = torch.Generator(device="cuda").manual_seed(seed)
    worst = {"forward": 0.0, "train_forward": 0.0, "backward": 0.0}
    cases = []
    for B, T, dtype in b1_shapes:
        what = f"fused_attention_btd at {dtype} [{B}, {T}, {D}], {H} heads, causal {causal}"
        q, k, v = torch.randn(B, T, 3 * D, device="cuda", generator=gen).to(
            getattr(torch, dtype)).split(D, dim=-1)
        ref = attention.attention_btd_reference(q, k, v, H, causal)
        err = max_abs_err(attention.fused_attention_btd(q, k, v, H, causal), ref)
        hold(what, err, TOLERANCE[dtype] * max(1.0, float(ref.float().abs().max())))
        worst["forward"] = max(worst["forward"], err)
        cases.append(dict(kernel="fused_attention_btd", B=B, T=T, D=D, heads=H, dtype=dtype,
                          causal=causal, max_abs_err=err))
    for B, T, dtype in b2_shapes:
        what = f"fused_attention_btd_train at {dtype} [{B}, {T}, {D}], {H} heads, causal {causal}"
        ours, plain, vjp = _train_pair(B, T, dtype, causal, None, TRAIN["rate"], gen, D=D, H=H)
        case = dict(kernel="fused_attention_btd_train", B=B, T=T, D=D, heads=H, dtype=dtype,
                    causal=causal)
        err = max_abs_err(ours[0], plain[0])
        hold(f"{what}: out", err, TOLERANCE[dtype] * max(1.0, float(plain[0].float().abs().max())))
        worst["train_forward"] = max(worst["train_forward"], err)
        case["out_err"] = err
        for name, a, b, c in zip(("dq", "dk", "dv"), ours[1:], plain[1:], vjp):
            case[f"{name}_err"] = hold_gradient(f"{what}: {name}", a, b, c, dtype)[0]
            err_vjp = max_abs_err(a, c)
            hold(f"{what}: {name} against the plain backward", err_vjp,
                 TOLERANCE_VJP[dtype] * max(1.0, float(c.float().abs().max())))
            worst["backward"] = max(worst["backward"], err_vjp)
            case[f"{name}_vjp_err"] = err_vjp
        cases.append(case)
    return worst, cases


def check_guard_kernels(report):
    """B1 and B2 at the learning guard's shapes (f32, 4 heads of 16, B 32,
    T 24 and 25, causal, B2 at its dropout 0.1) against their plain
    versions, as phases 2 and 2b hold them. Returns the worst errors."""
    shapes = [(32, T, "float32") for T in (24, 25)]
    worst, report["guard_kernel_cases"] = hold_kernels_at(shapes, shapes, True, 64, 4, seed=6)
    print(f"  B1 and B2 at head dim 16 ([32, 24 and 25, 64], 4 heads, f32, causal, B2 at "
          f"rate 0.1) match their plain versions (worst max_abs_err B1 {worst['forward']:.3g}, "
          f"B2 forward {worst['train_forward']:.3g}, backward {worst['backward']:.3g} against "
          "the plain backward; tolerance 1e-5 x max(1, max|plain|))")
    return worst


def run_learning_guard(report, card, workdir, device="cuda"):
    """Phase 8: the learning guard in process, its launches of B1 (its
    sampling, layers x steps x sampling calls) and B2 (its CMDM training,
    layers x steps each way) read around it, and its six thresholds.
    Returns {kernel: launches}."""
    from regennet_torch.eval import stgcn_eval
    from regennet_torch.ops import attention

    study = load_capability_study()
    calls = []
    sample_output = stgcn_eval._sample_output

    def counted(*a, **kw):
        calls.append(a[3][0])
        return sample_output(*a, **kw)

    b1, b2 = attention.fused_attention_btd, attention.fused_attention_btd_train
    b1.launches = b2.launches = b2.backward_launches = 0
    stgcn_eval._sample_output = counted
    try:
        results = study.run_study(device, str(workdir))
    finally:
        stgcn_eval._sample_output = sample_output
    launches = {"fused_attention_btd": b1.launches,
                "fused_attention_btd_train": {"forward": b2.launches,
                                              "backward": b2.backward_launches}}
    train = results["cmdm_training"]
    on_card = device != "cpu"
    want = {"fused_attention_btd": train["layers"] * train["diffusion_steps"] * len(calls)
            * on_card,
            "fused_attention_btd_train": {w: train["layers"] * train["steps"] * on_card
                                          for w in ("forward", "backward")}}
    print(f"  launches: B1 {launches['fused_attention_btd']} (layers x steps x sampling calls "
          f"= {train['layers']} x {train['diffusion_steps']} x {len(calls)}), B2 "
          f"{launches['fused_attention_btd_train']} (layers x steps = "
          f"{train['layers']} x {train['steps']} each)")
    if launches != want:
        raise AssertionError(f"learning guard launches {launches} != {want}")
    walls = results["walls_s"]
    print("  stage walls: " + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items())
          + f"; total {results['total_s']:.2f} s [{card}]")
    for row in ("trained", "random_init", "oracle"):
        print(f"  {row}: accuracy_gen_test {results[row]['accuracy_gen_test']['mean']:.4f}, "
              f"fid_gen_test {results[row]['fid_gen_test']['mean']:.6g}")
    print(f"  evaluator GT accuracy {results['evaluator']['gt_test_accuracy']:.4f}")
    report["learning_guard"] = dict(results, launches=launches, sampling_calls=len(calls))
    study.require_learning(results)
    print("  all six thresholds of tests/test_capability_smoke.py hold: "
          + "; ".join(results["checked"]))
    return launches


BF16_EVAL_SAMPLES = 32  # phase 9's --eval_num_samples
# a bf16 denoiser forward against the f32 forward of the same weights:
# every layer rounds to bf16 (about 2^-8 relative), through 8 layers
TOLERANCE_BF16_VS_F32 = 2.0 ** -4  # x max(1, max|f32|)


def run_bf16_training(report, card, save_dir, data, device="cuda"):
    """Phase 9, the online trunk: train_mdm on the flagship training
    configuration with --compute_dtype bfloat16 and --eval_during_training
    (--rec_model_path random, --eval_num_samples 32), B1's launches read
    around the run (its in-training evaluations: layers x steps x sampling
    calls) and each evaluation's metrics; one bf16 step through the kernels
    against the plain attention; the bf16 step's kernel groups under
    torch.profiler (on the card); a bf16 cgenerate request (DDIM 50) from
    the checkpoint with B1's launches read around it. Returns (B2's
    launches, B1's launches)."""
    from regennet_torch.eval import stgcn_eval
    from regennet_torch.ops import attention

    args = train_args(save_dir)
    vars(args).update(compute_dtype="bfloat16", eval_during_training=True,
                      rec_model_path="random", eval_num_samples=BF16_EVAL_SAMPLES)
    calls, evals = [], []
    sample_output, evaluate = stgcn_eval._sample_output, stgcn_eval.evaluate

    def counted(*a, **kw):
        calls.append(a[3][0])
        return sample_output(*a, **kw)

    def timed(*a, **kw):
        t0 = time.perf_counter()
        result = evaluate(*a, **kw)
        evals.append(dict(wall_s=time.perf_counter() - t0, metrics=result["feats"]))
        return result

    b1 = attention.fused_attention_btd
    b1.launches = 0
    stgcn_eval._sample_output, stgcn_eval.evaluate = counted, timed
    try:
        loop, loader, train_launches = run_training(report, card, save_dir, device, args,
                                                    key="bf16_training")
    finally:
        stgcn_eval._sample_output, stgcn_eval.evaluate = sample_output, evaluate
    eval_launches = b1.launches
    on_card = device != "cpu"
    want = args.layers * args.diffusion_steps * len(calls) * on_card
    print(f"  in-training evaluations: {len(evals)} (one after each save), "
          f"{len(calls)} sampling calls of {calls[0] if calls else 0} sequences; B1 "
          f"launches {eval_launches} (layers x steps x sampling calls = {args.layers} x "
          f"{args.diffusion_steps} x {len(calls)}); walls "
          + ", ".join(f"{e['wall_s']:.2f} s" for e in evals) + f" [{card}]")
    metric_names = {f"accuracy_{k}_{s}" for k in ("gen", "gt") for s in ("train", "test")}
    if eval_launches != want or len(evals) != 2 or not all(
            set(e["metrics"]) == metric_names
            and all(0.0 <= float(v[0]) <= 1.0 for v in e["metrics"].values())
            for e in evals):
        raise AssertionError(f"in-training evaluation: launches {eval_launches} != {want}, "
                             f"or its evaluations {evals}")
    print(f"  metrics of the last evaluation: {evals[-1]['metrics']}")
    row = report["bf16_training"]
    row.update(evaluations=evals, eval_sampling_calls=len(calls),
               eval_launches=eval_launches,
               wall_s_without_evaluation=row["wall_s"] - sum(e["wall_s"] for e in evals))
    check_train_step(report, loop, loader, key="bf16_train_step_check")
    if on_card:
        profile_train_step(report, loop, loader, key="bf16_training")
    del loop, loader
    b1.launches = 0
    sample_trained(report, save_dir, data, device, key="bf16_trained_sample",
                   compute_dtype="bfloat16")
    sample_launches = b1.launches
    want = args.layers * 50 * on_card
    print(f"  B1 launches over the bf16 request: {sample_launches} (layers x steps = "
          f"{want})")
    if sample_launches != want:
        raise AssertionError(f"bf16 request launches {sample_launches} != {want}")
    return train_launches, eval_launches + sample_launches


def check_trunk_forward(report, card, data, model, arch, dtype, device="cuda", key=None):
    """One denoiser forward of `model`'s weights on `device` at `dtype`
    against the f32 forward of a CPU copy (batch 16, the same inputs): f32
    within 1e-4 x max(1, max|cpu|) (sums in other orders, cuDNN's GRU and
    cuBLAS, through 8 layers), bf16 within TOLERANCE_BF16_VS_F32. On the
    card, the denoiser step's time at batch 16 by CUDA events and by device
    time, with its longest kernels."""
    import copy

    import numpy as np
    import torch

    from regennet_torch.data.collate import ccollate
    from regennet_torch.models import cmdm

    n = 16
    motion, cond_np = ccollate([data.get_cmotion(i % 8, "appointed", 0) for i in range(n)])
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(motion.shape, generator=gen)
    t = torch.randint(0, 1000, (n,), generator=gen)
    cond = {"cmotion": torch.as_tensor(cond_np["y"]["cmotion"]),
            "action": torch.as_tensor(cond_np["y"]["action"])}
    runs = []
    for where, td in ((device, getattr(torch, dtype)), ("cpu", torch.float32)):
        fn = cmdm.make_model_fn(copy.deepcopy(model).to(device=where, dtype=td).eval())
        runs.append(functools.partial(fn, x.to(where), t.to(where), fn.prepare(
            {k: v.to(where) for k, v in cond.items()})))
    step = runs[0]
    ours, ref = step().cpu(), runs[1]()
    err = float((ours - ref).abs().max())
    tol = (1e-4 if dtype == "float32" else TOLERANCE_BF16_VS_F32) * max(
        1.0, float(ref.abs().max()))
    row = dict(arch=arch, dtype=dtype, batch=n, max_abs_err=err, tolerance=tol,
               max_abs_f32=float(ref.abs().max()),
               mean_abs_err=float((ours - ref).abs().mean()))
    print(f"  {arch} denoiser forward {dtype} batch {n} ({device}) vs f32 (CPU copy): "
          f"max_abs_err {err:.3g} (tolerance {tol:.3g}: "
          f"{'1e-4' if dtype == 'float32' else '2^-4'} x max(1, max|f32|), max|f32| "
          f"{row['max_abs_f32']:.3g}), mean {row['mean_abs_err']:.3g}")
    if not (err <= tol and np.isfinite(err)):
        raise AssertionError(f"{dtype} {arch} forward disagrees with the f32 CPU copy: {row}")
    if device != "cpu":
        row["step_ms"] = time_ms(step)
        row["step_device_ms"], kernels = kernel_times(step)
        row["longest_kernels_ms"] = dict(list(kernels.items())[:6])
        print(f"  {arch} {dtype} denoiser step at batch {n}: {row['step_ms']:.3f} ms "
              f"(device {row['step_device_ms']:.3f} ms); longest kernels: " + "; ".join(
                  f"{name[:80]} {ms:.3f} ms" for name, ms in row["longest_kernels_ms"].items())
              + f" [{card}]")
    report[key or f"{arch}_{dtype}_forward_check"] = row


def run_bf16_trunk(report, card, save_dir, data, arch, device="cuda"):
    """Phase 9, one more trunk: train_mdm --compute_dtype bfloat16 for
    TRUNK_STEPS flagship steps (trans_enc: phase 5's configuration; gru,
    mlp: phase 7's, --cm_mode add), the GRU's bias_hh r/z slices, and
    check_bf16_forward on the trained weights. Returns B2's launches."""
    extra = ("--compute_dtype", "bfloat16")
    if arch != "trans_enc":
        extra += ("--arch", arch, "--cm_mode", "add")
    args = offline_train_args(save_dir, TRUNK_STEPS, extra)
    if args.arch != arch:
        raise AssertionError(f"trained --arch {args.arch!r}, not {arch!r}")
    loop, loader, launches = run_training(report, card, save_dir, device, args,
                                          key=f"bf16_{arch}_training")
    if arch == "gru":
        check_gru_rz(loop, args, loader)
    check_trunk_forward(report, card, data, loop.model, arch, "bfloat16", device)
    return launches


# Phase 10: the single-person a2m path. HumanAct12 (and UESTC) SMPL 25x6 at
# T 60 on the offline trunk at the flagship width: 61 tokens a row (60
# frames and the embedding token), non-causal. Clip counts: HumanAct12
# holds enough for the unconstrained protocol's 1000 samples in batches of
# 64; UESTC's train split (two thirds of the videos, all past the 45-frame
# filter) holds uestc_steps batches.
A2M = dict(T=60, batch=64, steps=16, eval_batch=32, eval_samples=16, uestc_steps=8,
           uncon_steps=8, uncon_diffusion_steps=50, clips=1100, uestc_videos=800,
           modi_struct=1000)


def check_a2m_kernels(report):
    """Phase 10: B1 (non-causal, f32 and bf16, B 32, 64 and 128: the
    in-training evaluation, the evaluations and UESTC's two stacked seeds)
    and B2 (f32 and bf16, [64, 61, 512], rate 0.1, forward and backward) at
    the a2m CMDM's 61 tokens against their plain versions, at phases 2 and
    2b's tolerances. Returns the worst errors."""
    D, H, T, B = FLAGSHIP["latent_dim"], FLAGSHIP["heads"], A2M["T"] + 1, TRAIN["batch"]
    dtypes = ("float32", "bfloat16")
    worst, report["a2m_kernel_cases"] = hold_kernels_at(
        [(b, T, dtype) for b in (32, 64, 128) for dtype in dtypes],
        [(B, T, dtype) for dtype in dtypes], False, D, H, seed=10)
    print(f"  B1 at [32, 64 and 128, {T}, {D}] and B2 at [{B}, {T}, {D}] (non-causal, f32 and "
          f"bf16, B2 at rate {TRAIN['rate']}) match their plain versions (worst max_abs_err B1 "
          f"{worst['forward']:.3g}, B2 forward {worst['train_forward']:.3g}, backward "
          f"{worst['backward']:.3g} against the plain backward; tolerances of phases 2 and 2b)")
    return worst


def time_a2m_kernels(report, card):
    """Phase 2d: B1 and B2 at phase 10's f32 [64, 61, 512], non-causal, by
    device time under torch.profiler, beside their plain versions, SDPA
    and the bounds (B2 as phase 2b times it). At 61 tokens a launch takes
    about as long as the host needs to issue it, so the CUDA-event time of
    back-to-back calls (B1's *_wall_ms) reads the host. Timed here, beside
    phase 2b's profiles: in one full run a profile of B1 taken in phase 10
    recorded no kernel, which a run of phase 10 alone did not repeat.
    Returns (B1's timing, B2's timing)."""
    import torch
    import torch.nn.functional as F

    from regennet_torch.ops import attention

    D, H, T, B = FLAGSHIP["latent_dim"], FLAGSHIP["heads"], A2M["T"] + 1, TRAIN["batch"]
    gen = torch.Generator(device="cuda").manual_seed(11)
    q, k, v = torch.randn(B, T, 3 * D, device="cuda", generator=gen).split(D, dim=-1)
    q4, k4, v4 = (x.view(B, T, H, D // H).transpose(1, 2) for x in (q, k, v))
    b1_timing = {}
    for name, fn, iters in (
            ("", lambda: attention.fused_attention_btd(q, k, v, H, False), 20),
            ("plain_", lambda: attention.attention_btd_reference(q, k, v, H, False), 5),
            ("library_", lambda: F.scaled_dot_product_attention(q4, k4, v4), 20)):
        b1_timing[f"{name}ms"] = device_ms(fn, iters=iters)
        b1_timing[f"{name}wall_ms"] = time_ms(fn, iters=iters)
    b1_timing["bound_ms"], b1_timing["bound_by"] = attention_bound_ms(
        B, T, D, H, "float32", False, None)
    print(f"  B1 f32 [{B}, {T}, {D}] non-causal, device time (wall with launches): kernel "
          + ", ".join(f"{label}{b1_timing[name + 'ms']:.4f} ms ({b1_timing[name + 'wall_ms']:.4f})"
                      for name, label in (("", ""), ("plain_", "plain "),
                                          ("library_", "sdpa ")))
          + f", bound {b1_timing['bound_ms']:.4f} ms ({b1_timing['bound_by']}) [{card}]")
    b2_timing = time_train_kernels(card, "float32", T=T, causal=False)
    report["a2m_attention_timing"] = {"fused_attention_btd": b1_timing,
                                      "fused_attention_btd_train": b2_timing}
    return b1_timing, b2_timing


def counted_run(fn, device="cuda"):
    """fn() with B1's and B2's launch counts set to 0 before it and read
    after it, each sampling loop it runs counted (its rows, its steps and
    its device-synchronised ms), and its wall. Returns (fn's result,
    counts)."""
    import torch

    from regennet_torch.diffusion import sampling
    from regennet_torch.ops import attention

    b1, b2 = attention.fused_attention_btd, attention.fused_attention_btd_train
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    loops = []
    p_sample_loop = sampling.p_sample_loop

    def counted(sched, cfg, model_fn, shape, *rest, **kw):
        sync()
        t0 = time.perf_counter()
        out = p_sample_loop(sched, cfg, model_fn, shape, *rest, **kw)
        sync()
        loops.append(dict(rows=shape[0], steps=sched.num_timesteps,
                          ms=(time.perf_counter() - t0) * 1e3))
        return out

    b1.launches = b2.launches = b2.backward_launches = 0
    sampling.p_sample_loop = counted
    try:
        t0 = time.perf_counter()
        result = fn()
        sync()
        wall_s = time.perf_counter() - t0
    finally:
        sampling.p_sample_loop = p_sample_loop
    sampling_ms = sum(lp["ms"] for lp in loops)
    steps = sum(lp["steps"] for lp in loops)
    return result, dict(
        wall_s=wall_s, b1=b1.launches, b2={"forward": b2.launches,
                                           "backward": b2.backward_launches},
        sampling_calls=len(loops), sampling_rows=[lp["rows"] for lp in loops],
        sampling_steps=steps, sampling_s=sampling_ms / 1e3,
        ms_per_denoiser_step=sampling_ms / steps if steps else None)


def hold_b1_launches(what, counts, layers, device):
    """B1's launches over a run: layers x the steps of its sampling loops."""
    want = layers * counts["sampling_steps"] * (device != "cpu")
    print(f"  B1 launches over {what}: {counts['b1']} (layers x steps x calls = {layers} x "
          f"{counts['sampling_steps']} over {counts['sampling_calls']} calls)")
    if counts["b1"] != want:
        raise AssertionError(f"{what}: B1 launches {counts['b1']} != {want}")


def a2m_train_args(save_dir, dataset, data_path, steps, extra=()):
    """train_mdm's arguments for an a2m CMDM, as a user passes them: the
    dataset from --data_path, --setting mdm --num_person 1 --body_model
    smpl, the default --arch (the offline trunk) at the flagship width,
    f32 batch 64."""
    from regennet_torch.utils import parser_util

    return parser_util.train_args([
        "--save_dir", str(save_dir), "--dataset", dataset, "--data_path", str(data_path),
        "--setting", "mdm", "--num_person", "1", "--body_model", "smpl",
        "--num_frames", str(A2M["T"]), "--batch_size", str(A2M["batch"]),
        "--num_steps", str(steps), "--steps_per_call", str(TRAIN["steps_per_call"]),
        "--save_interval", str(steps), "--log_interval", str(TRAIN["steps_per_call"]),
        "--seed", "0", "--layers", str(FLAGSHIP["layers"]),
        "--latent_dim", str(FLAGSHIP["latent_dim"]),
        "--diffusion_steps", str(FLAGSHIP["steps"]), *extra,
    ])


def write_a2m_assets(workdir):
    """The synthetic HumanAct12 and UESTC archives (the port's writers), a
    modi-struct array [N, 24, 3, T] of the unconstrained protocol and a
    random openpose ST-GCN saved as the port's .pt."""
    import numpy as np
    import torch

    from regennet_torch.data import synthetic
    from regennet_torch.models.stgcn import make_unconstrained_stgcn, random_init_

    T = A2M["T"]
    t0 = time.perf_counter()
    paths = {
        "humanact12": synthetic.write_humanact12_pkl(
            str(workdir / "HumanAct12Poses"), num_clips=A2M["clips"], min_len=T // 2,
            max_len=3 * T // 2),
        "uestc": synthetic.write_uestc_assets(
            str(workdir / "uestc"), num_videos=A2M["uestc_videos"], min_len=T,
            max_len=3 * T // 2),
        "modi_struct": str(workdir / "humanact12_modi_struct.npy"),
        "unconstrained_stgcn": str(workdir / "unconstrained_stgcn" / "model000000001.pt"),
    }
    rng = np.random.default_rng(11)
    motions = np.cumsum(rng.normal(size=(A2M["modi_struct"], 24, 3, T)) * 0.02, axis=-1)
    np.save(paths["modi_struct"], (motions + rng.normal(size=(1, 24, 3, 1))).astype(np.float32))
    os.makedirs(os.path.dirname(paths["unconstrained_stgcn"]))
    torch.save(random_init_(make_unconstrained_stgcn(), torch.Generator().manual_seed(12))
               .state_dict(), paths["unconstrained_stgcn"])
    return paths, time.perf_counter() - t0


A2M_GRU_METRICS = {f"{m}_{k}" for m in ("accuracy", "diversity", "multimodality", "fid")
                   for k in ("gen", "gt", "gt2")}


def run_a2m_eval(report, card, model_path, key, extra=(), device="cuda"):
    """eval_humanact12_uestc.main in debug mode on `model_path` (batch 64,
    guidance 1, a random classifier from --seed), B1's launches and each sampling
    loop counted around it, each classifier call timed; the results file
    against the returned metrics. Returns (metrics, counts)."""
    import numpy as np
    import torch

    from regennet_torch.eval import eval_humanact12_uestc, gru_eval, stgcn_eval, tools
    from regennet_torch.utils import parser_util

    args = parser_util.evaluation_parser([
        "--model_path", str(model_path), "--rec_model_path", "random", "--seed", "0",
        "--guidance_param", "1", "--batch_size", str(A2M["batch"]), *extra])
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    classifier_ms = []
    calls = {cls: cls.__call__ for cls in (gru_eval.A2MEvaluator, stgcn_eval.STGCNEvaluator)}

    def timed(call):
        def wrapped(self, *a):
            sync()
            t0 = time.perf_counter()
            out = call(self, *a)
            classifier_ms.append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapped

    for cls, call in calls.items():
        cls.__call__ = timed(call)
    try:
        result, counts = counted_run(lambda: eval_humanact12_uestc.main(args, device=device),
                                     device)
    finally:
        for cls, call in calls.items():
            cls.__call__ = call
    hold_b1_launches(f"eval_humanact12_uestc ({args.dataset}{', unconstrained' if args.unconstrained else ''})",
                     counts, args.layers, device)
    path = eval_humanact12_uestc.results_path(args)
    if tools.load_metrics(path) != result:
        raise AssertionError(f"{path} does not hold the returned metrics")
    feats = result["feats"]
    if args.dataset == "uestc":
        want = {f"accuracy_{k}_{s}" for k in ("gen", "gt") for s in ("train", "test")}
    else:
        want = set(A2M_GRU_METRICS)
        if args.unconstrained:
            want |= {"fid_unconstrained", "kid_unconstrained", "kid_std_unconstrained",
                     "diversity_gen_unconstrained", "diversity_gt_unconstrained"}
    per_seed = {k: v for k, v in feats.items() if isinstance(v, list)}
    nan_ok = {"accuracy_gen", "accuracy_gt", "accuracy_gt2", "multimodality_gen",
              "multimodality_gt", "multimodality_gt2"} if args.unconstrained else set()
    values = [float(x) for k, v in feats.items() if k not in nan_ok
              for x in (v if isinstance(v, list) else [v])]
    if set(feats) != want or not all(len(v) == args.num_seeds for v in per_seed.values()) \
            or not all(math.isfinite(x) for x in values):
        raise AssertionError(f"{key}: metrics {feats}")
    row = dict(metrics=feats, results_file=os.path.basename(path), dataset=args.dataset,
               unconstrained=args.unconstrained, diffusion_steps=args.diffusion_steps,
               classifier_calls=len(classifier_ms),
               classifier_ms_per_batch=float(np.mean(classifier_ms)), **counts)
    print(f"  {key}: wall {counts['wall_s']:.2f} s; {counts['sampling_calls']} sampling calls "
          f"({sum(counts['sampling_rows'])} rows, {counts['sampling_steps']} steps) "
          f"{counts['sampling_s']:.2f} s, {counts['ms_per_denoiser_step']:.3f} ms a denoiser "
          f"step; classifier {row['classifier_ms_per_batch']:.2f} ms a batch over "
          f"{len(classifier_ms)} batches [{card}]")
    report[key] = row
    return feats, counts


def check_a2m_classifiers(report, card, paths, device="cuda"):
    """The GRU classifier (cuDNN's GRU on the card) on decoded HumanAct12
    ground-truth batches, and the openpose ST-GCN on the modi-struct
    motions, on the card against CPU copies of the same weights: features
    and logits within 1e-4 x max(1, max|cpu|)."""
    import numpy as np
    import torch

    from regennet_torch.data.collate import collate
    from regennet_torch.data.get_data import BatchLoader, get_dataset
    from regennet_torch.eval import eval_humanact12_uestc, gru_eval
    from regennet_torch.eval import unconstrained as U
    from regennet_torch.models.stgcn import make_unconstrained_stgcn
    from regennet_torch.train import checkpoint

    data = get_dataset("humanact12", A2M["T"], data_path=paths["humanact12"], setting="mdm")
    gt = gru_eval._build_batches(None, None, BatchLoader(data, A2M["batch"], collate,
                                                         shuffle=False),
                                 4 * A2M["batch"], "gt", gru_eval.smpl_rot2xyz(device), device)
    args = Namespace(seed=0)
    on_card, on_cpu = (eval_humanact12_uestc.load_gru_evaluator(args, "random", d)
                       for d in (device, "cpu"))
    pairs = [(on_card(b["output_xyz"], b["lengths"]), on_cpu(b["output_xyz"], b["lengths"]))
             for b in gt]
    motions = np.load(paths["modi_struct"])[:4 * A2M["batch"], :15]
    models = [checkpoint.load_classifier_state(make_unconstrained_stgcn(),
                                          paths["unconstrained_stgcn"]).to(d)
              for d in (device, "cpu")]
    (f_card, y_card), (f_cpu, y_cpu) = (U.extract_unconstrained_features(m, motions)
                                        for m in models)
    pairs.append(({"features": f_card, "yhat": y_card}, {"features": f_cpu, "yhat": y_cpu}))
    worst = {}
    for i, (a, b) in enumerate(pairs):
        name = "unconstrained ST-GCN" if i == len(pairs) - 1 else "GRU classifier"
        for k in ("features", "yhat"):
            scale = max(1.0, float(np.abs(b[k]).max()))
            err = float(np.abs(a[k] - b[k]).max())
            hold(f"{name} {k} on the card vs the CPU", err, 1e-4 * scale)
            worst[name] = max(worst.get(name, 0.0), err / scale)
    print(f"  on the card vs a CPU copy: the GRU classifier over {len(gt)} decoded batches of "
          f"{A2M['batch']}, the unconstrained ST-GCN over {len(motions)} motions; features and "
          f"logits within 1e-4 x max(1, max|cpu|) (worst scaled "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()) + ")")
    report["a2m_classifiers_card_vs_cpu_worst_scaled"] = worst


def run_compute_accuracy(report, card, workdir, device="cuda"):
    """compute_accuracy.main on a random full-width ST-GCN (Chi3D, SMPL-X,
    two persons) saved as train_stgcn's model{epoch}.pt, over in-memory
    Chi3D clips at T 150."""
    import torch

    from regennet_torch.data import synthetic
    from regennet_torch.data.feeder import Feeder
    from regennet_torch.eval import compute_accuracy, tools
    from regennet_torch.models.stgcn import STGCN, random_init_

    T = FLAGSHIP["T"]
    path = workdir / "stgcn" / "model000000010.pt"
    path.parent.mkdir()
    torch.save(random_init_(STGCN(12, 8, num_person=2, layout="smplx"),
                            torch.Generator().manual_seed(13)).state_dict(), path)
    clips = synthetic.make_clip_pair("chi3d", num_clips=128, min_len=T + 10, max_len=2 * T)
    datasets = {split: Feeder(clips=clips[split], dataname="chi3d", split=split,
                              num_frames=T, num_person=2) for split in ("train", "test")}
    args = compute_accuracy.parse_args(["--checkpoint", str(path), "--data_path", "",
                                        "--num_frames", str(T)])
    t0 = time.perf_counter()
    acc = compute_accuracy.main(args, device=device, datasets=datasets)
    wall_s = time.perf_counter() - t0
    saved = tools.load_metrics(str(path.parent / "recognition_accuracies_on_samedata_10.yaml"))
    if set(acc) != {"train", "test"} or not all(0.0 <= v <= 1.0 for v in acc.values()) \
            or set(saved) != set(acc):
        raise AssertionError(f"compute_accuracy: {acc}, saved {saved}")
    print(f"  compute_accuracy: {acc} over {len(datasets['train'])} + {len(datasets['test'])} "
          f"clips, wall {wall_s:.2f} s [{card}]")
    report["a2m_compute_accuracy"] = dict(accuracies=acc, wall_s=wall_s)


def run_a2m(report, card, workdir, device="cuda"):
    """Phase 10, the single-person a2m path at the a2m CMDM's width (the
    offline trunk, 8 layers, latent 512, 4 heads, SMPL 25x6, T 60):
    train_mdm on HumanAct12 (A2M["steps"] f32 steps at batch 64, the
    legacy in-training evaluation after each save with a random GRU
    classifier); eval_humanact12_uestc (debug) on its checkpoint; an
    --unconstrained CMDM (a 50-step schedule) through the unconstrained
    protocol (1000 samples, a random openpose ST-GCN saved as the port's
    .pt, a synthetic modi-struct array); UESTC (A2M["uestc_steps"] steps,
    then eval_humanact12_uestc); compute_accuracy; the classifiers on the
    card against CPU copies. B1's and B2's launches are read around each
    run. Returns {"b1": launches, "b2": {forward, backward}}."""
    from regennet_torch.eval import eval_humanact12_uestc, gru_eval

    t_phase = time.perf_counter()
    paths, data_s = write_a2m_assets(workdir)
    layers, steps = FLAGSHIP["layers"], A2M["steps"]
    print(f"  synthetic assets: {A2M['clips']} HumanAct12 clips, {A2M['uestc_videos']} UESTC "
          f"videos, a [{A2M['modi_struct']}, 24, 3, {A2M['T']}] modi-struct array, written "
          f"in {data_s:.2f} s")
    b1, b2 = 0, {"forward": 0, "backward": 0}

    def add_b2(counts):
        for w in b2:
            b2[w] += counts[w]

    # HumanAct12: training with the legacy in-training evaluation
    evals = []
    evaluate = eval_humanact12_uestc.evaluate

    def recorded(*a, **kw):
        evals.append(evaluate(*a, **kw)["feats"])
        return {"feats": evals[-1]}

    save_dir = workdir / "humanact12"
    args = a2m_train_args(save_dir, "humanact12", paths["humanact12"], steps, (
        "--eval_during_training", "--rec_model_path", "random", "--eval_rep_times", "1",
        "--eval_batch_size", str(A2M["eval_batch"]), "--eval_num_samples",
        str(A2M["eval_samples"])))
    eval_humanact12_uestc.evaluate = recorded
    try:
        (loop, _, train_b2), counts = counted_run(
            lambda: run_training(report, card, save_dir, device, args, key="a2m_training"),
            device)
    finally:
        eval_humanact12_uestc.evaluate = evaluate
    del loop
    hold_b1_launches("the in-training evaluations", counts, layers, device)
    if len(evals) != 2 or not all(set(e) == A2M_GRU_METRICS and len(v) == 1
                                  for e in evals for v in e.values()):
        raise AssertionError(f"in-training evaluations: {evals}")
    b1 += counts["b1"]
    add_b2(train_b2)
    row = report["a2m_training"]
    row.update(evaluations=evals, eval_sampling=counts)
    print(f"  in-training evaluations: {len(evals)}, {counts['sampling_calls']} sampling calls "
          f"of {A2M['eval_batch']}, {counts['ms_per_denoiser_step']:.3f} ms a denoiser step; "
          f"accuracy_gen {[e['accuracy_gen'][0] for e in evals]} [{card}]")
    _, counts = run_a2m_eval(report, card, save_dir / f"model{steps:09d}.pt",
                             "a2m_eval_humanact12", device=device)
    b1 += counts["b1"]

    # the unconstrained protocol, on a CMDM trained without action conditioning
    save_dir = workdir / "unconstrained"
    args = a2m_train_args(save_dir, "humanact12", paths["humanact12"], A2M["uncon_steps"], (
        "--unconstrained", "--diffusion_steps", str(A2M["uncon_diffusion_steps"])))
    loop, _, train_b2 = run_training(report, card, save_dir, device, args,
                                     key="a2m_unconstrained_training")
    del loop
    add_b2(train_b2)
    built = []
    build = gru_eval._build_batches

    def recorded_build(sample_fn, generator, loader, num_samples, mode, *rest):
        batches = build(sample_fn, generator, loader, num_samples, mode, *rest)
        built.append((num_samples, sum(len(b["output"]) for b in batches)))
        return batches

    gru_eval._build_batches = recorded_build
    try:
        feats, counts = run_a2m_eval(
            report, card, save_dir / f"model{A2M['uncon_steps']:09d}.pt",
            "a2m_eval_unconstrained", ("--unconstrained_rec_path", paths["unconstrained_stgcn"],
                                       "--unconstrained_data_path", paths["modi_struct"]),
            device)
    finally:
        gru_eval._build_batches = build
    # the protocol scores its 1000 samples, or every whole batch of a
    # smaller dataset
    scored = [n for asked, n in built if asked == gru_eval.NUM_SAMPLES_UNCONSTRAINED]
    want = min(gru_eval.NUM_SAMPLES_UNCONSTRAINED, A2M["clips"] // A2M["batch"] * A2M["batch"])
    if scored != [want]:
        raise AssertionError(f"the unconstrained protocol scored {scored} motions, not {want}")
    print(f"  unconstrained protocol: {want} motions sampled and scored; fid_unconstrained "
          f"{feats['fid_unconstrained']}, kid_unconstrained {feats['kid_unconstrained']}")
    b1 += counts["b1"]

    # UESTC
    save_dir = workdir / "uestc_run"
    args = a2m_train_args(save_dir, "uestc", paths["uestc"], A2M["uestc_steps"])
    loop, _, train_b2 = run_training(report, card, save_dir, device, args,
                                     key="a2m_uestc_training")
    del loop
    add_b2(train_b2)
    _, counts = run_a2m_eval(report, card, save_dir / f"model{A2M['uestc_steps']:09d}.pt",
                             "a2m_eval_uestc", device=device)
    b1 += counts["b1"]

    run_compute_accuracy(report, card, workdir, device)
    check_a2m_classifiers(report, card, paths, device)
    wall_s = time.perf_counter() - t_phase
    print(f"  phase 10: {wall_s:.1f} s; B1 launches {b1}, B2 {b2} [{card}]")
    report["a2m"] = dict(wall_s=wall_s, data_s=data_s, launches={"b1": b1, "b2": b2},
                         training_ms_per_step=report["a2m_training"]["ms_per_step"])
    return {"b1": b1, "b2": b2}


def path_launches(paths, name, which=None):
    """A kernel's launches summed over the paths that ran it (`which`:
    "forward" or "backward" for B2's per-path dicts)."""
    return sum(v if which is None else v[which] for v in paths[name].values())


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    try:
        from regennet_torch.ops import attention, kernels
    except ImportError as e:
        print(f"chip_smoke: the regennet_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card = card_line()
    print(f"card: {card}")
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    built = kernels.build_kernels()
    for name, info in built.items():
        print(f"  built {name} in {info['seconds']:.2f} s")
        entry = ""
        for line in info["log"].splitlines():
            if "Compiling entry function" in line:  # the kernel, from its mangled name
                entry = re.sub(r"^.*?_cu_[0-9a-f]+\d+", "", line.split("'")[1])[:60]
            elif "registers" in line or "spill" in line:
                print(f"    {entry}: {line.strip()}")
    report["build_s"] = {k: v["seconds"] for k, v in built.items()}

    print("phase 2: the sampling attention kernel against its plain version")
    worst, flagship, eval_shape = check_attention_kernel(report, card)
    print("phase 2b: the training attention kernels against their plain version")
    train_worst, train_timing = check_train_kernels(report, card)
    print("phase 2c: fused_causal_attention on its path, against its plain version")
    causal_launches, causal_worst, causal_timing = check_causal_attention(report, card)
    print("phase 2d: B1 and B2 timed at the a2m CMDM's shape (phase 10's path)")
    a2m_b1_timing, a2m_b2_timing = time_a2m_kernels(report, card)
    print("phase 3: cgenerate at the flagship width")
    data, launches = run_requests(report, card)
    check_forward(report, data)
    print("phase 4: train_mdm on the flagship training configuration")
    with tempfile.TemporaryDirectory() as tmp:
        save_dir = Path(tmp) / "train"
        loop, loader, train_launches = run_training(report, card, save_dir)
        check_train_step(report, loop, loader)
        profile_train_step(report, loop, loader)
        sample_trained(report, save_dir, data)
        del loop, loader
        print("phase 5: the offline CMDM (the default --arch) at the flagship width")
        offline_train, offline_launches = run_offline(report, card, Path(tmp) / "offline",
                                                      data)
        print("phase 6: eval_cmdm (debug) on phase 4's checkpoint")
        eval_launches = run_eval(report, card, save_dir / f"model{TRAIN['steps']:09d}.pt")
        print("phase 7: the gru and mlp trunks at the flagship width")
        for arch in ("gru", "mlp"):
            run_trunk(report, card, Path(tmp) / arch, data, arch)
        print("phase 8: the learning guard (scripts/capability_study_torch.py, smokefit)")
        guard_worst = check_guard_kernels(report)
        guard = run_learning_guard(report, card, Path(tmp) / "guard")
        print("phase 9: bf16 training at the flagship width")
        bf16_train, bf16_b1 = run_bf16_training(report, card, Path(tmp) / "bf16", data)
        bf16_trunks = [run_bf16_trunk(report, card, Path(tmp) / f"bf16_{arch}", data, arch)
                       for arch in ("trans_enc", "gru", "mlp")]
        print("phase 10: the single-person a2m path (HumanAct12, UESTC) at the a2m width")
        a2m_worst = check_a2m_kernels(report)
        a2m = run_a2m(report, card, Path(tmp) / "a2m")
    bf16_b2 = {w: bf16_train[w] + sum(t[w] for t in bf16_trunks)
               for w in ("forward", "backward")}
    paths = {"fused_attention_btd": {"phase 3": launches, "phase 5": offline_launches,
                                     "phase 6": eval_launches,
                                     "phase 8": guard["fused_attention_btd"],
                                     "phase 9": bf16_b1, "phase 10": a2m["b1"]},
             "fused_attention_btd_train": {"phase 4": train_launches, "phase 5": offline_train,
                                           "phase 8": guard["fused_attention_btd_train"],
                                           "phase 9": bf16_b2, "phase 10": a2m["b2"]},
             "fused_causal_attention": {"phase 2c": causal_launches}}
    report["launches_by_path"] = paths

    b1 = paths["fused_attention_btd"]
    kernel_rows = [{
        "name": name,
        "route": "cuda",
        "source": "regennet_torch/csrc/attention_fwd.cu",
        "replaces": "regennet_tpu/ops/pallas_attention.py:222",
        "launches": launches,
        "max_abs_err": err,
        **{k: timing[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    } for name, launches, timing, err in (
        ("fused_attention_btd", path_launches(paths, "fused_attention_btd"), flagship,
         max(worst, guard_worst["forward"], a2m_worst["forward"])),
        # the evaluation's f32 batch-64 shape: phase 6's launches
        ("fused_attention_btd (f32 [64, 150, 512], phase 6)", b1["phase 6"], eval_shape,
         max(worst, guard_worst["forward"])),
        # the a2m evaluations' shape, non-causal at 61 tokens: phase 10's launches
        ("fused_attention_btd (f32 [64, 61, 512], non-causal, phase 10)", b1["phase 10"],
         a2m_b1_timing, a2m_worst["forward"]))]
    for dtype, which, line, source in (
            ("float32", "forward", 382, "attention_fwd.cu"),
            ("float32", "backward", 415, "attention_btd_train.cu"),
            ("bfloat16", "forward", 382, "attention_fwd.cu"),
            ("bfloat16", "backward", 415, "attention_btd_train.cu")):
        # B2's times by device time under torch.profiler; its f32 rows count
        # every path's launches, its bf16 rows phase 9's
        timing, worst_err = train_timing[dtype], train_worst[dtype]
        err = worst_err["forward" if which == "forward" else "backward_vjp"]
        if dtype == "float32":
            name = f"fused_attention_btd_train ({which})"
            launched = path_launches(paths, "fused_attention_btd_train", which)
            err = max(err, guard_worst["train_forward" if which == "forward" else "backward"],
                      a2m_worst["train_forward" if which == "forward" else "backward"])
        else:
            name = f"fused_attention_btd_train ({which}, bf16 [64, 150, 512], phase 9)"
            launched = paths["fused_attention_btd_train"]["phase 9"][which]
        kernel_rows.append({
            "name": name,
            "route": "cuda",
            "source": f"regennet_torch/csrc/{source}",
            "replaces": f"regennet_tpu/ops/pallas_attention.py:{line}",
            "launches": launched,
            "max_abs_err": err,
            "ms": timing[f"kernel_{which}_ms"],
            "plain_ms": timing[f"plain_{which}_ms"],
            "bound_ms": timing[f"{which}_bound_ms"],
            "bound_by": timing[f"{which}_bound_by"],
            "library_ms": timing[f"library_{which}_ms"],
        })
    for which, line, source in (("forward", 382, "attention_fwd.cu"),
                                ("backward", 415, "attention_btd_train.cu")):
        # the a2m training shape, non-causal at 61 tokens: phase 10's launches
        kernel_rows.append({
            "name": f"fused_attention_btd_train ({which}, f32 [64, 61, 512], non-causal, "
                    "phase 10)",
            "route": "cuda",
            "source": f"regennet_torch/csrc/{source}",
            "replaces": f"regennet_tpu/ops/pallas_attention.py:{line}",
            "launches": paths["fused_attention_btd_train"]["phase 10"][which],
            "max_abs_err": a2m_worst["train_forward" if which == "forward" else "backward"],
            "ms": a2m_b2_timing[f"kernel_{which}_ms"],
            "plain_ms": a2m_b2_timing[f"plain_{which}_ms"],
            "bound_ms": a2m_b2_timing[f"{which}_bound_ms"],
            "bound_by": a2m_b2_timing[f"{which}_bound_by"],
            "library_ms": a2m_b2_timing[f"library_{which}_ms"],
        })
    kernel_rows.append({
        "name": "fused_causal_attention",
        "route": "cuda",
        "source": "regennet_torch/csrc/attention_fwd.cu",
        "replaces": "regennet_tpu/ops/pallas_attention.py:74",
        "launches": causal_launches,
        "max_abs_err": causal_worst,
        **{k: causal_timing[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms")},
    })
    report["kernels"] = kernel_rows
    rate0 = train_timing["float32"]["kernel_forward_rate0_ms"]
    print(f"  training attention forward at rate 0 (B1's function): {rate0:.4f} ms; B1 f32 "
          f"[64, 150, 512] {eval_shape['ms']:.4f} ms (ratio {rate0 / eval_shape['ms']:.3f}) "
          f"[{card}]")
    report["total_s"] = time.perf_counter() - t_start
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(f"total {report['total_s']:.1f} s [{card}]")
    print(json.dumps({"kernels": kernel_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
