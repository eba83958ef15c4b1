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
     (the backward's row pass with P in shared memory); the forward's
     dropout mask against
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
  2d. B1 and B2 at the model paths' own f32 shapes, non-causal: phase
     10's [64, 61, 512], phase 11's [64, 197, 512] (the forward's and the
     backward's row pass's stored-row routes, P in shared memory; B1 and
     B2 also at bf16 there, as generate and train_mdm --dataset humanml
     --compute_dtype bfloat16 run them, B2's backward split by pass: no
     phase runs them at bf16, so the kernel line has no row for them),
     phase 14's CVAE at head dim 64,
     [20, 62, 256] and [20, 60, 256], and phase 15's GAN, D's [32, 60,
     256] and G's [32, 16, 256] (B2 at rate 0); and causal at head dim 32,
     the full-scale capability study's [64, 60, 128] (B2 at rate 0.1);
     timed by device time under torch.profiler beside their plain
     versions, SDPA and the bounds; and B2's second-order term (PyTorch
     ops) at the GAN's shapes;
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
     ST-GCN on the card against a CPU copy; then train_stgcn.main at a cut
     size (the full-width classifier, 256 learnable clips, 12 epochs: at
     4 its BatchNorm statistics had not settled and the held-out accuracy
     read chance) started with TF32 allowed, which must leave both TF32
     flags False, and the trained network's logits on a test batch and its
     GT accuracy without TF32 and with it;
  7. the gru and mlp trunks (cm_mode add) at the flagship width, each:
     train_mdm for 16 steps (f32 batch 64), a DDPM-1000 cgenerate request
     (f32 batch 16) from its checkpoint, one denoiser forward on the card
     against a CPU copy; the GRU's bias_hh r/z slices unchanged by training;
  8. the learning guard, scripts/capability_study_torch.py at its smokefit
     scale (a reduced ST-GCN trained on learnable clips, the online CMDM at
     latent 64 trained 800 steps, the eval_cmdm protocol over the
     checkpoint curve, the top-2 selection, then the random-init and
     oracle rows), held to the six thresholds of
     tests/test_capability_smoke.py; before it, B1 and B2 at its shapes
     (head dim 16: [32, 24 and 25, 64], 4 heads) and at the full scale's
     (head dim 32: [64, 60, 128], 4 heads, B2 at rate 0.1 with its dropout
     mask) against their plain versions;
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
     on the card against CPU copies;
  11. the text-to-motion path at the CLIs' default width (--dataset
     humanml, the offline trunk, 8 layers, latent 512, 263 features, the
     196-frame window: 197 tokens, non-causal): B1 (B 20 and 64) and B2
     (B 64) there against their plain versions; a seeded CLIP ViT-B/32 text
     tower saved as an OpenAI-layout .pt with a tiny merge table
     (REGENNET_CLIP_PATH and REGENNET_CLIP_BPE for the phase), its encoder
     on the card against a CPU copy; synthetic HumanML3D written by the
     port's writer, Mean/Std from the data; train_mdm --dataset humanml for
     16 f32 steps at batch 64; a step through the kernels against the plain
     attention; sample.generate on the checkpoint (10 samples of one
     prompt, CFG 2.5, DDPM 1000) and its results.npy; no caption or prompt
     falls back to the hashed text embeddings;
  12. the text evaluation on phase 11's data, CLIP tower and checkpoint,
     with a seeded GloVe archive of every caption and prompt word in
     ./glove: B1 at [64 and 32, 197, 512] against its plain version;
     train_t2m_eval --stage all at T2M_OPT's widths (3 epochs at batch 32
     per stage), each trained network on the card against a CPU copy;
     eval_humanml debug (CFG 2.5, DDPM 1000, the matching .pt as
     --rec_model_path); train_mdm --dataset humanml --eval_during_training
     (8 steps, one evaluation of 32 samples); generate --length_estimator;
     no word falls back to hashed GloVe vectors, no text to the hashed
     CLIP stand-in;
  13. the comp_v6 generator at its published widths (text hidden 512,
     attention 512, z 128, hidden 1024, one layer, movement latent 512: 49
     snippets at 196 frames) on phase 11's data and phase 12's decomp,
     evaluators, length estimator and GloVe archive: train_t2m_gen (2
     epochs at batch 32), its training forward on the card against a CPU
     copy, teacher forcing off and on; eval_humanml debug on its .pt with
     --length_estimator, every metric finite; the same state as a
     released-layout latest.tar giving the same log and the same generate
     output; a training step's and a prior sampling's device time under
     torch.profiler; generate's comp_v6 route for 4 prompts; motion_process
     on 8 seeded raw joint clips, the card against --device cpu. It runs
     no attention kernel, and fails if one launches;
  14. B1 and B2 at the ACTOR CVAE's head dim 64 ([20, 62 and 60, 256], 4
     heads, f32, non-causal) against their plain versions; sample.edit on
     phase 3's online CMDM (random weights, f32 batch 16, DDPM 1000, CFG
     off; in_between and upper_body) and on phase 11's text CMDM
     (upper_body on hml_vec features, one prompt, CFG 2.5), the last x_0
     prediction of every sample equal to the inpainted motion on every
     kept entry; the Predictor on phase 4's checkpoint (DDIM 50, CFG 2.5):
     two calls of one seed bit-identical and equal to cgenerate's output on
     the same noise; train_cvae at the JAX CLI's defaults (transformer, 4
     layers, latent 256, 4 heads, ff 1024, batch 20, SMPL-X 56 x 12, 60
     frames; no dropout, as the JAX trainer) for 16 steps on in-memory
     Chi3D clips (B2 at rate 0 8 times a step, B1 never), a step through
     the kernels against the plain attention, the trained model's forward
     on the card against a CPU copy; generate_sequences (2 classes x 2
     rows, --jointstype vertices) on a synthetic SMPL-X of the real size
     (10,475 vertices, 20,908 faces, in the official npz layout), 8 frames
     of its first mesh sequence rasterised at 224x224 on the card and 2
     of them held against the CPU. Launches are counted by T there.
     matplotlib and imageio are not on the GPU machine: every generate
     call passes --no-render, no video is written.
  15. B1 and B2 (rate 0) at the GAN's head dim 64 ([32, 60 and 16, 256],
     [4, 16, 256]) against their plain versions, and B2's second-order
     term (`_AttentionTrainBackward`, what a gradient penalty
     differentiates) against autograd's double backward of the plain
     version; train_gan at the JAX CLI's defaults (batch 32, 60 frames,
     SMPL-X 56 x 12, latent 256, 2 layers, 4 heads of 64, ff 512, 16 gp
     noise tokens of 32 channels) for 8 iterations in each loss mode,
     hinge and wgan-gp (--repeat_D 1), each D and G step timed and the
     launches by T and the second-order calls held to gan_launches; one
     d_step of each mode through the kernels against the plain attention
     (losses, gradients, updated parameters); gen_samples_per_class (2
     classes x 4, arrays only); evaluate_cvae debug on phase 14's CVAE
     (random ST-GCN, --other_metrics), every YAML value finite; the
     SMPLify fit (fit_sequence, 60 frames, 300 steps) on phase 14's SMPL-X
     of the real size, its first 5 losses against a CPU copy. Videos, h5
     dumps, joblib and the NTU split stay off the card (CPU tests).
  16. train_mdm on the flagship configuration (global batch 64) at
     --data_parallel 2 for 4 steps and at --tensor_parallel 2 for one (B1
     and B2 at 2 heads a rank, and a DDPM sample through the
     tensor-parallel model against one process on its weights), two
     ranks over gloo sharing the card (torch.multiprocessing), each held
     against train_mdm in this process on the same global batches
     (parameters and EMA within 1e-5 x max(1, max|p|) over the model,
     AdamW first moments within 1e-5 x max(1, max|m|), and within lr a
     step where the gradient is at most 1e-4 of its tensor's largest;
     losses printed); --data_parallel 1 and --param_sharding fsdp in a real
     NCCL group of one rank (the launcher's variables), FSDP against the
     replicated run and its checkpoint sampled by cgenerate; on the trained
     model at respaced 50, batch 16: plms_sample_loop at order 2 (51 model
     calls, held on a row against a CPU copy), ddim_reverse_sample_loop
     then ddim_sample_loop (the round trip's error printed), calc_bpd_loop
     (finite); torch_ckpt --check on every model file of phases 4-16. One
     card shows the collectives' correctness, not their cost.
Each kernel's launches are read around each path that runs it (phases 3,
5, 6, 8, 9, 10, 11, 12, 14 and 15 for B1; 4, 5, 8, 9, 10, 11, 12, 14 and
15 for B2; phase 16 for both; 2c for B3) and summed in the kernel line;
B1 has a second row at the evaluation's f32 batch-64 shape, with phase 6's
launches, a third at the a2m evaluations' [64, 61, 512], with phase 10's,
and a fourth at [64, 197, 512], with phases 11 and 12's; B2 has bf16 rows
at [64, 150, 512], with phase 9's launches, f32 rows at [64, 61, 512], with
phase 10's, and f32 rows at [64, 197, 512], with phases 11 and 12's; B1
and B2 have rows at the CVAE's [20, 62, 256] (the encoder) and [20, 60,
256] (the decoder), head dim 64, with phase 14's launches there, and at
the GAN's [32, 60, 256] (D; B1 there: evaluate_cvae's decode) and [32,
16, 256] (G), with phase 15's.
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.
Exits non-zero without CUDA, or without the regennet_torch package beside it.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
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


def _train_pair(B, T, dtype, causal, kv_len, rate, gen, softmax_f32=False, D=None, H=None,
                head0=None):
    """The training kernels and autograd of their plain version on one
    packed [B, T, 3D] input (q, k, v as strided column views), with the
    same seeds and dO: (out, dq, dk, dv) of the kernels, the same of the
    plain version, and (dq, dk, dv) of the backward kernel's plain version
    (the TPU kernel's rounding points); the softmax in f32 if softmax_f32.
    D and H default to the flagship's. head0: the seeds are [B, 3], their
    third word head0 (a tensor-parallel rank's first head)."""
    import torch

    from regennet_torch.ops import attention

    D, H = D or FLAGSHIP["latent_dim"], H or FLAGSHIP["heads"]
    td = getattr(torch, dtype)
    packed = torch.randn(B, T, 3 * D, device="cuda", generator=gen).to(td)
    dout = torch.randn(B, T, D, device="cuda", generator=gen).to(td)
    seeds = torch.randint(-2 ** 31, 2 ** 31, (B, 2), device="cuda", generator=gen,
                          dtype=torch.int32)
    if head0 is not None:
        seeds = torch.cat([seeds, torch.full((B, 1), head0, dtype=torch.int32,
                                             device="cuda")], dim=1)
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
# backward's row pass takes T 60 at 64 keys and 150, 151 at 160 with P in
# registers, T 200 with P in shared memory. T 200 is drawn last, so the cases
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


def train_mask(B, T, rate, seeds, causal, D=None, H=None):
    """The training forward's dropout mask [B, H, query, key], read from its
    output: with q = k = 0 every weight a query sees is 1 / (the keys it
    sees), and v one-hot in each head's columns (v[j, c] = 1 iff j = off +
    c) makes out[b, i, h, c] the weight of key off + c after dropout, or 0:
    one call for each hd keys. D and H default to the flagship's."""
    import torch

    from regennet_torch.ops import attention

    D, H = D or FLAGSHIP["latent_dim"], H or FLAGSHIP["heads"]
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


def device_events(fn, iters=20, attempts=3):
    """{name: (device ms, launches)} per call of fn(), the longest first:
    every CUDA kernel and memory operation of `iters` calls after a
    warm-up, summed under torch.profiler, over `iters`. The host's time
    between launches is not in it. A profile that recorded no device time
    (the profiler on that machine has returned one) is taken again, up to
    `attempts` profiles in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = {evt.key: (evt.device_time_total / 1e3 / iters, evt.count / iters)
                  for evt in prof.key_averages()
                  if evt.device_type == torch.autograd.DeviceType.CUDA}
        if sum(ms for ms, _ in events.values()) > 0:
            return dict(sorted(events.items(), key=lambda kv: -kv[1][0]))
    raise AssertionError(f"the profiler recorded no device time in {attempts} profiles")


def kernel_times(fn, iters=20, attempts=3):
    """Device time per call of fn() in ms, and per kernel name (the longest
    first), from device_events."""
    by_name = {k: ms for k, (ms, _) in device_events(fn, iters, attempts).items()}
    return sum(by_name.values()), by_name


def device_ms(fn, iters=20):
    """kernel_times' device time per call in ms."""
    return kernel_times(fn, iters)[0]


def time_train_kernels(card, dtype="float32", T=None, causal=True, B=None, D=None,
                       rate=None):
    """Forward and backward times at the flagship training shape (B = 64,
    T = 150, D = 512, 4 heads, rate 0.1, causal; or T, causal, B, D and
    rate as given) in `dtype`: the kernels, autograd of the
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

    B, D = B or TRAIN["batch"], D or FLAGSHIP["latent_dim"]
    H, rate = FLAGSHIP["heads"], TRAIN["rate"] if rate is None else rate
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


STGCN_TF32 = dict(clips=256, T=60, batch=64, epochs=12)  # the ST-GCN of check_stgcn_tf32


def tf32_flags():
    """(cuBLAS's, cuDNN's) allow_tf32."""
    import torch

    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


def check_stgcn_tf32(report, card, workdir, device="cuda"):
    """The ST-GCN trainer's f32 contract: train_stgcn.main at a cut size (the
    full-width classifier, Chi3D SMPL-X, two persons, STGCN_TF32's learnable
    clips and epochs) started with both TF32 flags True must leave them
    False; then the trained network's logits on one test batch and its
    accuracy on the held-out clips (GT accuracy) without TF32 and with it,
    side by side. Returns the comparison."""
    import copy

    import torch

    from regennet_torch.data import synthetic
    from regennet_torch.data.collate import collate
    from regennet_torch.data.feeder import Feeder
    from regennet_torch.data.get_data import BatchLoader
    from regennet_torch.device import tf32_allowed
    from regennet_torch.eval import train_stgcn

    T, B = STGCN_TF32["T"], STGCN_TF32["batch"]
    pair = synthetic.make_clip_pair("chi3d", STGCN_TF32["clips"], min_len=T + 10,
                                    max_len=2 * T, learnable=True)
    data = Feeder(clips=pair["train"], test_clips=pair["test"], dataname="chi3d",
                  split="train", num_frames=T, num_person=2)
    args = Namespace(dataset="chi3d", data_path="", pose_rep="rot6d", body_model="smplx",
                     glob=True, translation=True, num_frames=T, batch_size=B, lr=1e-3,
                     num_epochs=STGCN_TF32["epochs"], save_every=STGCN_TF32["epochs"],
                     save_dir=str(workdir / "stgcn_tf32"), seed=0, keep_best=False)
    with tf32_allowed():
        before = tf32_flags()
        model = train_stgcn.main(args, device=device, data=data)
        after = tf32_flags()
    if before != (True, True) or after != (False, False):
        raise AssertionError(f"train_stgcn.main left the TF32 flags at {after} (from {before})")
    test = copy.deepcopy(data)
    test.split = "test"
    loader = BatchLoader(test, B, collate, shuffle=False, drop_last=False)
    motion = torch.as_tensor(next(iter(loader))[0], device=device)
    seen = {}
    with torch.no_grad():
        for name, scope in (("f32", contextlib.nullcontext), ("tf32", tf32_allowed)):
            with scope():
                seen[name] = (model(motion)["yhat"].float().cpu(),
                              train_stgcn.held_out_accuracy(model, loader, device))
    (logits, acc), (logits_tf32, acc_tf32) = seen["f32"], seen["tf32"]
    diff = (logits_tf32 - logits).abs().max().item()
    res = dict(flags_before=before, flags_after=after, batch=int(motion.shape[0]),
               test_clips=len(test), logits_max_abs_diff=diff,
               logits_max_abs=logits.abs().max().item(),
               argmax_agreement=(logits_tf32.argmax(1) == logits.argmax(1)).float().mean().item(),
               gt_accuracy_f32=acc, gt_accuracy_tf32=acc_tf32)
    if not math.isfinite(diff):
        raise AssertionError(f"the ST-GCN's logits are not finite: {res}")
    print(f"  train_stgcn.main left the TF32 flags {after} (set {before}); trained ST-GCN, "
          f"one test batch of {res['batch']}: logits max |TF32 - f32| {diff:.4g} (max |logit| "
          f"{res['logits_max_abs']:.4g}), argmax agreement {res['argmax_agreement']:.4f}; "
          f"GT accuracy over {res['test_clips']} clips f32 {acc:.4f}, TF32 {acc_tf32:.4f} "
          f"[{card}]")
    report["stgcn_tf32"] = res
    return res


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


def hold_kernels_at(b1_shapes, b2_shapes, causal, D, H, seed, rate=None, head0=None):
    """B1 at each (B, T, dtype) of b1_shapes, and B2 (at `rate`, TRAIN["rate"]
    when None, forward and backward) at each of b2_shapes, on [B, T, D] inputs with H
    heads, against their plain versions as phases 2 and 2b hold them; B2's
    seeds [B, 3] with third word head0 when given, else [B, 2].
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
        rate_b2 = TRAIN["rate"] if rate is None else rate
        ours, plain, vjp = _train_pair(B, T, dtype, causal, None, rate_b2, gen, D=D, H=H,
                                       head0=head0)
        case = dict(kernel="fused_attention_btd_train", B=B, T=T, D=D, heads=H, dtype=dtype,
                    causal=causal, rate=rate_b2, head0=head0)
        err = max_abs_err(ours[0], plain[0])
        hold(f"{what}: out", err, TOLERANCE[dtype] * max(1.0, float(plain[0].float().abs().max())))
        worst["train_forward"] = max(worst["train_forward"], err)
        case["out_err"] = err
        for name, a, b, c in zip(("dq", "dk", "dv"), ours[1:], plain[1:], vjp):
            case[f"{name}_err"] = hold_gradient(f"{what}: {name}", a, b, c, dtype)[0]
            err_vjp = max_abs_err(a, c)
            tol_vjp = TOLERANCE_VJP[dtype] * max(1.0, float(c.float().abs().max()))
            hold(f"{what}: {name} against the plain backward", err_vjp, tol_vjp)
            worst["backward"] = max(worst["backward"], err_vjp)
            case[f"{name}_vjp_err"] = err_vjp
            case[f"{name}_vjp_share"] = err_vjp / tol_vjp  # of its tolerance
        cases.append(case)
    return worst, cases


def check_guard_kernels(report):
    """B1 and B2 against their plain versions, as phases 2 and 2b hold them,
    at the learning guard's shapes (f32, 4 heads of 16, B 32, T 24 and 25,
    causal, B2 at its dropout 0.1) and at the full-scale capability study's
    (f32, 4 heads of 32, T 60, causal: B1 at [64, 60, 128], CFG's fold of
    the curve's protocol batch of 32, and at [192, 60, 128], the headline's
    three stacked seeds; B2 at the training batch, [64, 60, 128], rate
    0.1); B2's dropout mask at head dim 32 against dropout_bits, its keep
    fraction within 0.005 of 0.9. Returns the worst errors."""
    import torch

    from regennet_torch.ops import attention

    shapes = [(32, T, "float32") for T in (24, 25)]
    worst, cases = hold_kernels_at(shapes, shapes, True, 64, 4, seed=6)
    full = load_capability_study().SCALES["full"]
    B, T, D, H, rate = full["batch"], full["frames"], full["latent"], 4, TRAIN["rate"]
    rows = 2 * 32  # CFG's 2B of the protocol batch
    w, c = hold_kernels_at([(rows, T, "float32"), (full["seeds"] * rows, T, "float32")],
                           [(B, T, "float32")], True, D, H, seed=7, rate=rate)
    worst = {k: max(v, w[k]) for k, v in worst.items()}
    report["guard_kernel_cases"] = cases + c
    gen = torch.Generator(device="cuda").manual_seed(8)
    seeds = torch.randint(-2 ** 31, 2 ** 31, (B, 2), device="cuda", generator=gen,
                          dtype=torch.int32)
    kept = train_mask(B, T, rate, seeds, True, D, H)
    seen = torch.ones(T, T, dtype=torch.bool, device="cuda").tril()
    want = (attention.dropout_bits(seeds, B, H, T) >= attention.dropout_threshold(rate)) & seen
    frac = float(kept.sum()) / (B * H * float(seen.sum()))
    if not (torch.equal(kept, want) and abs(frac - (1 - rate)) <= 0.005):
        raise AssertionError(f"phase 8: B2's dropout mask at [{B}, {T}, {D}], {H} heads (keep "
                             f"fraction {frac}) differs from dropout_bits")
    report["guard_full_mask"] = dict(rate=rate, keep_fraction=frac)
    print(f"  B1 and B2 at head dim 16 ([32, 24 and 25, 64]) and 32 (B1 at [{rows} and "
          f"{full['seeds'] * rows}, {T}, {D}], B2 at [{B}, {T}, {D}]), 4 heads, f32, causal, "
          f"B2 at rate {rate}, match their plain versions (worst max_abs_err B1 "
          f"{worst['forward']:.3g}, B2 forward {worst['train_forward']:.3g}, backward "
          f"{worst['backward']:.3g} against the plain backward; tolerance 1e-5 x max(1, "
          f"max|plain|)); B2's mask at head dim 32 equals dropout_bits (keep fraction "
          f"{frac:.5f})")
    return worst


def run_learning_guard(report, card, workdir, device="cuda"):
    """Phase 8: the learning guard in process (the smokefit scale: its
    checkpoint curve, the top-2 selection, the trained, random-init and
    oracle rows), its launches of B1 (its sampling: layers x the steps of
    its sampling calls) and B2 (its CMDM training, layers x steps each way)
    read around it, and its six thresholds. Returns {kernel: launches}."""
    study = load_capability_study()
    results, counts = counted_run(lambda: study.run_study(device, str(workdir)), device)
    launches = {"fused_attention_btd": counts["b1"],
                "fused_attention_btd_train": counts["b2"]}
    train = results["cmdm_training"]
    on_card = device != "cpu"
    want = {"fused_attention_btd": train["layers"] * counts["sampling_steps"] * on_card,
            "fused_attention_btd_train": {w: train["layers"] * train["steps"] * on_card
                                          for w in ("forward", "backward")}}
    print(f"  launches: B1 {launches['fused_attention_btd']} (layers x steps = "
          f"{train['layers']} x {counts['sampling_steps']} over {counts['sampling_calls']} "
          f"sampling calls), B2 {launches['fused_attention_btd_train']} (layers x steps = "
          f"{train['layers']} x {train['steps']} each)")
    if launches != want:
        raise AssertionError(f"learning guard launches {launches} != {want}")
    walls = results["walls_s"]
    print("  stage walls: " + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items())
          + f"; total {results['total_s']:.2f} s [{card}]")
    for point in results["fid_vs_step"]:
        print(f"  curve, step {point['step']}: accuracy_gen_train "
              f"{point['accuracy_gen_train']:.4f}, accuracy_gen_test "
              f"{point['accuracy_gen_test']:.4f}, fid_gen_test {point['fid_gen_test']:.6g}")
    sel = results["selection"]
    print(f"  selection: candidates {sel['candidates']} x guidance {sel['guidance_sweep']}; "
          f"chosen (step, guidance) ({sel['chosen_step']}, {sel['chosen_guidance']})")
    for row in ("trained", "random_init", "oracle"):
        print(f"  {row}: accuracy_gen_test {results[row]['accuracy_gen_test']['mean']:.4f}, "
              f"fid_gen_test {results[row]['fid_gen_test']['mean']:.6g}")
    print(f"  evaluator GT accuracy {results['evaluator']['gt_test_accuracy']:.4f}")
    report["learning_guard"] = dict(results, launches=launches,
                                    sampling_calls=counts["sampling_calls"],
                                    wall_s=counts["wall_s"])
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


def time_btd_kernels(card, T, B=None, D=None, rate=None, causal=False, dtype="float32"):
    """B1 and B2 at f32 [64, T, 512] (or [B, T, D], or `dtype`), 4 heads,
    non-causal unless `causal`, by device time under torch.profiler, beside
    their plain versions, SDPA and the bounds (B2 as phase 2b times it, at
    `rate` if given). At 61 tokens a launch takes about as long as the host
    needs to enqueue it, so the CUDA-event time of back-to-back calls (B1's
    *_wall_ms) reads the host. Returns (B1's timing, B2's timing)."""
    import torch
    import torch.nn.functional as F

    from regennet_torch.ops import attention

    D, H, B = D or FLAGSHIP["latent_dim"], FLAGSHIP["heads"], B or TRAIN["batch"]
    gen = torch.Generator(device="cuda").manual_seed(11)
    q, k, v = (torch.randn(B, T, 3 * D, device="cuda", generator=gen).to(getattr(torch, dtype))
               .split(D, dim=-1))
    q4, k4, v4 = (x.view(B, T, H, D // H).transpose(1, 2) for x in (q, k, v))
    b1_timing = {}
    for name, fn, iters in (
            ("", lambda: attention.fused_attention_btd(q, k, v, H, causal), 20),
            ("plain_", lambda: attention.attention_btd_reference(q, k, v, H, causal), 5),
            ("library_", lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                                is_causal=causal), 20)):
        b1_timing[f"{name}ms"] = device_ms(fn, iters=iters)
        b1_timing[f"{name}wall_ms"] = time_ms(fn, iters=iters)
    b1_timing["bound_ms"], b1_timing["bound_by"] = attention_bound_ms(
        B, T, D, H, dtype, causal, None)
    print(f"  B1 {dtype} [{B}, {T}, {D}] {'causal' if causal else 'non-causal'}, device time (wall "
          "with launches): kernel "
          + ", ".join(f"{label}{b1_timing[name + 'ms']:.4f} ms ({b1_timing[name + 'wall_ms']:.4f})"
                      for name, label in (("", ""), ("plain_", "plain "),
                                          ("library_", "sdpa ")))
          + f", bound {b1_timing['bound_ms']:.4f} ms ({b1_timing['bound_by']}) [{card}]")
    return b1_timing, time_train_kernels(card, dtype, T=T, causal=causal, B=B, D=D, rate=rate)


def time_model_kernels(report, card):
    """Phase 2d: B1 and B2 timed at the model paths' own shapes: phase 10's
    a2m CMDM (f32 [64, 61, 512], non-causal), phase 11's text CMDM (197
    tokens: the forward's and the backward's row pass's stored-row routes,
    P in shared memory; B1 and B2 also at bf16, B2's backward split by pass,
    under "t2m_bf16") and
    the full-scale capability study's online CMDM (f32 [64, 60, 128], head
    dim 32, causal, B2 at rate 0.1). Timed here, beside phase 2b's
    profiles, not in phases 10 and 11: in one full run a profile of B1
    taken in phase 10 recorded no kernel, which a run of phase 10 alone did
    not repeat. Returns {"a2m": (B1's timing, B2's timing), "t2m": (...),
    "study": (...), "t2m_bf16": (...)}."""
    full = load_capability_study().SCALES["full"]
    timings = {}
    for key, T, kw in (("a2m", A2M["T"] + 1, {}), ("t2m", T2M["T"] + 1, {}),
                       ("study", full["frames"], dict(B=full["batch"], D=full["latent"],
                                                      causal=True))):
        b1_timing, b2_timing = timings[key] = time_btd_kernels(card, T, **kw)
        report[f"{key}_attention_timing"] = {"fused_attention_btd": b1_timing,
                                             "fused_attention_btd_train": b2_timing}
    b1_timing, b2_timing = timings["t2m_bf16"] = time_btd_kernels(card, T2M["T"] + 1,
                                                                  dtype="bfloat16")
    report["t2m_bf16_attention_timing"] = {"fused_attention_btd": b1_timing,
                                           "fused_attention_btd_train": b2_timing}
    return timings


def counted_run(fn, device="cuda"):
    """fn() with B1's and B2's launch counts, in all and by T, and the calls
    of B2's second-order term, set to 0 before it and read after it, each
    sampling loop it runs, DDPM or DDIM, counted (its rows, its steps and
    its device-synchronised ms), and its wall. Returns (fn's result,
    counts)."""
    import torch

    from regennet_torch.diffusion import sampling
    from regennet_torch.ops import attention

    b1, b2 = attention.fused_attention_btd, attention.fused_attention_btd_train
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    loops = []
    originals = {name: getattr(sampling, name) for name in ("p_sample_loop",
                                                            "ddim_sample_loop")}

    def counting(loop):
        def counted(sched, cfg, model_fn, shape, *rest, **kw):
            sync()
            t0 = time.perf_counter()
            out = loop(sched, cfg, model_fn, shape, *rest, **kw)
            sync()
            loops.append(dict(rows=shape[0], steps=sched.num_timesteps,
                              ms=(time.perf_counter() - t0) * 1e3))
            return out

        return counted

    b1.launches = b2.launches = b2.backward_launches = b2.double_backward_launches = 0
    for by_tokens in (b1.launches_by_tokens, b2.launches_by_tokens,
                      b2.backward_launches_by_tokens):
        by_tokens.clear()
    for name, loop in originals.items():
        setattr(sampling, name, counting(loop))
    try:
        t0 = time.perf_counter()
        result = fn()
        sync()
        wall_s = time.perf_counter() - t0
    finally:
        for name, loop in originals.items():
            setattr(sampling, name, loop)
    sampling_ms = sum(lp["ms"] for lp in loops)
    steps = sum(lp["steps"] for lp in loops)
    return result, dict(
        wall_s=wall_s, b1=b1.launches, b2={"forward": b2.launches,
                                           "backward": b2.backward_launches},
        b2_double=b2.double_backward_launches,
        b1_by_T=dict(b1.launches_by_tokens),
        b2_by_T={"forward": dict(b2.launches_by_tokens),
                 "backward": dict(b2.backward_launches_by_tokens)},
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


# phase 11: the text-to-motion CMDM of the CLIs' defaults (the offline trunk,
# 8 layers, latent 512, HumanML3D's 263 features at its 196-frame window: 197
# tokens), trained on synthetic HumanML, sampled with CFG from a prompt
T2M = dict(T=196, batch=64, steps=16, clips=1024, samples=10, guidance=2.5,
           prompt="a person walks forward and turns left")
# the CLIP ViT-B/32 text tower (random weights from a seed)
CLIP_TOWER = dict(vocab_size=49408, context_length=77, dim=512, heads=8, num_layers=12,
                  proj_dim=512)
# a tiny BPE merge table: the public one is not in the repository
BPE_MERGES = [("a", "</w>"), ("p", "e"), ("r", "s"), ("pe", "rs"), ("o", "n</w>"),
              ("pers", "on</w>"), ("w", "a"), ("l", "k"), ("wa", "lk"), ("s", "</w>"),
              ("walk", "s</w>"), ("t", "u"), ("r", "n"), ("tu", "rn"), ("turn", "s</w>")]


def t2m_paths(workdir):
    """Phase 11's files in its workdir: the HumanML3D root, the CLIP tower
    and merge table, and the trained text CMDM (phase 12 reads them)."""
    return {"humanml": str(workdir / "HumanML3D"), "clip": str(workdir / "ViT-B-32.pt"),
            "bpe": str(workdir / "bpe_simple_vocab_16e6.txt.gz"),
            "model": str(workdir / "humanml_run" / f"model{T2M['steps']:09d}.pt")}


@contextlib.contextmanager
def clip_tower(paths):
    """REGENNET_CLIP_PATH and REGENNET_CLIP_BPE name the seeded tower and
    merge table inside the block, restored after it; yields the list of
    calls to the hashed stand-in for CLIP made inside it (each one's text
    count)."""
    from regennet_torch.models import clip_text

    hashed = clip_text.hashed_text_embeddings
    fallbacks = []

    def counted_hashed(texts, *a, **kw):
        fallbacks.append(len(texts))
        return hashed(texts, *a, **kw)

    env = {k: os.environ.get(k) for k in ("REGENNET_CLIP_PATH", "REGENNET_CLIP_BPE")}
    os.environ.update(REGENNET_CLIP_PATH=paths["clip"], REGENNET_CLIP_BPE=paths["bpe"])
    clip_text.hashed_text_embeddings = counted_hashed
    try:
        yield fallbacks
    finally:
        clip_text.hashed_text_embeddings = hashed
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def write_t2m_assets(workdir):
    """Synthetic HumanML3D (the port's writer: T2M["clips"] clips of 40-199
    frames, every one in the train split), its Mean.npy and Std.npy from the
    data, the CLIP text tower saved as an OpenAI-layout ViT-B-32.pt and a
    tiny merge table. Returns (paths, seconds)."""
    import gzip

    import numpy as np
    import torch

    from regennet_torch.data.humanml.dataset import write_synthetic_humanml
    from regennet_torch.models.clip_text_tower import ClipTextTower

    t0 = time.perf_counter()
    root = write_synthetic_humanml(str(workdir / "HumanML3D"), num_clips=T2M["clips"],
                                   seed=0, min_len=40, max_len=T2M["T"] + 4)
    clips = [np.load(path) for path in sorted((workdir / "HumanML3D" / "new_joint_vecs")
                                              .glob("*.npy"))]
    frames = np.concatenate(clips).astype(np.float64)
    np.save(os.path.join(root, "Mean.npy"), frames.mean(0).astype(np.float32))
    np.save(os.path.join(root, "Std.npy"), frames.std(0).astype(np.float32))
    tower = ClipTextTower(**CLIP_TOWER)
    tower.reset_parameters(torch.Generator().manual_seed(13))
    paths = t2m_paths(workdir)
    torch.save(tower.state_dict(), paths["clip"])
    with gzip.open(paths["bpe"], "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(" ".join(m) for m in BPE_MERGES))
    return paths, time.perf_counter() - t0


def check_clip_tower(report, card, prompts, device="cuda"):
    """The CLIP text encoder of REGENNET_CLIP_PATH on the card against a
    CPU copy, f32, within 1e-5 x max(1, max|cpu|)."""
    import torch

    from regennet_torch.models import clip_text

    encoder = clip_text.ClipTextEncoder(device=device)
    t0 = time.perf_counter()
    ours = encoder(prompts)
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    sync()
    encode_ms = (time.perf_counter() - t0) * 1e3
    ref = clip_text.ClipTextEncoder(device="cpu")(prompts)
    err, tol = max_abs_err(torch.tensor(ours), torch.tensor(ref)), 1e-5 * max(
        1.0, float(abs(ref).max()))
    hold(f"the CLIP text tower on {device} against its CPU copy", err, tol)
    print(f"  CLIP text tower ({CLIP_TOWER['num_layers']} layers, width {CLIP_TOWER['dim']}, "
          f"vocab {CLIP_TOWER['vocab_size']}) on {device}: {len(prompts)} prompts in "
          f"{encode_ms:.1f} ms (the first call), max_abs_err {err:.3g} against a CPU copy "
          f"(tolerance {tol:.3g}) [{card}]")
    report["t2m_clip_tower"] = dict(prompts=len(prompts), encode_ms=encode_ms,
                                    max_abs_err=err, tolerance=tol, shape=list(ours.shape))


def check_t2m_kernels(report):
    """Phase 11: B1 (non-causal, f32 and bf16, B 2 x T2M["samples"]: the
    generate request's CFG batch, and B 64) and B2 (f32 and bf16, [64, 197,
    512], rate 0.1, forward and backward) at the text CMDM's 197 tokens
    against their plain versions, at phases 2 and 2b's tolerances. Returns
    the worst errors."""
    D, H, T, B = FLAGSHIP["latent_dim"], FLAGSHIP["heads"], T2M["T"] + 1, T2M["batch"]
    dtypes = ("float32", "bfloat16")
    worst, report["t2m_kernel_cases"] = hold_kernels_at(
        [(b, T, dtype) for b in (2 * T2M["samples"], B) for dtype in dtypes],
        [(B, T, dtype) for dtype in dtypes], False, D, H, seed=12)
    print(f"  B1 at [{2 * T2M['samples']} and {B}, {T}, {D}] and B2 at [{B}, {T}, {D}] "
          f"(non-causal, f32 and bf16, B2 at rate {TRAIN['rate']}) match their plain versions "
          f"(worst max_abs_err B1 {worst['forward']:.3g}, B2 forward "
          f"{worst['train_forward']:.3g}, backward {worst['backward']:.3g} against the plain "
          "backward; tolerances of phases 2 and 2b)")
    shares = {f"{c['dtype']} {name}": c[f"{name}_vjp_share"]
              for c in report["t2m_kernel_cases"] if "dq_vjp_share" in c
              for name in ("dq", "dk", "dv")}
    print("  B2's backward against the plain backward at 197 tokens, share of the tolerance: "
          + ", ".join(f"{k} {v:.3f}" for k, v in shares.items()))
    return worst


def t2m_train_args(save_dir, data_path):
    """train_mdm's arguments for the text CMDM, as a user passes them: the
    CLI's defaults (--dataset humanml, --arch trans_enc, --setting mdm,
    batch 64, DDPM 1000) at the flagship width, T2M["steps"] f32 steps."""
    from regennet_torch.utils import parser_util

    return parser_util.train_args([
        "--save_dir", str(save_dir), "--dataset", "humanml", "--data_path", str(data_path),
        "--batch_size", str(T2M["batch"]), "--num_steps", str(T2M["steps"]),
        "--steps_per_call", str(TRAIN["steps_per_call"]), "--save_interval",
        str(T2M["steps"]), "--log_interval", str(TRAIN["steps_per_call"]), "--seed", "0",
        "--layers", str(FLAGSHIP["layers"]), "--latent_dim", str(FLAGSHIP["latent_dim"]),
        "--diffusion_steps", str(FLAGSHIP["steps"])])


def run_t2m(report, card, workdir, device="cuda"):
    """Phase 11, the text-to-motion path at the CLIs' default width: the
    CLIP tower on the card against a CPU copy (REGENNET_CLIP_PATH and
    REGENNET_CLIP_BPE name a seeded ViT-B/32 text tower and a tiny merge
    table for the phase); train_mdm --dataset humanml on synthetic HumanML
    (T2M["steps"] f32 steps at batch 64: B2 at 197 tokens) with its B2
    launches; a step through the kernels against the plain attention; then
    sample.generate on the checkpoint (--num_samples 10, CFG 2.5, DDPM
    1000: B1 at [20, 197, 512]) with its B1 launches, and its results.npy.
    No caption or prompt takes the hashed stand-in for CLIP. Returns
    {"b1": launches, "b2": {forward, backward}}."""
    import numpy as np

    from regennet_torch.sample import generate
    from regennet_torch.utils import parser_util

    t_phase = time.perf_counter()
    paths, data_s = write_t2m_assets(workdir)
    print(f"  synthetic HumanML3D: {T2M['clips']} clips of 40-{T2M['T'] + 3} frames with "
          f"Mean/Std from the data, a seeded CLIP text tower and a merge table, written in "
          f"{data_s:.2f} s")
    layers = FLAGSHIP["layers"]
    with clip_tower(paths) as fallbacks:
        check_clip_tower(report, card, [T2M["prompt"], "a person walks forward",
                                        "a person turns"], device)
        save_dir = workdir / "humanml_run"
        args = t2m_train_args(save_dir, paths["humanml"])
        loop, loader, b2 = run_training(report, card, save_dir, device, args,
                                        key="t2m_training")
        check_train_step(report, loop, loader, key="t2m_train_step_check")
        del loop, loader

        out_dir = workdir / "generate"
        gen_args = parser_util.generate_args([
            "--model_path", paths["model"],
            "--data_path", paths["humanml"], "--text_prompt", T2M["prompt"],
            "--num_samples", str(T2M["samples"]), "--guidance_param", str(T2M["guidance"]),
            "--output_dir", str(out_dir), "--no-render"])
        _, counts = counted_run(lambda: generate.main(gen_args, device=device), device)
    hold_b1_launches("the generate request", counts, layers, device)
    if counts["sampling_rows"] != [T2M["samples"]]:
        raise AssertionError(f"generate sampled {counts['sampling_rows']} rows")
    if fallbacks:
        raise AssertionError(f"the hashed text embeddings stood in for CLIP: {fallbacks}")
    results = np.load(out_dir / "results.npy", allow_pickle=True).item()
    frames = min(int(gen_args.motion_length * 20), T2M["T"])  # HumanML3D: 20 fps
    shapes = {k: np.shape(results[k]) for k in ("motion", "feature", "lengths")}
    want = {"motion": (T2M["samples"], frames, 22, 3), "feature": (T2M["samples"], frames, 263),
            "lengths": (T2M["samples"],)}
    if set(results) != {"motion", "feature", "text", "lengths", "num_samples"} or \
            shapes != want or results["text"] != [T2M["prompt"]] * T2M["samples"] or \
            not np.isfinite(results["motion"]).all():
        raise AssertionError(f"results.npy: keys {sorted(results)}, shapes {shapes}")
    wall_s = time.perf_counter() - t_phase
    print(f"  generate: {T2M['samples']} motions of {frames} frames from one prompt, CFG "
          f"{T2M['guidance']} (one forward at batch {2 * T2M['samples']}), "
          f"{counts['sampling_steps']} steps in {counts['sampling_s']:.2f} s "
          f"({counts['ms_per_denoiser_step']:.3f} ms a denoiser step), the request "
          f"{counts['wall_s']:.2f} s; motion [{', '.join(map(str, want['motion']))}] finite "
          f"[{card}]")
    print(f"  phase 11: {wall_s:.1f} s; B1 launches {counts['b1']}, B2 {b2}; no hashed text "
          f"embeddings [{card}]")
    report["t2m"] = dict(wall_s=wall_s, data_s=data_s, generate=counts,
                         launches={"b1": counts["b1"], "b2": b2},
                         training_ms_per_step=report["t2m_training"]["ms_per_step"],
                         motion_shape=list(want["motion"]))
    return {"b1": counts["b1"], "b2": b2}


# phase 12: the text evaluation on phase 11's data, CLIP tower and checkpoint
T2M_EVAL = dict(epochs=3, batch=32, train_steps=8, eval_samples=32, lengths=4,
                guidance=2.5, seed=14)


def write_glove(root, words, seed=0):
    """A seeded GloVe archive in the released layout (our_vab_data.npy,
    our_vab_words.pkl, our_vab_idx.pkl) holding `words`."""
    import pickle

    import numpy as np

    os.makedirs(root, exist_ok=True)
    words = sorted(words)
    np.save(os.path.join(root, "our_vab_data.npy"), np.random.default_rng(seed).normal(
        scale=0.3, size=(len(words), 300)).astype(np.float32))
    with open(os.path.join(root, "our_vab_words.pkl"), "wb") as f:
        pickle.dump(words, f)
    with open(os.path.join(root, "our_vab_idx.pkl"), "wb") as f:
        pickle.dump({w: i for i, w in enumerate(words)}, f)
    return root


def caption_words(humanml_root, prompts):
    """Every word of the dataset's token lists and of the prompts, and the
    sentence markers."""
    words = {"sos", "eos", "unk"}
    for path in Path(humanml_root, "texts").glob("*.txt"):
        for line in path.read_text().splitlines():
            parts = line.split("#")
            if len(parts) > 1:
                words.update(tok.split("/")[0] for tok in parts[1].split())
    for prompt in prompts:
        words.update(prompt.split())
    return words


@contextlib.contextmanager
def word_vectorizers():
    """Inside the block, yields the list of every WordVectorizer built."""
    from regennet_torch.data.humanml import word_vectorizer

    built = []
    init = word_vectorizer.WordVectorizer.__init__

    def recorded(self, *a, **kw):
        init(self, *a, **kw)
        built.append(self)

    word_vectorizer.WordVectorizer.__init__ = recorded
    try:
        yield built
    finally:
        word_vectorizer.WordVectorizer.__init__ = init


@contextlib.contextmanager
def working_dir(path):
    """The run's working directory inside the block: the CLIs read the
    GloVe archive from ./glove, as the reference's do."""
    cwd = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(cwd)


def check_t2m_evaluators(report, card, run_dir, data_path, device="cuda"):
    """Each network train_t2m_eval wrote (the movement autoencoder, the text
    and motion towers, the length estimator) on the card against a CPU copy
    at f32, within 1e-5 x max(1, max|cpu|), on a batch of the train split."""
    import copy

    import torch

    from regennet_torch.data.humanml.dataset import Text2MotionDataset
    from regennet_torch.eval.eval_humanml import _stack_items
    from regennet_torch.models import t2m_eval as t2m

    ds = Text2MotionDataset(data_path, split="train")
    word, pos, _, cap_lens, motions, m_lens, _ = _stack_items(
        [ds[i] for i in range(T2M_EVAL["batch"])])
    name = f"model{T2M_EVAL['epochs']:09d}.pt"
    stages = {"movement_enc": "decomp", "movement_dec": "decomp", "text_encoder": "matching",
              "motion_encoder": "matching"}
    nets = dict(zip(stages, t2m.networks(motions.shape[-1], *stages)))
    for key, stage in stages.items():
        t2m.load_state(nets[key], t2m.load_torch_file(run_dir / stage / name)[key])
    enc, dec, text, motion = nets.values()
    est = t2m.load_length_estimator(str(run_dir / "length" / name))
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)  # noqa: E731
    x = f32(motions)[..., :-t2m.FOOT_FEATS]
    with torch.no_grad():
        movements = enc(x)
    cases = {"movement encoder": (enc, (x,)), "movement decoder": (dec, (movements,)),
             "text tower": (text, (f32(word), f32(pos), cap_lens)),
             "motion tower": (motion, (movements, m_lens // 4)),
             "length estimator": (est, (f32(word), f32(pos), cap_lens))}
    worst = {}
    with torch.no_grad():
        for what, (net, inputs) in cases.items():
            ref = net.eval()(*inputs)
            card_net = copy.deepcopy(net).to(device)
            ours = card_net(*(a.to(device) if torch.is_tensor(a) else a for a in inputs))
            err = max_abs_err(ours.cpu(), ref)
            tol = 1e-5 * max(1.0, float(ref.abs().max()))
            hold(f"the trained {what} on {device} against its CPU copy", err, tol)
            worst[what] = err / tol
    print(f"  the trained evaluators on {device} against CPU copies, share of the tolerance "
          f"1e-5 x max(1, max|cpu|): " + ", ".join(f"{k} {v:.3f}" for k, v in worst.items())
          + f" [{card}]")
    report["t2m_evaluators_card_vs_cpu_share"] = worst


def check_t2m_eval_kernels(report):
    """Phase 12: B1 at the evaluations' shapes, f32 [64, 197, 512] (eval_humanml's
    CFG batch) and [32, 197, 512] (the in-training evaluation), non-causal,
    against its plain version at phase 2's tolerance. Returns the worst
    errors."""
    D, H, T = FLAGSHIP["latent_dim"], FLAGSHIP["heads"], T2M["T"] + 1
    B = T2M_EVAL["eval_samples"]  # debug's batch of 32, and the in-training one
    worst, report["t2m_eval_kernel_cases"] = hold_kernels_at(
        [(2 * B, T, "float32"), (B, T, "float32")], [], False, D, H, seed=T2M_EVAL["seed"])
    print(f"  B1 at [{2 * B} and {B}, {T}, {D}] (non-causal, f32) matches its plain version "
          f"(worst max_abs_err {worst['forward']:.3g}; phase 2's tolerance)")
    return worst


def run_t2m_eval(report, card, workdir, device="cuda"):
    """Phase 12, the text evaluation at the CLIs' default width on phase 11's
    synthetic HumanML3D, CLIP tower and text CMDM, with a seeded GloVe
    archive in ./glove: train_t2m_eval --stage all at T2M_OPT's widths,
    each trained network on the card against a CPU copy; eval_humanml
    debug (CFG 2.5, the matching .pt as --rec_model_path; B1 at [64, 197,
    512]) after B1 is held at [64 and 32, 197, 512]; train_mdm with the
    in-training evaluation (B1 at [32, 197, 512], B2 at [64, 197, 512]);
    generate --length_estimator. No word takes the hashed GloVe stand-in,
    no caption or prompt the hashed CLIP one. Returns {"b1": launches,
    "b2": {forward, backward}}."""
    import numpy as np

    from regennet_torch.data.humanml.dataset import Text2MotionDataset
    from regennet_torch.eval import eval_humanml
    from regennet_torch.models import t2m_eval as t2m
    from regennet_torch.sample import generate
    from regennet_torch.train import train_platforms, train_t2m_eval
    from regennet_torch.utils import parser_util

    t_phase = time.perf_counter()
    paths = t2m_paths(workdir)
    layers, D, T = FLAGSHIP["layers"], FLAGSHIP["latent_dim"], T2M["T"]
    write_glove(workdir / "glove", caption_words(paths["humanml"], [T2M["prompt"]]))
    run_dir = workdir / "t2m_eval"
    rows = report["t2m_eval"] = {}
    scalars = []
    report_scalar = train_platforms.NoPlatform.report_scalar
    evaluator_ms = []
    co_embeddings = t2m.T2MEvaluatorWrapper.get_co_embeddings

    def timed_co_embeddings(self, *a):
        t0 = time.perf_counter()
        out = co_embeddings(self, *a)  # numpy: the device has finished
        evaluator_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    with working_dir(workdir), clip_tower(paths) as fallbacks, word_vectorizers() as vocab:
        t0 = time.perf_counter()
        train_t2m_eval.main(train_t2m_eval.parse_args([
            "--data_path", paths["humanml"], "--save_dir", str(run_dir), "--stage", "all",
            "--batch_size", str(T2M_EVAL["batch"]), "--num_epochs", str(T2M_EVAL["epochs"]),
            "--seed", "0"]), device=device)
        rows["train_t2m_eval_s"] = time.perf_counter() - t0
        steps = 3 * T2M_EVAL["epochs"] * (T2M["clips"] // T2M_EVAL["batch"])
        print(f"  train_t2m_eval --stage all: {steps} steps (3 stages x "
              f"{T2M_EVAL['epochs']} epochs at batch {T2M_EVAL['batch']}) at T2M_OPT's widths "
              f"in {rows['train_t2m_eval_s']:.1f} s [{card}]")
        check_t2m_evaluators(report, card, run_dir, paths["humanml"], device)
        name = f"model{T2M_EVAL['epochs']:09d}.pt"
        matching, length = str(run_dir / "matching" / name), str(run_dir / "length" / name)

        eval_args = parser_util.evaluation_parser([
            "--model_path", paths["model"], "--rec_model_path", matching, "--eval_mode",
            "debug", "--guidance_param", str(T2M_EVAL["guidance"]), "--seed", "0"])
        t2m.T2MEvaluatorWrapper.get_co_embeddings = timed_co_embeddings
        try:
            metrics, counts = counted_run(lambda: eval_humanml.main(eval_args, device=device),
                                          device)
        finally:
            t2m.T2MEvaluatorWrapper.get_co_embeddings = co_embeddings
        hold_b1_launches("eval_humanml debug", counts, layers, device)
        debug_rows = min(eval_humanml.PROTOCOLS["debug"][0], len(Text2MotionDataset(
            paths["humanml"], split="test")))  # one batch of at most 32
        if counts["sampling_rows"] != [debug_rows] * 2:
            raise AssertionError(f"eval_humanml sampled {counts['sampling_rows']} rows")
        bad = {k: v for k, v in metrics.items() if not np.isfinite(v).all()}
        log = Path(paths["model"]).parent / "eval_humanml_humanml_run_debug.log"
        if bad or not log.is_file() or len(metrics) != 8:
            raise AssertionError(f"eval_humanml: metrics {metrics}, log {log.is_file()}")
        rows["eval"] = dict(counts, metrics=metrics,
                            evaluator_ms_per_batch=float(np.mean(evaluator_ms)))
        print(f"  eval_humanml debug (CFG {T2M_EVAL['guidance']}, 2 replications of "
              f"{debug_rows}): {counts['wall_s']:.1f} s, sampling "
              f"{counts['sampling_s']:.1f} s ({counts['ms_per_denoiser_step']:.3f} ms a "
              f"denoiser step at batch {2 * debug_rows}), the evaluators "
              f"{rows['eval']['evaluator_ms_per_batch']:.2f} ms a batch of "
              f"{debug_rows}; FID {metrics['FID_humanml_run']:.4g}, R-precision "
              f"{np.round(metrics['R_precision_humanml_run'], 4).tolist()} [{card}]")

        steps = T2M_EVAL["train_steps"]
        save_dir = workdir / "humanml_eval_run"
        args = parser_util.train_args([
            "--save_dir", str(save_dir), "--dataset", "humanml", "--data_path",
            paths["humanml"], "--batch_size", str(T2M["batch"]), "--num_steps", str(steps),
            "--steps_per_call", str(TRAIN["steps_per_call"]), "--save_interval", str(steps),
            "--log_interval", str(TRAIN["steps_per_call"]), "--seed", "0", "--layers",
            str(layers), "--latent_dim", str(D), "--diffusion_steps", str(FLAGSHIP["steps"]),
            "--eval_during_training", "--rec_model_path", matching, "--eval_num_samples",
            str(T2M_EVAL["eval_samples"]), "--eval_rep_times", "1"])
        train_platforms.NoPlatform.report_scalar = \
            lambda self, **kw: scalars.append(kw)  # noqa: E731
        try:
            (_, _, b2), train_counts = counted_run(
                lambda: run_training(report, card, save_dir, device, args,
                                     key="t2m_eval_training"), device)
        finally:
            train_platforms.NoPlatform.report_scalar = report_scalar
        hold_b1_launches("the in-training evaluation", train_counts, layers, device)
        evals = {s["name"] for s in scalars if s.get("group_name") == "Eval"}
        want = {f"top{k}_R_precision_model" for k in (1, 2, 3)} | {
            "FID_model", "Diversity_model", "Matching Score_model"}
        if not want <= evals or not (save_dir / f"eval_humanml_{steps:09d}.log").is_file() \
                or train_counts["sampling_rows"] != [T2M_EVAL["eval_samples"]]:
            raise AssertionError(f"in-training evaluation: Eval scalars {sorted(evals)}, "
                                 f"sampled {train_counts['sampling_rows']}")
        rows["in_training"] = train_counts
        print(f"  train_mdm --eval_during_training: {steps} steps, one evaluation of "
              f"{T2M_EVAL['eval_samples']} samples ({train_counts['sampling_s']:.1f} s "
              f"sampling); B2 launches {b2}, {len(evals)} Eval scalars and "
              f"eval_humanml_{steps:09d}.log [{card}]")

        out_dir = workdir / "generate_lengths"
        gen_args = parser_util.generate_args([
            "--model_path", paths["model"], "--data_path", paths["humanml"],
            "--text_prompt", T2M["prompt"], "--num_samples", str(T2M_EVAL["lengths"]),
            "--motion_length", str(T / 20), "--length_estimator", length,
            "--output_dir", str(out_dir), "--no-render"])
        result, gen_counts = counted_run(lambda: generate.main(gen_args, device=device),
                                         device)
        hold_b1_launches("generate --length_estimator", gen_counts, layers, device)
        lengths = np.asarray(result["lengths"])
        if lengths.shape != (T2M_EVAL["lengths"],) or (lengths % 4).any() or \
                not ((lengths >= 4) & (lengths <= T)).all():
            raise AssertionError(f"estimated lengths {lengths}")
        rows["generate"] = dict(gen_counts, lengths=lengths.tolist())
        print(f"  generate --length_estimator: lengths {lengths.tolist()} (multiples of 4 in "
              f"[4, {T}]) [{card}]")
    if fallbacks:
        raise AssertionError(f"the hashed text embeddings stood in for CLIP: {fallbacks}")
    if not vocab or any(wv.using_fallback for wv in vocab):
        raise AssertionError("a WordVectorizer fell back to the hashed word vectors")
    runs = (rows["eval"], rows["in_training"], rows["generate"])
    b1 = sum(r["b1"] for r in runs)
    wall_s = time.perf_counter() - t_phase
    sampling_s = sum(r["sampling_s"] for r in runs)
    rows.update(wall_s=wall_s, sampling_s=sampling_s, sampling_share=sampling_s / wall_s,
                glove_vectorizers=len(vocab), launches={"b1": b1, "b2": b2})
    print(f"  phase 12: {wall_s:.1f} s, sampling {sampling_s:.1f} s "
          f"({rows['sampling_share']:.3f} of it); B1 launches {b1}, B2 {b2}; "
          f"{len(vocab)} word vectorizers, none hashed; no hashed text embeddings [{card}]")
    return {"b1": b1, "b2": b2}


# phase 13: the comp_v6 generator at its published widths (T2M_GEN_OPT: text
# hidden 512, attention 512, z 128, prior/posterior/decoder hidden 1024, one
# layer, movement latent 512, snippets of 4 frames: 49 at the 196-frame window)
# on phase 11's data and phase 12's decomp, evaluators and length estimator
COMP_V6 = dict(dim_z=128, pri_hidden=1024, dec_hidden=1024, text_hidden=512, att_vec=512,
               n_layers=1, epochs=2, batch=32, prompts=4, raw_clips=8, seed=15)
COMP_V6_PROMPTS = ["a person walks forward and turns left", "a person walks forward",
                   "a person turns", "a person walks"]


def median_block_ms(step_ms, warmup=2, block=8):
    """The median over blocks of `block` steps of each block's mean, the
    first `warmup` steps left out."""
    import numpy as np

    steps = np.asarray(step_ms[warmup:], dtype=np.float64)
    n = max(1, len(steps) // block)
    return float(np.median([b.mean() for b in np.array_split(steps[:n * block], n)]))


@contextlib.contextmanager
def timed_generate(device="cuda"):
    """Inside the block, yields the list of the comp_v6 generator's prior
    sampling calls: (rows, snippets, device-synchronised ms)."""
    import torch

    from regennet_torch.models import t2m_gen

    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    calls = []
    generate = t2m_gen.CompV6Generator.generate

    def timed(self, word_embs, pos_ohot, cap_lens, m_lens, mov_in0, mov_len, *a, **kw):
        sync()
        t0 = time.perf_counter()
        out = generate(self, word_embs, pos_ohot, cap_lens, m_lens, mov_in0, mov_len, *a, **kw)
        sync()
        calls.append((word_embs.shape[0], mov_len, (time.perf_counter() - t0) * 1e3))
        return out

    t2m_gen.CompV6Generator.generate = timed
    try:
        yield calls
    finally:
        t2m_gen.CompV6Generator.generate = generate


def check_comp_v6_forward(report, card, gen, data_path, device="cuda"):
    """The trained generator's training forward on the card against a CPU
    copy at f32, teacher forcing off and on, on a train batch with fixed
    eps, each output within 1e-5 x max(1, max|cpu|) (phase 12's bound for
    the evaluators). The movements come from the CPU copy of the movement
    encoder, one input for both."""
    import copy

    import torch

    from regennet_torch.data.humanml.dataset import Text2MotionDataset
    from regennet_torch.eval.eval_humanml import _stack_items
    from regennet_torch.models import t2m_eval

    ds = Text2MotionDataset(data_path, split="train")
    word, pos, _, cap_lens, motions, m_lens, _ = _stack_items(
        [ds[i] for i in range(COMP_V6["batch"])])
    B, mov_len = len(word), motions.shape[1] // 4
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)  # noqa: E731
    generator = torch.Generator().manual_seed(COMP_V6["seed"])
    movements = torch.randn(B, mov_len, t2m_eval.T2M_OPT["dim_movement_latent"],
                            generator=generator)
    mov_in0 = torch.randn(B, movements.shape[-1], generator=generator)
    eps = [torch.randn(mov_len, B, gen.dim_z, generator=generator) for _ in range(2)]
    cpu_gen = copy.deepcopy(gen).cpu()
    worst = {}
    with torch.no_grad():
        for teacher_force in (False, True):
            inputs = (f32(word), f32(pos), cap_lens, movements, m_lens, mov_in0,
                      teacher_force, *eps)
            ref = cpu_gen(*inputs)
            ours = gen(*(a.to(device) if torch.is_tensor(a) else a for a in inputs))
            for key, value in ref.items():
                err = max_abs_err(ours[key].cpu(), value)
                tol = 1e-5 * max(1.0, float(value.abs().max()))
                hold(f"the trained comp_v6 generator's {key} (teacher forcing "
                     f"{teacher_force}) on {device} against its CPU copy", err, tol)
                worst[f"{key} tf={int(teacher_force)}"] = err / tol
    share = max(worst.values())
    print(f"  the trained generator's training forward on {device} against a CPU copy, "
          f"{mov_len} snippets at batch {B}, teacher forcing off and on: worst share of the "
          f"tolerance 1e-5 x max(1, max|cpu|) {share:.3f} [{card}]")
    report["comp_v6_card_vs_cpu_share"] = worst


def profile_comp_v6(report, card, gen, mov_enc, data_path, device="cuda"):
    """The trained generator's device time under torch.profiler: a training
    step at batch 32 (teacher forcing off; a fresh Adam, so the saved
    checkpoint is untouched) and a prior sampling of the same batch, each
    with its kernels per call and the idle share against the run's
    synchronised wall (the training step's median; the eval's samplings)."""
    import torch

    from regennet_torch.data.humanml.dataset import Text2MotionDataset
    from regennet_torch.eval.eval_humanml import _stack_items
    from regennet_torch.train import train_t2m_gen

    ds = Text2MotionDataset(data_path, split="train")
    batch = _stack_items([ds[i] for i in range(COMP_V6["batch"])])
    B, mov_len = len(batch[0]), batch[4].shape[1] // 4
    generator = torch.Generator(device=device).manual_seed(COMP_V6["seed"])
    eps = [torch.randn(mov_len, B, gen.dim_z, generator=generator, device=device)
           for _ in range(2)]
    args = train_t2m_gen.parse_args(["--data_path", data_path, "--save_dir", "unused"])
    step = train_t2m_gen.make_step(gen.train(), mov_enc, torch.optim.Adam(gen.parameters()),
                                   args, device)
    word, pos = (torch.as_tensor(x, device=device) for x in batch[:2])
    with torch.no_grad():
        mov_in0 = mov_enc(torch.zeros(B, 4, batch[4].shape[-1] - 4, device=device))[:, 0]

    @torch.no_grad()
    def sample():
        gen.generate(word, pos, batch[3], batch[5], mov_in0, mov_len, eps[0])

    rows = {}
    for what, fn, wall in (("training step", lambda: step(batch, False, *eps),
                            report["comp_v6"]["training"]["ms_per_step"]),
                           ("prior sampling", sample, min(
                               ms for _, _, ms in report["comp_v6"]["eval"]["generate_calls"]))):
        events = device_events(fn, iters=2)
        busy = sum(ms for ms, _ in events.values())
        launches = sum(n for _, n in events.values())
        top = {k[:60]: round(ms, 4) for k, (ms, _) in list(events.items())[:4]}
        rows[what] = dict(busy_ms=busy, launches=launches, wall_ms=wall,
                          idle_share=1 - busy / wall, top=top)
        print(f"  {what} at batch {B} over {mov_len} snippets under torch.profiler: busy "
              f"{busy:.2f} ms of {wall:.2f} ms synchronised (idle share {1 - busy / wall:.3f}), "
              f"{launches:.0f} kernels and copies, {busy / launches * 1e3:.1f} µs each; longest "
              f"{top} [{card}]")
    report["comp_v6"]["profile"] = rows


def write_raw_joints(root, count, seed):
    """`count` raw HumanML3D joint clips [T, 22, 3] of 60-199 frames: smooth
    random local rotations and a walking root FK'd through the t2m template
    at unequal bone lengths."""
    import numpy as np

    from regennet_torch.data.humanml import skeleton as sk

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    skel = sk.make_skeleton("humanml")
    offsets = sk.T2M_RAW_OFFSETS * (0.25 * (1.0 + 0.4 * np.arange(22) / 22.0))[:, None]
    offsets[0] = 0
    skel.set_offset(offsets)
    for i in range(count):
        T = int(rng.integers(60, 200))
        axis = rng.normal(size=(1, 22, 3))
        axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
        ang = 0.3 * np.sin(np.linspace(0, 2 * np.pi * rng.uniform(1, 3), T))[:, None, None]
        q = np.concatenate([np.cos(ang / 2) * np.ones((T, 22, 1)),
                            np.sin(ang / 2) * axis * np.ones((T, 22, 1))], axis=-1)
        root_pos = np.stack([np.linspace(0, rng.uniform(-1, 1), T), np.full(T, 0.9),
                             np.linspace(0, rng.uniform(0.5, 2), T)], axis=-1)
        np.save(os.path.join(root, f"{i:06d}.npy"),
                skel.forward_kinematics(q.astype(np.float32), root_pos.astype(np.float32)))
    return root


def run_preprocessing(report, card, workdir, device="cuda"):
    """motion_process._cli on seeded raw joint clips on the card and with
    --device cpu: the features, Mean and Std equal, the recovered joints
    within 1e-5 x max(1, max|cpu|)."""
    import numpy as np
    import torch

    from regennet_torch.data.humanml import motion_process

    raw = write_raw_joints(str(workdir / "raw_joints"), COMP_V6["raw_clips"], COMP_V6["seed"])
    walls, frames = {}, {}
    for where in (device, "cpu"):
        out = workdir / f"built_{where}"
        t0 = time.perf_counter()
        frames[where] = motion_process._cli([
            "--joints_dir", raw, "--out_dir", str(out), "--example_id", "000000",
            "--device", "cpu" if where == "cpu" else str(torch.device(where).index or 0)])
        walls[where] = time.perf_counter() - t0
    card_out, cpu_out = workdir / f"built_{device}", workdir / "built_cpu"
    names = sorted(p.name for p in (cpu_out / "new_joint_vecs").glob("*.npy"))
    if len(names) != COMP_V6["raw_clips"] or frames[device] != frames["cpu"]:
        raise AssertionError(f"preprocessing built {names}, frames {frames}")
    worst = 0.0
    for name in names:
        for sub in ("new_joint_vecs", "new_joints"):
            ours, ref = (np.load(d / sub / name) for d in (card_out, cpu_out))
            tol = 1e-5 * max(1.0, float(np.abs(ref).max())) if sub == "new_joints" else 0.0
            err = float(np.abs(ours - ref).max())
            hold(f"{sub}/{name} built on {device} against --device cpu", err, tol)
            if sub == "new_joints":
                worst = max(worst, err / tol)
    for stat in ("Mean.npy", "Std.npy"):
        ours, ref = np.load(card_out / stat), np.load(cpu_out / stat)
        if ours.shape != (263,) or not np.array_equal(ours, ref):
            raise AssertionError(f"{stat} built on {device} differs from --device cpu")
    report["comp_v6"]["preprocessing"] = dict(walls=walls, frames=frames[device],
                                              joints_share=worst)
    print(f"  motion_process: {len(names)} raw clips ({frames[device]} feature frames) built "
          f"in {walls[device]:.2f} s with the recovery check on {device}, {walls['cpu']:.2f} s "
          f"with --device cpu; features, Mean and Std equal, joints within "
          f"{worst:.3f} of the tolerance [{card}]")


def run_comp_v6(report, card, workdir, device="cuda"):
    """Phase 13, the comp_v6 generator at its published widths on phase 11's
    synthetic HumanML3D and phase 12's networks and GloVe archive (the phase
    run with the workdir as cwd): train_t2m_gen for COMP_V6["epochs"] epochs
    at batch 32 from phase 12's decomp, the trained generator's training
    forward on the card against a CPU copy; eval_humanml debug on its .pt
    with phase 12's matching evaluators and length estimator, every metric
    finite; the same state as a released-layout latest.tar gives the same
    log and the same generate output; generate's comp_v6 route for 4
    prompts; motion_process on seeded raw joints, the card against --device
    cpu. No attention kernel runs, and none may launch."""
    import shutil

    import numpy as np
    import torch

    from regennet_torch.eval import eval_humanml
    from regennet_torch.models import t2m_eval
    from regennet_torch.sample import generate
    from regennet_torch.train import train_t2m_gen
    from regennet_torch.utils import parser_util

    t_phase = time.perf_counter()
    paths = t2m_paths(workdir)
    run_dir = workdir / "t2m_eval"
    stage = f"model{T2M_EVAL['epochs']:09d}.pt"
    matching, length = str(run_dir / "matching" / stage), str(run_dir / "length" / stage)
    rows = report["comp_v6"] = {}
    sizes = [a for k in ("dim_z", "pri_hidden", "dec_hidden", "text_hidden", "att_vec",
                         "n_layers") for a in (f"--{k}", str(COMP_V6[k]))]
    with working_dir(workdir), word_vectorizers() as vocab:
        args = train_t2m_gen.parse_args([
            "--data_path", paths["humanml"], "--save_dir", str(run_dir / "comp_v6"),
            "--batch_size", str(COMP_V6["batch"]), "--num_epochs", str(COMP_V6["epochs"]),
            "--seed", "0", *sizes])
        trained, counts = counted_run(lambda: train_t2m_gen.main(args, device=device), device)
        steps = len(trained["step_ms"])
        step_ms = median_block_ms(trained["step_ms"])
        rows["training"] = dict(counts, steps=steps, ms_per_step=step_ms,
                                params=sum(p.numel() for p in trained["generator"].parameters()))
        print(f"  train_t2m_gen: {steps} steps ({COMP_V6['epochs']} epochs at batch "
              f"{COMP_V6['batch']}, {rows['training']['params'] / 1e6:.2f}M parameters) in "
              f"{counts['wall_s']:.1f} s; {step_ms:.2f} ms a synchronised step (median of "
              f"8-step blocks after 2) [{card}]")
        check_comp_v6_forward(report, card, trained["generator"], paths["humanml"], device)

        released = workdir / "released" / "comp_v6"
        released.mkdir(parents=True)
        shutil.copy(run_dir / "comp_v6" / "args.json", released / "args.json")
        torch.save({**t2m_eval.load_torch_file(trained["path"]), "ep": COMP_V6["epochs"],
                    "total_it": steps}, released / "latest.tar")
        logs, evals = {}, {}
        for route, model_path in (("pt", trained["path"]), ("tar", str(released / "latest.tar"))):
            eval_args = parser_util.evaluation_parser([
                "--model_path", model_path, "--rec_model_path", matching, "--eval_mode",
                "debug", "--length_estimator", length, "--data_path", paths["humanml"],
                "--seed", "0"])
            with timed_generate(device) as calls:
                metrics, counts = counted_run(
                    lambda: eval_humanml.main(eval_args, device=device), device)
            bad = {k: v for k, v in metrics.items() if not np.isfinite(v).all()}
            if bad or len(metrics) != 8:
                raise AssertionError(f"eval_humanml on the comp_v6 {route}: {metrics}")
            log = Path(model_path).parent / "eval_humanml_comp_v6_debug.log"
            logs[route] = log.read_text()
            evals[route] = dict(counts, metrics=metrics, generate_calls=calls)
        if logs["pt"] != logs["tar"]:
            raise AssertionError("the released-layout .tar's eval log differs from the .pt's")
        rows["eval"] = evals["pt"]
        eval_ms = [ms for _, _, ms in evals["pt"]["generate_calls"]]
        metrics = evals["pt"]["metrics"]
        print(f"  eval_humanml debug (2 replications, --length_estimator): "
              f"{evals['pt']['wall_s']:.1f} s, {len(eval_ms)} prior samplings of "
              f"{evals['pt']['generate_calls'][0][0]} rows at {np.mean(eval_ms):.1f} ms each; "
              f"FID {metrics['FID_comp_v6']:.4g}, R-precision "
              f"{np.round(metrics['R_precision_comp_v6'], 4).tolist()}; the latest.tar route "
              f"wrote the same log [{card}]")
        if device != "cpu":  # torch.profiler's device time needs the card
            profile_comp_v6(report, card, trained["generator"], trained["mov_enc"],
                            paths["humanml"], device)
        del trained["generator"]

        results = {}
        for route, model_path in (("pt", trained["path"]), ("tar", str(released / "latest.tar"))):
            prompts = workdir / "comp_v6_prompts.txt"
            prompts.write_text("\n".join(COMP_V6_PROMPTS[:COMP_V6["prompts"]]))
            gen_args = parser_util.generate_args([
                "--model_path", model_path, "--data_path", paths["humanml"], "--input_text",
                str(prompts), "--motion_length", str(T2M["T"] / 20), "--seed", "0",
                "--output_dir", str(workdir / f"comp_v6_generate_{route}"), "--no-render"])
            with timed_generate(device) as calls:
                results[route], counts = counted_run(
                    lambda: generate.main(gen_args, device=device), device)
            if route == "pt":
                rows["generate"] = dict(counts, generate_calls=calls)
        ours, ref = results["pt"], results["tar"]
        if not all(np.array_equal(ours[k], ref[k]) for k in ("motion", "feature", "lengths")):
            raise AssertionError("generate through the latest.tar differs from the .pt")
        saved = np.load(workdir / "comp_v6_generate_pt" / "results.npy", allow_pickle=True).item()
        n = COMP_V6["prompts"]
        want = {"motion": (n, T2M["T"], 22, 3), "feature": (n, T2M["T"], 263), "lengths": (n,)}
        shapes = {k: np.shape(saved[k]) for k in want}
        if shapes != want or not np.isfinite(saved["motion"]).all():
            raise AssertionError(f"comp_v6 results.npy: shapes {shapes}")
        rows_, snippets, gen_ms = rows["generate"]["generate_calls"][0]
        print(f"  generate (comp_v6 route): {rows_} prompts, {snippets} snippets in "
              f"{gen_ms:.2f} ms ({gen_ms / snippets:.3f} ms a snippet step), the request "
              f"{rows['generate']['wall_s']:.2f} s; motion {list(want['motion'])} finite; the "
              f"latest.tar gives the same motions [{card}]")
        run_preprocessing(report, card, workdir, device)
    if not vocab or any(wv.using_fallback for wv in vocab):
        raise AssertionError("a WordVectorizer fell back to the hashed word vectors")
    launched = [r for r in (rows["training"], rows["eval"], rows["generate"])
                if r["b1"] or r["b2"]["forward"] or r["b2"]["backward"]]
    if launched:
        raise AssertionError(f"an attention kernel launched on the comp_v6 path: {launched}")
    wall_s = time.perf_counter() - t_phase
    rows.update(wall_s=wall_s, ms_per_generated_batch=gen_ms,
                ms_per_snippet_step=gen_ms / snippets)
    print(f"  phase 13: {wall_s:.1f} s; no attention kernel launched [{card}]")


# phase 14: motion editing on phase 3's online CMDM and phase 11's text
# CMDM, the Predictor on phase 4's checkpoint, the ACTOR CVAE at the JAX
# train_cvae CLI's defaults (transformer, 4 layers, latent 256, 4 heads of
# 64, ff 1024, batch 20, SMPL-X 56 x 12 at 60 frames; it trains as the JAX
# trainer applies the model, with no dropout) on in-memory Chi3D clips,
# generate_sequences to mesh vertices of an SMPL-X-sized body (10,475
# vertices, 20,908 faces), and the rasterizer on the card against a CPU copy
CVAE = dict(T=60, batch=20, latent_dim=256, layers=4, clips=320, classes=2, rows=2,
            frames_drawn=8, frames_held=2, size=224, vertices=10475, faces=20908)
EDIT = dict(batch=16, seed=14, predict_batch=4, predict_seed=5, predict_steps=50)
RASTER_SHARE = 0.001  # pixels that may differ, each on an edge of the CPU frame


def cvae_launches(layers, steps, encoder_calls, decoder_calls, T):
    """B1 and B2 on phase 14's CVAE path by token count, the encoder's T + 2
    (the mu and sigma tokens first) and the decoder's T: B2 once each way
    in every encoder and decoder layer of a training step; B1 once in every
    layer of each encoder and decoder call at inference. Counts of 0 are
    left out, as the wrappers' by-T counts leave them."""
    def by_T(encoder, decoder):
        return {t: n for t, n in ((T + 2, layers * encoder), (T, layers * decoder)) if n}

    return {"b1_by_T": by_T(encoder_calls, decoder_calls),
            "b2_by_T": {"forward": by_T(steps, steps), "backward": by_T(steps, steps)}}


def check_cvae_kernels(report):
    """B1 and B2 at the CVAE's head dim 64, f32, non-causal: the encoder's
    [B, T + 2, 256] (the mu and sigma tokens first) and the decoder's [B, T,
    256], 4 heads, against their plain versions at phases 2 and 2b's
    tolerances; B2 at rate 0, the rate train_cvae trains at, and at
    TRAIN["rate"]. Returns the worst errors."""
    B, T, D = CVAE["batch"], CVAE["T"], CVAE["latent_dim"]
    shapes = [(B, t, "float32") for t in (T + 2, T)]
    worst, cases = hold_kernels_at(shapes, shapes, False, D, 4, seed=14, rate=0.0)
    worst_drop, cases_drop = hold_kernels_at([], shapes, False, D, 4, seed=15)
    worst = {k: max(worst[k], worst_drop[k]) for k in worst}
    report["cvae_kernel_cases"] = cases + cases_drop
    print(f"  B1 and B2 at head dim {D // 4} ([{B}, {T + 2} and {T}, {D}], 4 heads, f32, "
          f"non-causal, B2 at rate 0 and {TRAIN['rate']}) match their plain versions (worst "
          f"max_abs_err B1 {worst['forward']:.3g}, B2 forward {worst['train_forward']:.3g}, "
          f"backward {worst['backward']:.3g} against the plain backward; tolerances of "
          "phases 2 and 2b)")
    return worst


def time_cvae_kernels(report, card):
    """B1 and B2 timed at the CVAE's encoder and decoder shapes, [20, 62,
    256] and [20, 60, 256] (head dim 64), as phase 2d times its shapes, B2
    at rate 0 as train_cvae runs it. Returns {T: (B1's timing, B2's
    timing)}."""
    timings = {}
    for T in (CVAE["T"] + 2, CVAE["T"]):
        timings[T] = time_btd_kernels(card, T, B=CVAE["batch"], D=CVAE["latent_dim"],
                                      rate=0.0)
    report["cvae_attention_timing"] = {
        str(T): {"fused_attention_btd": b1, "fused_attention_btd_train": b2}
        for T, (b1, b2) in timings.items()}
    return timings


@contextlib.contextmanager
def last_x0_prediction():
    """Yields a list that holds, after a sampling loop inside the block,
    the x_0 prediction of its last step (t = 0) and that step's cond."""
    from regennet_torch.diffusion import gaussian

    p_mean_variance = gaussian.p_mean_variance
    last = []

    def kept(sched, cfg, model_fn, x, t, cond, *rest, **kw):
        out = p_mean_variance(sched, cfg, model_fn, x, t, cond, *rest, **kw)
        last[:] = [out["pred_xstart"], cond]
        return out

    gaussian.p_mean_variance = kept
    try:
        yield last
    finally:
        gaussian.p_mean_variance = p_mean_variance


def hold_edit(what, npy_path, last, shape):
    """results.npy of an edit: finite, of `shape`, with the JAX CLI's keys;
    the last step's x_0 prediction equal to inpainted_motion on every kept
    entry of every sample. Returns the share of kept entries."""
    import numpy as np

    res = np.load(npy_path, allow_pickle=True).item()
    if set(res) != {"motion", "output", "cmotion", "input_motion", "inpainting_mask", "text",
                    "lengths", "edit_mode"}:
        raise AssertionError(f"{what}: results.npy keys {sorted(res)}")
    if res["output"].shape != shape or not np.isfinite(res["output"]).all():
        raise AssertionError(f"{what}: output {res['output'].shape} (want {shape}) or "
                             "non-finite values")
    x0, cond = last
    mask = cond["inpainting_mask"]
    for i in range(shape[0]):
        kept = mask[i]
        if not (kept.any() and bool((x0[i][kept] == cond["inpainted_motion"][i][kept]).all())):
            raise AssertionError(f"{what}: sample {i}'s last x_0 prediction differs from the "
                                 "inpainted motion on a kept entry")
    if not np.array_equal(mask.cpu().numpy(), res["inpainting_mask"]):
        raise AssertionError(f"{what}: the saved mask is not the sampler's")
    return float(mask.float().mean())


def run_edits(report, card, data, paths, device="cuda"):
    """Edits at full width: phase 3's online CMDM (random weights from a
    seed, f32 batch 16, DDPM 1000, CFG off) in_between and upper_body, and
    phase 11's text CMDM upper_body on hml_vec features (one prompt, CFG
    2.5, 197 tokens, the seeded CLIP tower). B1's launches: layers x steps
    x calls. Returns B1's launches."""
    from regennet_torch.sample import edit

    T, layers, rows, b1 = FLAGSHIP["T"], FLAGSHIP["layers"], [], 0
    with tempfile.TemporaryDirectory() as tmp:
        for mode in ("in_between", "upper_body"):
            args = request_args(Path(tmp) / mode, EDIT["batch"], 1.0, "float32",
                                EDIT["seed"])
            args.edit_mode, args.text_condition = mode, ""
            args.prefix_end, args.suffix_start = 0.25, 0.75
            with last_x0_prediction() as last:
                npy, counts = counted_run(lambda: edit.main(args, device=device, data=data),
                                          device)
            share = hold_edit(f"edit {mode}", npy, last, (EDIT["batch"], 56, 6, T))
            hold_b1_launches(f"edit {mode}", counts, layers, device)
            rows.append(dict(model="online", mode=mode, batch=EDIT["batch"], guidance=1.0,
                             kept_share=share, **counts))
            b1 += counts["b1"]
        with clip_tower(paths) as fallbacks:
            args = edit.edit_cli_args([
                "--model_path", paths["model"], "--dataset", "humanml",
                "--data_path", paths["humanml"], "--edit_mode", "upper_body",
                "--text_condition", T2M["prompt"], "--num_samples", "1",
                "--guidance_param", str(T2M["guidance"]), "--seed", str(EDIT["seed"]),
                "--output_dir", str(Path(tmp) / "text")])
            with last_x0_prediction() as last:
                npy, counts = counted_run(lambda: edit.main(args, device=device), device)
        if fallbacks:
            raise AssertionError(f"the hashed text embeddings stood in for CLIP: {fallbacks}")
        share = hold_edit("the text edit", npy, last, (1, 263, 1, T2M["T"]))
        hold_b1_launches("the text edit", counts, layers, device)
        rows.append(dict(model="text", mode="upper_body", batch=1, guidance=T2M["guidance"],
                         kept_share=share, **counts))
        b1 += counts["b1"]
    for row in rows:
        print(f"  edit {row['mode']} on the {row['model']} CMDM (batch {row['batch']}, "
              f"guidance {row['guidance']}): {row['sampling_steps']} steps, "
              f"{row['ms_per_denoiser_step']:.3f} ms a denoiser step, the request "
              f"{row['wall_s']:.2f} s; kept entries {row['kept_share']:.3f} of the motion, "
              f"each equal to the input in the last x_0 prediction [{card}]")
    report["edits"] = rows
    return b1


def run_predict(report, card, save_dir, data, device="cuda"):
    """Predictor.setup on phase 4's checkpoint (DDIM EDIT["predict_steps"],
    CFG 2.5), then two
    predict calls with one seed, bit-identical, and a cgenerate request of
    the same seed and actor clips: its output equals the Predictor's,
    smoothed as cgenerate smooths. Returns B1's launches (three requests)."""
    import numpy as np
    import torch
    from scipy.ndimage import gaussian_filter1d

    from regennet_torch.sample import cgenerate, predict
    from regennet_torch.utils import parser_util

    n, seed = EDIT["predict_batch"], EDIT["predict_seed"]
    respacing = f"ddim{EDIT['predict_steps']}"
    ckpt = str(save_dir / f"model{TRAIN['steps']:09d}.pt")
    args = parser_util.cgenerate_args([
        "--model_path", ckpt, "--output_dir", str(save_dir / "predict_ref"), "--dataset",
        "chi3d", "--num_person", "2", "--body_model", "smplx", "--num_samples", str(n),
        "--num_repetitions", "1", "--seed", str(seed), "--guidance_param", "2.5",
        "--use_ddim", "--timestep_respacing", respacing])

    def requests():
        ref = np.load(cgenerate.main(args, device=device, data=data),
                      allow_pickle=True).item()
        predictor = predict.Predictor()
        predictor.setup(ckpt, guidance_param=2.5, use_ddim=True,
                        timestep_respacing=respacing, device=device)
        actions = np.asarray([[i % data.num_actions] for i in range(n)])
        return ref, [predictor.predict(ref["cmotion"], actions, seed=seed) for _ in range(2)]

    (ref, (a, b)), counts = counted_run(requests, device)
    if not np.array_equal(a, b):
        raise AssertionError("two predict calls with one seed differ")
    smoothed = gaussian_filter1d(a, sigma=1, axis=-1)
    err = max_abs_err(torch.tensor(smoothed), torch.tensor(ref["output"]))
    hold("the Predictor against cgenerate on the same noise", err,
         1e-5 * max(1.0, float(np.abs(ref["output"]).max())))
    hold_b1_launches("the three requests", counts, FLAGSHIP["layers"], device)
    print(f"  Predictor on {Path(ckpt).name} (DDIM {EDIT['predict_steps']}, CFG 2.5, batch "
          f"{n}): two calls with "
          f"seed {seed} bit-identical, cgenerate's output at max_abs_err {err:.3g} "
          f"({'bit-identical' if err == 0 else 'within 1e-5'}); "
          f"{counts['ms_per_denoiser_step']:.3f} ms a denoiser step [{card}]")
    report["predict"] = dict(batch=n, max_abs_err=err, **counts)
    return counts["b1"]


def cvae_feeder():
    """CVAE["clips"] in-memory Chi3D clips at the CVAE's window."""
    from regennet_torch.data import synthetic
    from regennet_torch.data.feeder import Feeder

    T = CVAE["T"]
    return Feeder(clips=synthetic.make_clips("chi3d", "train", num_clips=CVAE["clips"],
                                             min_len=T + 4, max_len=2 * T, seed=14),
                  dataname="chi3d", split="train", num_frames=T, num_person=2,
                  pose_rep="rot6d")


def check_cvae_train_step(report, model, data, args, device="cuda"):
    """One train_cvae step (the trained weights, one batch, the generator's
    draws) through the kernels against the same step through the plain
    attention: the losses within 1e-4 relative, each gradient within 1e-4 x
    max(1, max|g|) (phase 4's bound)."""
    import numpy as np
    import torch

    from regennet_torch.data.collate import collate
    from regennet_torch.data.get_data import BatchLoader
    from regennet_torch.models import transformer
    from regennet_torch.ops import attention, body_model
    from regennet_torch.ops.pose_decode import make_rot2xyz
    from regennet_torch.train import train_cvae

    motion, cond = next(iter(BatchLoader(data, CVAE["batch"], collate, seed=1)))
    x = torch.as_tensor(motion, device=device)
    action = torch.as_tensor(cond["y"]["action"][:, 0], device=device)
    mask = torch.as_tensor(np.asarray(cond["y"]["mask"])[:, 0, 0, :], device=device)
    lambdas = train_cvae.active_lambdas(args)
    rot2xyz = make_rot2xyz(body_model.get_body_model(args.body_model).to(device),
                           pose_rep=args.pose_rep, translation=True, glob=True,
                           jointstype=args.body_model, num_person=args.num_person)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    runs = {}
    for route, attend in (("kernel", attention.fused_attention_btd_train),
                          ("plain", attention.attention_btd_train_reference)):
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(start[n])
        optimizer = train_cvae.make_optimizer(model.parameters(), args.lr,
                                              train_cvae.WEIGHT_DECAY)
        step = train_cvae.make_train_step(model, optimizer, lambdas, rot2xyz,
                                          torch.Generator(device=device).manual_seed(12))
        transformer.fused_attention_btd_train = attend
        try:
            losses = step(x, action, mask)
        finally:
            transformer.fused_attention_btd_train = attention.fused_attention_btd_train
        runs[route] = ({k: float(v) for k, v in losses.items()},
                       {n: p.grad.clone() for n, p in model.named_parameters()})
    (loss_k, grads_k), (loss_p, grads_p) = runs["kernel"], runs["plain"]
    for name, value in loss_p.items():
        hold(f"the CVAE step's {name} loss", abs(loss_k[name] - value),
             1e-4 * max(1.0, abs(value)))
    worst = (-1.0, "")
    for n, g in grads_p.items():
        err, tol = max_abs_err(grads_k[n], g), 1e-4 * max(1.0, float(g.abs().max()))
        hold(f"the CVAE step's gradient of {n}", err, tol)
        worst = max(worst, (err / tol, n))
    print(f"  one CVAE training step through the kernels vs the plain attention: losses "
          + ", ".join(f"{k} {loss_k[k]:.6f} vs {v:.6f}" for k, v in sorted(loss_p.items()))
          + f"; all {len(grads_p)} gradients within 1e-4 x max(1, max|g|), the worst "
          f"{worst[1]} at {worst[0]:.3f} of it")
    report["cvae_train_step_check"] = dict(loss_kernel=loss_k, loss_plain=loss_p,
                                           worst_gradient=dict(name=worst[1],
                                                               share=worst[0]))


def hold_frames(what, ours, ref):
    """Each frame as the CPU's except at most RASTER_SHARE of its pixels,
    each on an edge of the CPU frame (its colour differs from a
    4-neighbour's). Returns the largest share that differs."""
    import numpy as np

    worst = 0.0
    for i, (a, b) in enumerate(zip(ours, ref)):
        if a.shape != b.shape or a.dtype != np.uint8:
            raise AssertionError(f"{what}: frame {i} is {a.shape} {a.dtype}")
        differ = np.any(a != b, axis=-1)
        edge = np.zeros(differ.shape, bool)
        for axis in (0, 1):
            step = np.any(np.diff(b.astype(int), axis=axis) != 0, axis=-1)
            lo, hi = [slice(None)] * 2, [slice(None)] * 2
            lo[axis], hi[axis] = slice(0, -1), slice(1, None)
            edge[tuple(lo)] |= step
            edge[tuple(hi)] |= step
        if differ.mean() > RASTER_SHARE or (differ & ~edge).any():
            raise AssertionError(f"{what}: frame {i} differs on {differ.mean():.4%} of its "
                                 f"pixels, {int((differ & ~edge).sum())} off the edges")
        worst = max(worst, float(differ.mean()))
    return worst


def full_size_smplx(model_dir):
    """A synthetic SMPL-X at the real one's size, CVAE["vertices"] vertices
    and CVAE["faces"] faces, written in the official npz layout to
    {model_dir}/smplx/SMPLX_NEUTRAL.npz, where get_body_model looks first.
    The faces are strips over the vertices ordered by their main joint,
    then height, so that each stays within a part of the body."""
    import numpy as np

    from regennet_torch.ops import body_model

    nj = len(body_model.SMPLX_PARENTS)
    model = body_model.synthetic("smplx", num_vertices=CVAE["vertices"] - nj)
    n = CVAE["vertices"] - nj  # the mesh; the last nj vertices sit at the joints
    v = model.v_template.numpy()[:n]
    order = np.lexsort((v[:, 1], model.lbs_weights.numpy()[:n].argmax(1)))
    strips = [np.stack([order[:n - b], order[a:n - b + a], order[b:]], 1)
              for a, b in ((1, 2), (2, 3), (3, 4), (4, 5))]
    faces = np.concatenate(strips)[:CVAE["faces"]]
    if len(faces) != CVAE["faces"]:
        raise AssertionError(f"{len(faces)} faces, want {CVAE['faces']}")
    V = model.num_vertices
    path = Path(model_dir) / "smplx" / "SMPLX_NEUTRAL.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, v_template=model.v_template.numpy(), shapedirs=model.shapedirs.numpy(),
             posedirs=model.posedirs.numpy().T.reshape(V, 3, -1),
             J_regressor=model.j_regressor.numpy(), weights=model.lbs_weights.numpy(),
             kintree_table=np.stack([np.asarray(model.parents), np.arange(nj)]),
             f=faces.astype(np.int32))
    return path


def draw_meshes(report, card, xyz, faces, device="cuda"):
    """One generated two-person vertex sequence [V, 6, T]: CVAE["frames_drawn"]
    of its frames rasterised on the card at CVAE["size"], the first
    CVAE["frames_held"] of them also on the CPU: the same uint8 frames
    within hold_frames' share."""
    import torch

    from regennet_torch.render import renderer

    V, _, T = xyz.shape
    frames = xyz[:, :, :: max(1, T // CVAE["frames_drawn"])][:, :, :CVAE["frames_drawn"]]
    verts = torch.as_tensor(frames).reshape(V, 2, 3, -1).permute(1, 0, 2, 3)  # [P, V, 3, T]
    size = (CVAE["size"], CVAE["size"])
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    times = {}
    for where, v in (("card", verts.to(device)), ("cpu", verts[..., :CVAE["frames_held"]])):
        sync()
        t0 = time.perf_counter()
        drawn = renderer.render_mesh_frames(v, faces, resolution=size)
        times[where] = (drawn, (time.perf_counter() - t0) * 1e3 / len(drawn))
    if any(not (f != f[0, 0]).any() for f in times["card"][0]):
        raise AssertionError("a frame drew no mesh")
    # the camera is fitted to the frames given: the held ones go through
    # the card again on their own
    held = renderer.render_mesh_frames(verts[..., :CVAE["frames_held"]].to(device), faces,
                                       resolution=size)
    share = hold_frames("the rasterizer on the card against a CPU copy", held, times["cpu"][0])
    n = len(times["card"][0])
    print(f"  rasterizer: {n} frames of 2 x {V} vertices, {2 * len(faces)} faces at "
          f"{size[0]}x{size[1]}, card {times['card'][1]:.2f} ms a frame, CPU "
          f"{times['cpu'][1]:.2f} ms; {len(held)} frames held against the CPU, equal but for "
          f"{share:.4%} of the pixels at most, each on an edge [{card}]")
    report["cvae_raster"] = dict(frames=n, frames_held=len(held), size=CVAE["size"],
                                 vertices=V, faces=2 * len(faces),
                                 card_ms_per_frame=times["card"][1],
                                 cpu_ms_per_frame=times["cpu"][1], worst_share=share)


def run_cvae(report, card, workdir, device="cuda"):
    """The ACTOR CVAE at the JAX train_cvae CLI's defaults on in-memory
    Chi3D clips, run from `workdir` with full_size_smplx's body model in
    its ./body_models: train_cvae for one epoch (CVAE["clips"] // batch
    steps, each synchronised and timed; B2 8 times a step, B1 never), a
    step through the kernels against the plain attention, the trained
    model's inference forward on the card against a CPU copy,
    generate_sequences (CVAE["classes"] classes x CVAE["rows"] rows,
    --jointstype vertices) and its first vertex sequence drawn on the card
    against the CPU. Every launch count is read by T around each run.
    Returns {"b1", "b2", "b1_by_T", "b2_by_T", "ms_per_step"}."""
    from regennet_torch.ops import body_model

    full_size_smplx(workdir / "body_models")
    body_model.get_body_model.cache_clear()
    try:
        with contextlib.chdir(workdir):
            return _run_cvae(report, card, workdir, device)
    finally:
        body_model.get_body_model.cache_clear()


def _run_cvae(report, card, workdir, device):
    import copy

    import numpy as np
    import torch

    from regennet_torch.ops import body_model
    from regennet_torch.sample import generate_sequences
    from regennet_torch.train import train_cvae

    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    data = cvae_feeder()
    save_dir = workdir / "cvae"
    T = CVAE["T"]
    # the JAX CLI's defaults (CVAE holds them), one epoch
    args = train_cvae.parse_args([
        "--data_path", "", "--save_dir", str(save_dir), "--num_epochs", "1", "--snapshot",
        "1", "--seed", "0", "--num_frames", str(T), "--batch_size",
        str(CVAE["batch"]), "--latent_dim", str(CVAE["latent_dim"]), "--num_layers",
        str(CVAE["layers"])])
    step_ms = []
    make_train_step = train_cvae.make_train_step

    def timed_make(*a, **kw):
        step = make_train_step(*a, **kw)

        def timed(*sa, **skw):
            sync()
            t0 = time.perf_counter()
            out = step(*sa, **skw)
            sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        return timed

    train_cvae.make_train_step = timed_make
    try:
        (model, path), counts = counted_run(
            lambda: train_cvae.main(args, device=device, data=data), device)
    finally:
        train_cvae.make_train_step = make_train_step
    steps = len(step_ms)
    layers = args.num_layers
    on_card = device != "cpu"
    want = cvae_launches(layers * on_card, steps, 0, 0, T)
    if steps != CVAE["clips"] // CVAE["batch"] or counts["b1_by_T"] != want["b1_by_T"] or \
            counts["b2_by_T"] != want["b2_by_T"]:
        raise AssertionError(f"train_cvae: {steps} steps, B1 {counts['b1_by_T']}, B2 "
                             f"{counts['b2_by_T']} by T (want {want})")
    ms_per_step = float(np.median(step_ms[1:])) if steps > 1 else step_ms[0]
    print(f"  train_cvae ({args.arch}, {layers} layers, latent {args.latent_dim}, batch "
          f"{args.batch_size}, T {args.num_frames}, {model.njoints}x{model.nfeats}, no "
          f"dropout): {steps} steps, {ms_per_step:.2f} ms a synchronised step (median after "
          f"the first), the run {counts['wall_s']:.2f} s; B2 by T {counts['b2_by_T']}, B1 "
          f"{counts['b1']} [{card}]")
    check_cvae_train_step(report, model, data, args, device)

    # the trained model's inference forward on the card against a CPU copy
    model.eval()
    gen = torch.Generator().manual_seed(3)
    x = torch.as_tensor(np.stack([data[i]["inp"] for i in range(CVAE["batch"])]))
    action = torch.arange(CVAE["batch"]) % data.num_actions
    eps = torch.randn(CVAE["batch"], args.latent_dim, generator=gen)
    with torch.no_grad():
        out, fwd = counted_run(lambda: model(x.to(device), action.to(device),
                                             eps=eps.to(device)), device)
        ref = copy.deepcopy(model).cpu()(x, action, eps=eps)
    for name in ("output", "mu", "logvar"):
        hold(f"the CVAE's {name} on the card against its CPU copy",
             max_abs_err(out[name].cpu(), ref[name]),
             1e-5 * max(1.0, float(ref[name].abs().max())))
    gen_args = generate_sequences.parse_args([
        "--model_path", path, "--num_classes", str(CVAE["classes"]), "--nspa",
        str(CVAE["rows"]), "--num_frames", str(T), "--jointstype", "vertices",
        "--seed", "0",
        "--output_path", str(workdir / "generation.npy")])
    result, grid = counted_run(lambda: generate_sequences.main(gen_args, device=device),
                               device)
    smplx = body_model.get_body_model("smplx")
    V = smplx.num_vertices
    if (V, len(smplx.faces)) != (CVAE["vertices"], CVAE["faces"]):
        raise AssertionError(f"the body model has {V} vertices and {len(smplx.faces)} faces")
    shapes = {k: result[k].shape for k in ("generation", "generation_xyz")}
    want_shapes = {"generation": (CVAE["rows"], CVAE["classes"], 56, 12, T),
                   "generation_xyz": (CVAE["rows"], CVAE["classes"], V, 6, T)}
    if shapes != want_shapes or not np.isfinite(result["generation_xyz"]).all():
        raise AssertionError(f"generate_sequences: {shapes} (want {want_shapes})")
    for what, run, want in (("the forward", fwd, cvae_launches(layers * on_card, 0, 1, 1, T)),
                            ("generate_sequences", grid,
                             cvae_launches(layers * on_card, 0, 0, CVAE["rows"], T))):
        if run["b1_by_T"] != want["b1_by_T"] or run["b2"]["forward"]:
            raise AssertionError(f"CVAE inference, {what}: B1 by T {run['b1_by_T']} (want "
                                 f"{want['b1_by_T']}), B2 {run['b2']}")
    b1_by_T = {t: fwd["b1_by_T"].get(t, 0) + grid["b1_by_T"].get(t, 0)
               for t in sorted({*fwd["b1_by_T"], *grid["b1_by_T"]})}
    print(f"  the CVAE's forward on the card equals its CPU copy (1e-5 x max(1, max|cpu|)); "
          f"generate_sequences: {CVAE['classes']} classes x {CVAE['rows']} rows at {T} "
          f"frames, vertices {list(want_shapes['generation_xyz'])} finite; B1 by T "
          f"{fwd['b1_by_T']} + {grid['b1_by_T']} [{card}]")
    draw_meshes(report, card, result["generation_xyz"][0, 0], smplx.faces, device)
    report["cvae"] = dict(steps=steps, ms_per_step=ms_per_step, step_ms=step_ms,
                          train_wall_s=counts["wall_s"], launches=dict(
                              train=counts["b2_by_T"], forward=fwd["b1_by_T"],
                              generate=grid["b1_by_T"]))
    return {"b1": fwd["b1"] + grid["b1"], "b2": counts["b2"], "b1_by_T": b1_by_T,
            "b2_by_T": counts["b2_by_T"], "ms_per_step": ms_per_step}


def run_phase14(report, card, workdir, data, device="cuda"):
    """Phase 14: edits, the Predictor, the CVAE path and mesh rendering, in
    the workdir of phases 4 (train/) and 11 (t2m/). Returns the launches."""
    t_phase = time.perf_counter()
    b1_edit = run_edits(report, card, data, t2m_paths(workdir / "t2m"), device)
    b1_predict = run_predict(report, card, workdir / "train", data, device)
    cvae = run_cvae(report, card, workdir, device)
    wall_s = time.perf_counter() - t_phase
    print(f"  phase 14: {wall_s:.1f} s; {cvae['ms_per_step']:.2f} ms a CVAE step; B1 launches "
          f"{b1_edit} (edits) + {b1_predict} (Predictor) + {cvae['b1']} (CVAE), B2 "
          f"{cvae['b2']} [{card}]")
    report["phase14"] = dict(wall_s=wall_s, cvae_ms_per_step=cvae["ms_per_step"],
                             launches=dict(b1=b1_edit + b1_predict + cvae["b1"], b2=cvae["b2"]))
    return {**cvae, "b1": b1_edit + b1_predict + cvae["b1"]}


# ---------------------------------------------------------------------------
# phase 15: the ACTOR GAN (train_gan at the JAX CLI's defaults, hinge and
# wgan-gp), its per-class generation, evaluate_cvae on phase 14's CVAE and
# the SMPLify fit on phase 14's SMPL-X of the real size
# ---------------------------------------------------------------------------

GAN = dict(batch=32, T=60, latent_dim=256, layers=2, nnoise=16, Z=32, iters=8, classes=2,
           per_class=4, fit_T=60, fit_steps=300, fit_held=5)


def gan_launches(layers, iters, loss_mode, T, NN):
    """B1 and B2 on a train_gan run of `iters` iterations, G stepping every
    iteration (--repeat_D 1), by token count: D at T, G at its NN noise
    tokens. A D step runs G without a graph (B1 at NN) and D on the real and
    the fake batch (B2 at T, each once each way), under wgan-gp also on the
    interpolates, whose penalty adds a backward and the second-order term
    once per layer (its gradient, and the second pass back through D's
    forward); a G step runs G and D (B2 at NN and at T, once each way)."""
    wgan = loss_mode == "wgan-gp"

    def by_T(at_T, at_NN):
        return {t: n for t, n in ((T, layers * iters * at_T), (NN, layers * iters * at_NN)) if n}

    return {"b1_by_T": by_T(0, 1),
            "b2_by_T": {"forward": by_T(3 + wgan, 1), "backward": by_T(3 + 2 * wgan, 1)},
            "b2_double": layers * iters * wgan}


def gan_feeder(num_clips, seed=15):
    """`num_clips` in-memory Chi3D clips at the GAN's window."""
    from regennet_torch.data import synthetic
    from regennet_torch.data.feeder import Feeder

    T = GAN["T"]
    return Feeder(clips=synthetic.make_clips("chi3d", "train", num_clips=num_clips,
                                             min_len=T + 4, max_len=2 * T, seed=seed),
                  dataname="chi3d", split="train", num_frames=T, num_person=2,
                  pose_rep="rot6d")


def gan_args(save_dir, loss_mode):
    """train_gan's arguments: the JAX CLI's defaults (batch 32, 60 frames,
    latent 256, 16 noise tokens of 32 gp channels), one epoch, the widths
    GAN holds."""
    from regennet_torch.train import train_gan

    return train_gan.parse_args([
        "--data_path", "", "--save_dir", str(save_dir), "--num_epochs", "1", "--snapshot",
        "1", "--loss_mode", loss_mode, "--batch_size", str(GAN["batch"]), "--num_frames",
        str(GAN["T"]), "--latent_dim", str(GAN["latent_dim"]), "--nnoise",
        str(GAN["nnoise"]), "--noise_channel", str(GAN["Z"])])


def check_gan_kernels(report):
    """B1 and B2 (rate 0) at the GAN's shapes, head dim 64, f32, non-causal:
    D's [B, T, 256], G's [B, NN, 256] and the generation's [per_class, NN,
    256], against their plain versions at phases 2 and 2b's tolerances; and
    B2's second-order term (`_AttentionTrainBackward`, the backward kernel
    in its forward) under autograd against autograd's double backward of
    the plain version, within 1e-4 x max(1, max|plain|) (phase 4's bound).
    Returns the worst errors."""
    import torch

    from regennet_torch.ops import attention

    B, T, NN, D = GAN["batch"], GAN["T"], GAN["nnoise"], GAN["latent_dim"]
    b1 = [(B, NN, "float32"), (B, T, "float32"), (GAN["per_class"], NN, "float32")]
    b2 = [(B, T, "float32"), (B, NN, "float32")]
    worst, cases = hold_kernels_at(b1, b2, False, D, 4, seed=16, rate=0.0)
    gen = torch.Generator(device="cuda").manual_seed(17)
    second = 0.0
    for t in (T, NN):
        q, k, v, dout = (torch.randn(B, t, D, device="cuda", generator=gen).requires_grad_()
                         for _ in range(4))
        cot = [torch.randn(B, t, D, device="cuda", generator=gen) for _ in range(3)]
        seed = torch.randint(-2 ** 31, 2 ** 31, (B, 2), device="cuda", generator=gen,
                             dtype=torch.int32)
        cfg = attention._TrainConfig(4, 0.0, False, False, 0)
        out = attention._AttentionTrainBackward.apply(q, k, v, dout, seed, cfg)
        ours = torch.autograd.grad(sum((o * c).sum() for o, c in zip(out, cot)),
                                   (q, k, v, dout))
        first = torch.autograd.grad(attention.attention_btd_train_reference(
            q, k, v, 4, 0.0, seed, causal=False), (q, k, v), dout, create_graph=True)
        ref = torch.autograd.grad(sum((o * c).sum() for o, c in zip(first, cot)),
                                  (q, k, v, dout))
        for name, a, b in zip(("q", "k", "v", "dout"), ours, ref):
            err = max_abs_err(a, b)
            hold(f"B2's second-order term at [{B}, {t}, {D}]: d/d{name}", err,
                 1e-4 * max(1.0, float(b.abs().max())))
            second = max(second, err)
    worst["second_order"] = second
    report["gan_kernel_cases"] = cases
    print(f"  B1 and B2 (rate 0) at the GAN's head dim 64 ([{B}, {T} and {NN}, {D}], "
          f"[{GAN['per_class']}, {NN}, {D}], f32, non-causal) match their plain versions "
          f"(worst max_abs_err B1 {worst['forward']:.3g}, B2 forward "
          f"{worst['train_forward']:.3g}, backward {worst['backward']:.3g}); B2's "
          f"second-order term against autograd's double backward of the plain version: "
          f"worst {second:.3g} (1e-4 x max(1, max|plain|))")
    return worst


def time_gan_kernels(report, card):
    """B1 and B2 (rate 0) timed at D's [B, T, 256] and G's [B, NN, 256] as
    phase 2d times its shapes, and B2's second-order term (PyTorch ops) by
    device time beside its bound. Returns {T: (B1's timing, B2's timing)}
    and the second-order timings."""
    import torch

    from regennet_torch.ops import attention

    B, D, H = GAN["batch"], GAN["latent_dim"], 4
    timings, second = {}, {}
    for T in (GAN["T"], GAN["nnoise"]):
        timings[T] = time_btd_kernels(card, T, B=B, D=D, rate=0.0)
        gen = torch.Generator(device="cuda").manual_seed(18)
        x = [torch.randn(B, T, D, device="cuda", generator=gen) for _ in range(7)]
        seed = torch.zeros((B, 2), dtype=torch.int32, device="cuda")
        ms = device_ms(lambda: attention.attention_btd_train_double_backward(
            *x, H, 0.0, seed, False), iters=20)
        # q, k, v, dO and three cotangents in, four gradients out; the
        # softmax recomputed (QK^T) and ten more [T, T] x hd products
        bound, by = attention_bound_ms(B, T, D, H, "float32", False, None, tensors=11,
                                       products=11)
        # the plain version: autograd's double backward through the first-order
        # graph of attention_btd_train_reference (built once, outside the timing)
        q, k, v, dout = (t.clone().requires_grad_() for t in x[:4])
        first = torch.autograd.grad(attention.attention_btd_train_reference(
            q, k, v, H, 0.0, seed, causal=False), (q, k, v), dout, create_graph=True)
        inner = sum((o * c).sum() for o, c in zip(first, x[4:]))
        plain_ms = device_ms(lambda: torch.autograd.grad(inner, (q, k, v, dout),
                                                         retain_graph=True), iters=20)
        second[T] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
        print(f"  B2's second-order term f32 [{B}, {T}, {D}] (PyTorch ops): {ms:.4f} ms by "
              f"device time, autograd's double backward of the plain version "
              f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}) [{card}]")
    report["gan_attention_timing"] = {
        str(T): {"fused_attention_btd": b1, "fused_attention_btd_train": b2,
                 "second_order": second[T]} for T, (b1, b2) in timings.items()}
    return timings, second


def run_gan_training(report, card, workdir, loss_mode, data, device="cuda"):
    """train_gan at the JAX CLI's defaults for one epoch of GAN["iters"]
    batches, each D and G step synchronised and timed; the launches by T and
    the second-order calls against gan_launches. Returns (G, D, args,
    counts, {"d_ms", "g_ms"})."""
    import numpy as np
    import torch

    from regennet_torch.train import train_gan

    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    args = gan_args(workdir / f"gan_{loss_mode}", loss_mode)
    times = {"d": [], "g": []}
    make = train_gan.make_gan_steps

    def timed(step, into):
        def run(*a, **kw):
            sync()
            t0 = time.perf_counter()
            out = step(*a, **kw)
            sync()
            into.append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    def timed_make(*a, **kw):
        d_step, g_step = make(*a, **kw)
        return timed(d_step, times["d"]), timed(g_step, times["g"])

    train_gan.make_gan_steps = timed_make
    try:
        (G, D), counts = counted_run(lambda: train_gan.main(args, device=device, data=data),
                                     device)
    finally:
        train_gan.make_gan_steps = make
    iters = len(times["d"])
    layers = len(D.encoder.layers)
    want = gan_launches(layers * (device != "cpu"), iters, loss_mode, GAN["T"], GAN["nnoise"])
    got = {k: counts[k] for k in want}
    if iters != GAN["iters"] or len(times["g"]) != iters or got != want:
        raise AssertionError(f"train_gan {loss_mode}: {iters} D steps, {len(times['g'])} G "
                             f"steps; launches {got} (want {want})")
    for p in list(G.parameters()) + list(D.parameters()):
        if not torch.isfinite(p).all():
            raise AssertionError(f"train_gan {loss_mode}: a parameter is not finite")
    ms = {k: float(np.median(v[1:])) if len(v) > 1 else v[0] for k, v in times.items()}
    print(f"  train_gan {loss_mode} (G and D {layers} layers, latent {args.latent_dim}, batch "
          f"{args.batch_size}, D at T {args.num_frames}, G at {args.nnoise} tokens): {iters} "
          f"iterations, D step {ms['d']:.2f} ms, G step {ms['g']:.2f} ms (synchronised, median "
          f"after the first), the run {counts['wall_s']:.2f} s; B1 by T {counts['b1_by_T']}, "
          f"B2 by T {counts['b2_by_T']}, second-order calls {counts['b2_double']} [{card}]")
    report[f"gan_{loss_mode}"] = dict(iters=iters, d_ms=ms["d"], g_ms=ms["g"],
                                      d_step_ms=times["d"], g_step_ms=times["g"],
                                      wall_s=counts["wall_s"],
                                      launches={k: counts[k] for k in want})
    return G, D, args, counts, ms


def check_gan_d_step(report, G, D, data, args, loss_mode, device="cuda"):
    """One d_step (the trained G and D, one batch, one alpha) through the
    kernels against the same step through the plain attention, which
    autograd differentiates twice: the losses within 1e-4 relative; each
    gradient within 1e-4 x max(1, max|g|) (phase 4's bound); each updated
    parameter within 1e-4 x max(1, max|p|), or 2 lr more where |g| <= 1e-4
    x max|g| (AdamW's first step takes the gradient's sign there). Under
    wgan-gp this is what catches a second-order term dropped on the card;
    the kernel route's second-order calls must be one per D layer."""
    import numpy as np
    import torch

    from regennet_torch.data.collate import collate
    from regennet_torch.data.get_data import BatchLoader
    from regennet_torch.models import actor_gan, transformer
    from regennet_torch.ops import attention

    motion, cond = next(iter(BatchLoader(data, args.batch_size, collate, seed=1)))
    x = torch.as_tensor(motion, device=device)
    y = torch.as_tensor(cond["y"]["action"][:, 0], device=device)
    rng = np.random.default_rng(5)
    noise = torch.as_tensor(actor_gan.gen_noise(rng, args.batch_size, args.nnoise,
                                                args.noise_channel, mode=args.noise_mode),
                            device=device)
    y_fake = y if loss_mode == "wgan-gp" else torch.as_tensor(
        rng.integers(0, data.num_actions, args.batch_size), device=device)
    alpha = torch.rand((x.shape[0], 1, 1, 1), generator=torch.Generator(device=device)
                       .manual_seed(7), device=device)
    start = {n: p.detach().clone() for n, p in D.named_parameters()}
    b2 = attention.fused_attention_btd_train
    runs = {}
    for route, attend in (("kernel", b2), ("plain", attention.attention_btd_train_reference)):
        with torch.no_grad():
            for n, p in D.named_parameters():
                p.copy_(start[n])
        opt_d, opt_g = actor_gan.make_optimizers(D, G, args.base_lr, args.D_lr_mult,
                                                 args.beta1, args.weight_decay)
        d_step, _ = actor_gan.make_gan_steps(
            G, D, opt_d, opt_g, loss_mode=loss_mode, lambda_gp=args.lambda_gp,
            generator=torch.Generator(device=device).manual_seed(12))
        transformer.fused_attention_btd_train = attend
        b2.double_backward_launches = 0
        try:
            metrics = d_step(x, y, noise, y_fake, alpha=alpha)
        finally:
            transformer.fused_attention_btd_train = b2
        runs[route] = ({k: float(v) for k, v in metrics.items()},
                       {n: p.grad.clone() for n, p in D.named_parameters()},
                       {n: p.detach().clone() for n, p in D.named_parameters()},
                       b2.double_backward_launches)
    with torch.no_grad():
        for n, p in D.named_parameters():
            p.copy_(start[n])
    (loss_k, grads_k, params_k, double_k), (loss_p, grads_p, params_p, _) = (
        runs["kernel"], runs["plain"])
    for name, value in loss_p.items():
        hold(f"the {loss_mode} d_step's {name}", abs(loss_k[name] - value),
             1e-4 * max(1.0, abs(value)))
    lr = args.base_lr * args.D_lr_mult
    worst = (-1.0, "")
    for n, g in grads_p.items():
        g_scale = float(g.abs().max())
        err, tol = max_abs_err(grads_k[n], g), 1e-4 * max(1.0, g_scale)
        hold(f"the {loss_mode} d_step's gradient of {n}", err, tol)
        worst = max(worst, (err / tol, n))
        tol_p = 1e-4 * max(1.0, float(params_p[n].abs().max()))
        diff = (params_k[n] - params_p[n]).abs()
        signed = g.abs() <= 1e-4 * g_scale
        hold(f"the {loss_mode} d_step's update of {n}", float(diff[~signed].max())
             if (~signed).any() else 0.0, tol_p)
        hold(f"the {loss_mode} d_step's update of {n} where |g| is tiny",
             float(diff[signed].max()) if signed.any() else 0.0, 2 * lr + tol_p)
    layers = len(D.encoder.layers)
    want_double = layers * (loss_mode == "wgan-gp") * (device != "cpu")
    if double_k != want_double:
        raise AssertionError(f"the {loss_mode} d_step ran B2's second-order term {double_k} "
                             f"times (want {want_double})")
    print(f"  one {loss_mode} d_step through the kernels vs the plain attention: lossD "
          f"{loss_k['lossD']:.6f} vs {loss_p['lossD']:.6f}; all {len(grads_p)} gradients "
          f"within 1e-4 x max(1, max|g|), the worst {worst[1]} at {worst[0]:.3f} of it; the "
          f"updated parameters within the bound; second-order calls {double_k}")
    report[f"gan_{loss_mode}_d_step_check"] = dict(
        loss_kernel=loss_k, loss_plain=loss_p, second_order_calls=double_k,
        worst_gradient=dict(name=worst[1], share=worst[0]))


def run_gan_eval(report, card, workdir, device="cuda"):
    """evaluate_cvae debug (1 seed, a random full-width ST-GCN drawn from
    --seed, --other_metrics) on phase 14's CVAE checkpoint over its
    in-memory Chi3D clips: every YAML value finite, B1 once per decoder
    layer and generated batch at the CVAE's T. Returns the counts."""
    import copy

    from regennet_torch.eval import evaluate_cvae
    from regennet_torch.eval.tools import load_metrics

    model_path = workdir / "cvae" / "model000000001.pt"
    data = cvae_feeder()
    args = evaluate_cvae.parse_args([
        "--model_path", str(model_path), "--data_path", "", "--dataset", "chi3d",
        "--eval_mode", "debug", "--other_metrics", "--batch_size", str(GAN["batch"])])
    metrics, counts = counted_run(lambda: evaluate_cvae.main(args, device=device, data=data),
                                  device)
    log = model_path.parent / "evaluation_results_cvae_debug_1.yaml"
    saved = load_metrics(str(log))
    values = [float(v) for group in saved.values() for vs in group.values() for v in vs]
    if set(saved) != {"feats", "other"} or set(saved["feats"]) != set(metrics["feats"]) or \
            not all(math.isfinite(v) for v in values):
        raise AssertionError(f"evaluate_cvae: {log.name} holds {saved}")
    layers = CVAE["layers"] * (device != "cpu")
    splits = []
    for split in ("train", "test"):
        splits.append(copy.deepcopy(data))
        splits[-1].split = split
    batch = min(GAN["batch"], *(len(d) for d in splits))
    gen_batches = sum(-(-len(d) // batch) for d in splits)
    want = {CVAE["T"]: layers * gen_batches} if layers else {}
    if counts["b1_by_T"] != want or counts["b2"]["forward"]:
        raise AssertionError(f"evaluate_cvae: B1 by T {counts['b1_by_T']} (want {want}), B2 "
                             f"{counts['b2']}")
    feats = saved["feats"]
    print(f"  evaluate_cvae debug on phase 14's CVAE ({len(data)} clips a split, batch "
          f"{batch}, random ST-GCN, --other_metrics): {len(values)} values finite, "
          f"accuracy_gen_test {feats['accuracy_gen_test'][0]}, fid_gen_test "
          f"{feats['fid_gen_test'][0]}, acceleration {saved['other']['acceleration'][0]}; "
          f"{counts['wall_s']:.2f} s; B1 by T {counts['b1_by_T']} [{card}]")
    report["gan_eval"] = dict(wall_s=counts["wall_s"], metrics=saved,
                              launches=counts["b1_by_T"])
    return counts


def run_fit(report, card, workdir, device="cuda"):
    """fit_sequence on phase 14's SMPL-X of the real size: 60 frames of
    joints posed from seeded axis-angles, GAN["fit_steps"] Adam steps on the
    card from a seeded init_pose6d, timed; its first GAN["fit_held"] losses
    against a CPU copy from the same init, within 1e-4 x max(1, |cpu|); its
    last loss below its first. Returns the ms per step."""
    import numpy as np
    import torch

    from regennet_torch.ops import body_model, lbs
    from regennet_torch.ops import rotations as geo
    from regennet_torch.visualize.joints2smpl import fit_sequence

    smplx = body_model.load_smplx_npz(str(workdir / "body_models" / "smplx" /
                                          "SMPLX_NEUTRAL.npz"))
    T, J = GAN["fit_T"], smplx.num_joints
    rng = np.random.default_rng(19)
    with torch.no_grad():
        gt_aa = torch.as_tensor(0.2 * rng.normal(size=(T, J, 3)), dtype=torch.float32)
        target = lbs.joints(smplx, geo.axis_angle_to_matrix(gt_aa))
        target = (target - target[:, :1]).numpy()
    init = np.tile(np.asarray([1.0, 0, 0, 0, 1.0, 0], np.float32), (T, J, 1))
    init += 0.01 * rng.normal(size=init.shape).astype(np.float32)
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    on_device = smplx.to(device)
    sync()
    t0 = time.perf_counter()
    fit = fit_sequence(on_device, target, num_steps=GAN["fit_steps"], init_pose6d=init)
    sync()
    ms = (time.perf_counter() - t0) * 1e3 / GAN["fit_steps"]
    held = GAN["fit_held"]
    ref = fit_sequence(smplx, target, num_steps=held, init_pose6d=init)
    for i, (a, b) in enumerate(zip(fit["losses"][:held], ref["losses"])):
        hold(f"the fit's loss {i} on the card against a CPU copy", abs(float(a) - float(b)),
             1e-4 * max(1.0, abs(float(b))))
    losses = fit["losses"]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"fit_sequence: losses {losses[0]} -> {losses[-1]}")
    print(f"  fit_sequence on SMPL-X ({smplx.num_vertices} vertices, {J} joints), {T} frames, "
          f"{GAN['fit_steps']} steps: {ms:.3f} ms a step (the whole fit, synchronised), loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}; the first {held} losses equal a CPU copy's "
          f"within 1e-4 x max(1, |cpu|) [{card}]")
    report["gan_fit"] = dict(frames=T, steps=GAN["fit_steps"], ms_per_step=ms,
                             first_loss=float(losses[0]), last_loss=float(losses[-1]))
    return ms


def run_phase15(report, card, workdir, device="cuda"):
    """Phase 15 in the workdir of phase 14 (cvae/ and body_models/): train_gan
    in both loss modes with a d_step of each held against the plain
    attention, gen_samples_per_class, evaluate_cvae and the fit. Returns
    the launches ({"b1", "b2", "b1_by_T", "b2_by_T", "b2_double"})."""
    import numpy as np

    from regennet_torch.models import actor_gan

    t_phase = time.perf_counter()
    data = gan_feeder(GAN["iters"] * GAN["batch"])
    runs, ms = [], {}
    for loss_mode in ("hinge", "wgan-gp"):
        G, D, args, counts, ms[loss_mode] = run_gan_training(report, card, workdir, loss_mode,
                                                             data, device)
        check_gan_d_step(report, G, D, data, args, loss_mode, device)
        runs.append(counts)
    noise_cfg = dict(NN=args.nnoise, Z=args.noise_channel, lambda_noise=args.lambda_noise,
                     mode=args.noise_mode, length_scale=args.length_scale)
    samples, gen = counted_run(lambda: actor_gan.gen_samples_per_class(
        G, GAN["classes"], noise_cfg, per_class=GAN["per_class"], seed=0), device)
    want_shape = (GAN["classes"], GAN["per_class"], 56, 12, GAN["T"])
    layers = len(G.encoder.layers) * (device != "cpu")
    want_b1 = {GAN["nnoise"]: layers * GAN["classes"]} if layers else {}
    if samples.shape != want_shape or not np.isfinite(samples).all() or \
            gen["b1_by_T"] != want_b1:
        raise AssertionError(f"gen_samples_per_class: {samples.shape} (want {want_shape}), "
                             f"B1 by T {gen['b1_by_T']} (want {want_b1})")
    print(f"  gen_samples_per_class: {GAN['classes']} classes x {GAN['per_class']} samples "
          f"{list(samples.shape[2:])} finite; B1 by T {gen['b1_by_T']} [{card}]")
    evaluation = run_gan_eval(report, card, workdir, device)
    fit_ms = run_fit(report, card, workdir, device)
    runs += [gen, evaluation]

    def add(dicts):
        return {t: sum(d.get(t, 0) for d in dicts) for t in sorted({t for d in dicts for t in d})}

    out = {"b1": sum(r["b1"] for r in runs),
           "b2": {w: sum(r["b2"][w] for r in runs) for w in ("forward", "backward")},
           "b1_by_T": add([r["b1_by_T"] for r in runs]),
           "b2_by_T": {w: add([r["b2_by_T"][w] for r in runs]) for w in ("forward", "backward")},
           "b2_double": sum(r["b2_double"] for r in runs)}
    wall_s = time.perf_counter() - t_phase
    print(f"  phase 15: {wall_s:.1f} s; D step hinge {ms['hinge']['d']:.2f} ms, wgan-gp "
          f"{ms['wgan-gp']['d']:.2f} ms; G step {ms['hinge']['g']:.2f} ms; the fit "
          f"{fit_ms:.3f} ms a step; B1 launches {out['b1']}, B2 {out['b2']}, second-order "
          f"calls {out['b2_double']} [{card}]")
    report["phase15"] = dict(wall_s=wall_s, step_ms=ms, fit_ms_per_step=fit_ms,
                             launches={k: out[k] for k in ("b1", "b2", "b2_double")})
    return out


# ---------------------------------------------------------------------------
# phase 16: the distributed trainer (two ranks over gloo sharing the one card,
# and a real NCCL group at world 1 with FSDP), the sampler extras and the VLB
# terms on the flagship model, and torch_ckpt --check on the earlier phases'
# checkpoints. One card shows the collectives' correctness, not their cost.
# ---------------------------------------------------------------------------

DIST = dict(batch=64, steps=4, sample_respacing="10", sample_rows=8)
DIST_TOL = 1e-5  # x max(1, max|one process|), as the CPU tests hold the sharded steps
NOISE_M = 1e-6  # x max|m|: below it a first moment is rounding noise (the CPU tests' rule)
EXTRAS = dict(respacing="50", batch=16, order=2, cpu_rows=1)
# the kinds of the earlier phases' checkpoints (4: online, 5: offline, 7: gru
# and mlp, 10: the ST-GCNs, 11: the CLIP tower, 12: the T2M evaluators and
# the length estimator, 13: comp_v6, 14: the CVAE)
CKPT_KINDS = ("cmdm/online", "cmdm/offline", "cmdm/gru", "cmdm/mlp", "stgcn", "clip_text",
              "t2m", "length_est", "comp_v6", "actor/transformer")


def dist_args(save_dir, **over):
    """The flagship training configuration for phase 16's runs: DIST's
    global batch and steps, one step per call, every step logged."""
    args = train_args(save_dir)
    vars(args).update(batch_size=DIST["batch"], num_steps=DIST["steps"],
                      save_interval=DIST["steps"], log_interval=1, steps_per_call=1)
    vars(args).update(over)
    return args


class Batches(list):
    """Collated (motion, cond) batches served as train_mdm's loader: their
    count, iteration, and `.dataset` (the action count the model reads)."""

    def __init__(self, batches, num_actions):
        super().__init__(batches)
        self.dataset = Namespace(num_actions=num_actions)


def rank_rows(batch, rank, size):
    """A data rank's rows of a collated global batch."""
    motion, cond = batch
    n = len(motion) // size
    rows = slice(rank * n, (rank + 1) * n)

    def cut(v):
        return v[rows] if hasattr(v, "__len__") and len(v) == len(motion) else v

    return cut(motion), {"y": {k: cut(v) for k, v in cond["y"].items()}}


def dist_batches(args):
    """DIST["steps"] global batches of the in-memory Chi3D clips and the
    action count, as phase 4 builds its loader."""
    from regennet_torch.data import synthetic
    from regennet_torch.data.feeder import Feeder
    from regennet_torch.data.get_data import BatchLoader, get_collate_fn
    from regennet_torch.utils.fixseed import fixseed

    T, B = args.num_frames, args.batch_size
    fixseed(args.seed)
    clips = synthetic.make_clips("chi3d", "train", num_clips=B * DIST["steps"],
                                 min_len=T + 10, max_len=T + 60)
    feeder = Feeder(clips=clips, dataname="chi3d", split="train", num_frames=T,
                    num_person=2, pose_rep="rot6d")
    loader = BatchLoader(feeder, B, get_collate_fn("chi3d", "cmdm"), shuffle=False)
    return list(loader)[:DIST["steps"]], feeder.num_actions


def sample_cond(batches, rows, device):
    import torch

    y = batches[0][1]["y"]
    return {k: torch.as_tensor(y[k][:rows], device=device) for k in ("cmotion", "action")}


def dist_sample(model, loop, batches, device):
    """DDPM at DIST's respacing over DIST["sample_rows"] rows through
    `model` (tensor-parallel on a tensor-parallel rank), with `loop`'s
    diffusion."""
    import torch

    from regennet_torch.diffusion import sampling
    from regennet_torch.diffusion.schedule import make_schedule
    from regennet_torch.models.cmdm import make_model_fn

    sched = make_schedule("cosine", loop.sched.original_num_steps,
                          timestep_respacing=DIST["sample_respacing"], device=device)
    cond = sample_cond(batches, DIST["sample_rows"], device)
    shape = (DIST["sample_rows"],) + tuple(batches[0][0].shape[1:])
    return sampling.p_sample_loop(sched, loop.cfg, make_model_fn(model.eval()), shape, cond,
                                  clip_denoised=False,
                                  generator=torch.Generator(device).manual_seed(7))


def dist_rank(rank, world, init, workdir, device, scenarios, settings):
    """One rank of phase 16 (started by torch.multiprocessing): init is
    "gloo:<tcp address>" (this rank joins a gloo group) or "env:<port>"
    (the launcher's variables; train_mdm starts the group, NCCL on a card).
    Runs train_mdm.main for each (name, options) of `scenarios` on the
    rank's rows of the global batches, and writes its launches, layout and
    (tensor-parallel) sample to workdir. settings: the parent's FLAGSHIP,
    TRAIN and DIST (a rehearsal cuts them)."""
    sys.path.insert(0, str(REPO))
    for name, value in settings.items():
        globals()[name].update(value)
    os.environ["REGENNET_LOG_FORMAT"] = "human,json"
    import numpy as np
    import torch
    import torch.distributed as dist

    from regennet_torch.device import pin_f32_contract
    from regennet_torch.train import train_mdm

    workdir = Path(workdir)
    if device == "cuda":
        device = "cuda:0"  # the one card that every rank shares
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    kind, where = init.split(":", 1)
    if kind == "gloo":
        dist.init_process_group("gloo", init_method=where, rank=rank, world_size=world)
    else:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                          MASTER_ADDR="localhost", MASTER_PORT=where)
    batches, num_actions = torch.load(workdir / "batches.pt", weights_only=False)
    pin_f32_contract()
    results = {}
    for name, over in scenarios:
        model_size = over.get("tensor_parallel", 1)
        size = world // model_size
        data = Batches([rank_rows(b, rank // model_size, size) for b in batches], num_actions)
        args = dist_args(workdir / name, batch_size=DIST["batch"] // size,
                         overwrite=True, **over)
        loop, counts = counted_run(lambda: train_mdm.main(
            args, device=None if kind == "env" else device, data=data), device)
        layout = loop.layout
        out = dict(b1=counts["b1"], b2=counts["b2"], wall_s=counts["wall_s"],
                   layout=[layout.data_rank, layout.data_size, layout.model_rank,
                           layout.model_size],
                   heads=sorted({m.num_heads for m in loop.model.modules()
                                 if hasattr(m, "in_proj_weight")}),
                   backend=dist.get_backend())
        if model_size > 1:
            sample, scounts = counted_run(
                lambda: dist_sample(loop.model, loop, batches, device), device)
            out["sample_b1"] = scounts["b1"]
            if rank == 0:
                np.save(workdir / f"{name}_sample.npy", sample.cpu().numpy())
        results[name] = out
    (workdir / f"rank{rank}_{init.split(':')[0]}.json").write_text(json.dumps(results))
    dist.destroy_process_group()


def start_ranks(world, init, workdir, device, scenarios):
    """Start dist_rank in `world` fresh processes; (their context, when
    they started, what join_ranks reads)."""
    import torch.multiprocessing as mp

    settings = {"FLAGSHIP": FLAGSHIP, "TRAIN": TRAIN, "DIST": DIST}
    ctx = mp.start_processes(dist_rank,
                             args=(world, init, str(workdir), device, scenarios, settings),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, time.perf_counter(), (world, init, workdir)


def join_ranks(started):
    """Wait for start_ranks' processes (raising if one failed); (their
    results by rank, seconds from their start)."""
    ctx, t0, (world, init, workdir) = started
    while not ctx.join():
        pass
    wall = time.perf_counter() - t0
    return [json.loads((Path(workdir) / f"rank{r}_{init.split(':')[0]}.json").read_text())
            for r in range(world)], wall


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def hold_state(what, run_dir, ref_dir, steps, lr):
    """A run's saved parameters and EMA against a reference run's within
    DIST_TOL x max(1, max|p|) (p: every parameter of the reference), its
    AdamW first moments within DIST_TOL x max(1, max|m|) of each tensor;
    where the reference's first moment is below NOISE_M of its tensor's
    largest entry (the rule of tests/test_torch_distributed.py: each
    self-attention's key bias, whose true gradient is 0), Adam's step is a
    ratio of rounding noise and the parameter and EMA may differ by up to lr
    a step. Returns {worst: the worst error outside that rule,
    worst_near_zero: inside it, near_zero_entries: the nonzero entries it
    covers, near_zero_max_ratio: their largest |m| / max|m|, at: the tensor,
    entry and |m| / max|m| of the worst error, tol}."""
    import torch

    def load(d):
        model = torch.load(Path(d) / f"model{steps:09d}.pt", map_location="cpu",
                           weights_only=True)
        opt = torch.load(Path(d) / f"opt{steps:09d}.pt", map_location="cpu", weights_only=False)
        state = opt["optimizer"]["state"]
        moments = {k: {n: state[i][k] for i, n in enumerate(opt["ema"])}
                   for k in ("exp_avg", "exp_avg_sq")}
        return model, opt["ema"], moments

    model, ema, moments = load(run_dir)
    ref_model, ref_ema, ref_moments = load(ref_dir)
    if set(model) != set(ref_model) or set(ema) != set(ref_ema):
        raise AssertionError(f"{what}: the checkpoint's names differ from the reference's")
    out = dict(worst=0.0, worst_near_zero=0.0, near_zero_entries=0, near_zero_max_ratio=0.0,
               at=None,
               tol=DIST_TOL * max(1.0, max(float(ref_model[n].abs().max()) for n in ref_ema)))
    for n in ref_ema:
        m = ref_moments["exp_avg"][n]
        noise = m.abs() < NOISE_M * m.abs().max()
        out["near_zero_entries"] += int((noise & (m != 0)).sum())
        if noise.any():
            out["near_zero_max_ratio"] = max(out["near_zero_max_ratio"], float(
                m.abs()[noise].max() / m.abs().max()))
        for kind, got, want in (("parameter", model[n], ref_model[n]),
                                ("EMA", ema[n], ref_ema[n]),
                                ("first moment", moments["exp_avg"][n], m)):
            tol = (DIST_TOL * max(1.0, float(m.abs().max())) if kind == "first moment"
                   else out["tol"])
            diff = (got.float() - want.float()).abs()
            if kind != "first moment" and noise.any():
                err = float(diff[noise].max())
                hold(f"{what}: {kind} {n} (near-zero gradient)", err,
                     max(tol, lr * steps * 1.01))
                out["worst_near_zero"] = max(out["worst_near_zero"], err)
                diff = torch.where(noise, torch.zeros_like(diff), diff)
            err = float(diff.max()) if diff.numel() else 0.0
            if err > out["worst"]:
                i = int(diff.argmax())
                out["worst"], out["at"] = err, (
                    kind, n, i, float(m.abs().flatten()[i] / m.abs().max()))
            hold(f"{what}: {kind} {n}", err, tol)
    return out


def run_distributed(report, card, workdir, device="cuda"):
    """Phase 16 (a) and (b): train_mdm at --data_parallel 2 and at
    --tensor_parallel 2 on two ranks over gloo (both on `device`), then at
    --data_parallel 1 and --param_sharding fsdp in a real NCCL group of one
    rank (on a card only), each DIST["steps"] steps of the global batch,
    held against train_mdm in this process on the same global batches; the
    FSDP checkpoint is sampled by cgenerate. Returns the launches."""
    import copy

    import numpy as np
    import torch

    from regennet_torch.train import train_mdm

    t0 = time.perf_counter()
    walls = {}
    ref_args = dist_args(workdir / "one")
    batches, num_actions = dist_batches(ref_args)
    torch.save((batches, num_actions), workdir / "batches.pt")
    # the ranks run beside each other and beside the one-process reference
    # here (each process holds its own copy of the model on the card)
    gloo_ranks = start_ranks(2, f"gloo:tcp://localhost:{free_port()}", workdir, device,
                             [("dp", {"data_parallel": 2}),
                              ("tp", {"tensor_parallel": 2, "num_steps": 1})])
    nccl = device != "cpu" and torch.distributed.is_nccl_available()
    if nccl:
        nccl_rank = start_ranks(1, f"env:{free_port()}", workdir, device,
                                [("dp1", {"data_parallel": 1}),
                                 ("fsdp", {"data_parallel": 1, "param_sharding": "fsdp"})])
    os.environ["REGENNET_LOG_FORMAT"] = "human,json"
    ref, ref_counts = counted_run(lambda: train_mdm.main(
        ref_args, device=device, data=Batches(batches, num_actions)), device)
    walls["one_process"] = ref_counts["wall_s"]
    runs = [ref_counts]

    def losses(run_dir):
        with open(Path(run_dir) / "progress.json") as f:
            return [float(json.loads(line)["loss"]) for line in f]

    ref_losses = losses(workdir / "one")
    out = {"one_process_losses": ref_losses}
    # data parallel for DIST["steps"] steps; tensor parallel one step (the
    # one-process run saved after its first step too)
    gloo, walls["gloo_ranks"] = join_ranks(gloo_ranks)
    for name, layouts, steps in (("dp", [[0, 2, 0, 1], [1, 2, 0, 1]], DIST["steps"]),
                                 ("tp", [[0, 1, 0, 2], [0, 1, 1, 2]], 1)):
        got = [r[name]["layout"] for r in gloo]
        if got != layouts or any(r[name]["backend"] != "gloo" for r in gloo):
            raise AssertionError(f"phase 16 {name}: layouts {got}")
        runs += [dict(b1=r[name]["b1"] + r[name].get("sample_b1", 0), b2=r[name]["b2"])
                 for r in gloo]
        run_losses = losses(workdir / name)
        hold(f"phase 16 {name}: the losses against one process",
             float(np.max(np.abs(np.subtract(run_losses, ref_losses[:steps])))),
             DIST_TOL * max(1.0, max(ref_losses)))
        print(f"  {name} over gloo, 2 ranks on {device}: losses {run_losses} (one process "
              f"{ref_losses[:steps]}); heads per rank {gloo[0][name]['heads']}; B2 launches "
              f"per rank {gloo[0][name]['b2']}; train_mdm {gloo[0][name]['wall_s']:.1f} s")
        state = hold_state(f"phase 16 {name}", workdir / name, workdir / "one", steps,
                           ref_args.lr)
        out[name] = dict(losses=run_losses, steps=steps, **state,
                         ranks=[{k: r[name][k] for k in ("b1", "b2", "heads", "wall_s")}
                                for r in gloo])
        print(f"    parameters, EMA and AdamW first moments within {state['worst']:.3g} of one "
              f"process (tolerance {state['tol']:.3g}; the worst: {state['at']}); "
              f"{state['near_zero_entries']} entries of near-zero gradient (|m| below "
              f"{state['near_zero_max_ratio']:.3g} of its tensor's largest) within "
              f"{state['worst_near_zero']:.3g} (lr {ref_args.lr:g} a step)")
    layers = ref_args.layers
    if gloo[0]["tp"]["heads"] != [FLAGSHIP["heads"] // 2] or \
            gloo[0]["tp"]["sample_b1"] != layers * int(DIST["sample_respacing"]) * \
            (device != "cpu"):
        raise AssertionError(f"phase 16 tp: heads {gloo[0]['tp']['heads']}, sampling B1 "
                             f"{gloo[0]['tp']['sample_b1']}")
    # the tensor-parallel model's DDPM against one process on its own weights
    # (its whole checkpoint)
    from regennet_torch.train import checkpoint

    whole = checkpoint.load_model(copy.deepcopy(ref.model), str(workdir / "tp" /
                                                             f"model{1:09d}.pt"))
    ref_sample = dist_sample(whole, ref, batches, device)
    tp_sample = torch.tensor(np.load(workdir / "tp_sample.npy"))
    err = max_abs_err(tp_sample, ref_sample.cpu())
    tol = 1e-4 * max(1.0, float(ref_sample.abs().max()))
    hold("phase 16 tp: DDPM through the tensor-parallel model", err, tol)
    out["tp"]["sample_err"] = err
    print(f"  tp sampling (DDPM {DIST['sample_respacing']} steps, {DIST['sample_rows']} rows, "
          f"B1 at {gloo[0]['tp']['heads'][0]} heads a rank): max_abs_err {err:.3g} against one "
          f"process on the same weights (tolerance {tol:.3g})")

    if not nccl:
        out["nccl"] = "skipped: no NCCL (CPU rehearsal)"
    else:
        (ranked,), walls["nccl_rank"] = join_ranks(nccl_rank)
        if any(ranked[n]["backend"] != "nccl" for n in ("dp1", "fsdp")):
            raise AssertionError(f"phase 16: backend {ranked['dp1']['backend']}")
        runs += [dict(b1=ranked[n]["b1"], b2=ranked[n]["b2"]) for n in ("dp1", "fsdp")]
        dp1 = hold_state("phase 16 NCCL dp1", workdir / "dp1", workdir / "one",
                         DIST["steps"], ref_args.lr)
        fsdp = hold_state("phase 16 NCCL fsdp", workdir / "fsdp", workdir / "dp1",
                          DIST["steps"], ref_args.lr)
        from regennet_torch.data import synthetic
        from regennet_torch.data.feeder import Feeder
        from regennet_torch.sample import cgenerate

        T = ref_args.num_frames
        clips = Feeder(clips=synthetic.make_clips("chi3d", "test", num_clips=4, min_len=T + 10,
                                                  max_len=2 * T),
                       dataname="chi3d", split="test", num_frames=T, num_person=2,
                       pose_rep="rot6d")
        gen_args = request_args(workdir / "fsdp_samples", 4, 1.0, "float32", seed=0)
        gen_args.model_path = str(workdir / "fsdp" / f"model{DIST['steps']:09d}.pt")
        gen_args.timestep_respacing = "ddim10"
        gen_args.use_ddim = True
        npy, gen_counts = counted_run(
            lambda: cgenerate.main(gen_args, device=device, data=clips), device)
        walls["cgenerate"] = gen_counts["wall_s"]
        runs.append(gen_counts)
        results = np.load(npy, allow_pickle=True).item()
        if not np.isfinite(results["output"]).all():
            raise AssertionError("phase 16: cgenerate on the FSDP checkpoint is not finite")
        out["nccl"] = dict(dp1=dp1, fsdp=fsdp,
                           losses={n: losses(workdir / n) for n in ("dp1", "fsdp")},
                           cgenerate_shape=list(results["output"].shape))
        print(f"  NCCL at world 1: dp1 within {dp1['worst']:.3g} of one process "
              f"({dp1['worst_near_zero']:.3g} at near-zero gradients), fsdp within "
              f"{fsdp['worst']:.3g} of dp1 ({fsdp['worst_near_zero']:.3g}); cgenerate on "
              f"fsdp's model{DIST['steps']:09d}.pt: {list(results['output'].shape)} finite")
    out["wall_s"] = time.perf_counter() - t0
    out["walls"] = walls
    print(f"  walls: {', '.join(f'{k} {v:.1f} s' for k, v in walls.items())}")
    report["phase16_distributed"] = out
    return runs, ref


def extras_model_calls(steps, order):
    """The denoiser calls of phase 16's sampler extras over `steps` steps:
    PLMS (at order > 1 its first step, the pseudo improved Euler, calls the
    model twice), the reverse DDIM loop then DDIM, and the bpd loop. B1
    launches layers times each."""
    return {"plms": steps + (order > 1), "round_trip": 2 * steps, "bpd": steps}


def run_sampler_extras(report, card, loop, batches, device="cuda"):
    """Phase 16 (c), at EXTRAS' respacing and batch on the trained flagship
    model: PLMS at EXTRAS["order"] (steps + 1 model calls), the reverse DDIM
    loop then DDIM (the round trip's error printed), and calc_bpd_loop
    (finite); PLMS held on EXTRAS["cpu_rows"] rows against a CPU copy.
    Returns the launches."""
    import copy

    import numpy as np
    import torch

    from regennet_torch.diffusion import losses, sampling
    from regennet_torch.diffusion.schedule import make_schedule
    from regennet_torch.models.cmdm import make_model_fn

    sched = make_schedule("cosine", loop.sched.original_num_steps,
                          timestep_respacing=EXTRAS["respacing"], device=device)
    steps, B, layers = sched.num_timesteps, EXTRAS["batch"], loop.args.layers
    model = loop.model.eval()
    cond = sample_cond(batches, B, device)
    x0 = torch.as_tensor(batches[0][0][:B], device=device)
    shape = tuple(x0.shape)
    noise = torch.randn(shape, generator=torch.Generator().manual_seed(3)).to(device)
    on_card = device != "cpu"
    calls = {}

    def plms():
        return sampling.plms_sample_loop(sched, loop.cfg, make_model_fn(model), shape, cond,
                                         clip_denoised=False, noise=noise,
                                         order=EXTRAS["order"])

    def round_trip():
        xT = sampling.ddim_reverse_sample_loop(sched, loop.cfg, make_model_fn(model), x0, cond,
                                               clip_denoised=False)
        back = sampling.ddim_sample_loop(sched, loop.cfg, make_model_fn(model), shape, cond,
                                         clip_denoised=False, noise=xT,
                                         step_noise=[torch.zeros(shape)] * steps)
        return xT, back

    def bpd():
        return losses.calc_bpd_loop(sched, loop.cfg, make_model_fn(model), x0, cond,
                                    generator=torch.Generator(device).manual_seed(5))

    sample, calls["plms"] = counted_run(plms, device)
    (xT, back), calls["round_trip"] = counted_run(round_trip, device)
    terms, calls["bpd"] = counted_run(bpd, device)
    for name, n in extras_model_calls(steps, EXTRAS["order"]).items():
        if calls[name]["b1"] != layers * n * on_card:
            raise AssertionError(f"phase 16 {name}: B1 launches {calls[name]['b1']} != "
                                 f"{layers} x {n}")
    finite = all(bool(torch.isfinite(t).all()) for t in (sample, xT, back, *terms.values()))
    if not finite or terms["vb"].shape != (B, steps):
        raise AssertionError("phase 16: the sampler extras gave non-finite or misshapen output")
    round_err = max_abs_err(back.cpu(), x0.cpu())

    # PLMS on the first rows against a CPU copy of the model
    rows = EXTRAS["cpu_rows"]
    t_cpu = time.perf_counter()
    cpu_model = copy.deepcopy(model).cpu()
    cpu_sched = make_schedule("cosine", loop.sched.original_num_steps,
                              timestep_respacing=EXTRAS["respacing"])
    ref = sampling.plms_sample_loop(cpu_sched, loop.cfg, make_model_fn(cpu_model),
                                    (rows,) + shape[1:],
                                    {k: v[:rows].cpu() for k, v in cond.items()},
                                    clip_denoised=False, noise=noise[:rows].cpu(),
                                    order=EXTRAS["order"])
    cpu_s = time.perf_counter() - t_cpu
    err, tol = max_abs_err(sample[:rows].cpu(), ref), 1e-4 * max(1.0, float(ref.abs().max()))
    hold(f"phase 16: PLMS order {EXTRAS['order']} on {device} against a CPU copy", err, tol)
    row = dict(respacing=EXTRAS["respacing"], batch=B, plms_order=EXTRAS["order"],
               launches={k: v["b1"] for k, v in calls.items()},
               ms={k: v["wall_s"] * 1e3 for k, v in calls.items()},
               round_trip_err=round_err, plms_cpu_err=err, plms_cpu_tol=tol, cpu_copy_s=cpu_s,
               total_bpd_mean=float(terms["total_bpd"].mean()),
               prior_bpd_mean=float(terms["prior_bpd"].mean()))
    report["phase16_extras"] = row
    print(f"  PLMS order {EXTRAS['order']}, {steps} steps, batch {B}: "
          f"{calls['plms']['wall_s'] * 1e3:.1f} ms, B1 {calls['plms']['b1']}; against a CPU "
          f"copy on {rows} row {err:.3g} (tolerance {tol:.3g}; {cpu_s:.1f} s on the host); "
          f"reverse DDIM then DDIM: "
          f"{calls['round_trip']['wall_s'] * 1e3:.1f} ms, round-trip max_abs_err "
          f"{round_err:.3g}; calc_bpd_loop {calls['bpd']['wall_s'] * 1e3:.1f} ms, total bpd "
          f"{row['total_bpd_mean']:.4f} (prior {row['prior_bpd_mean']:.3g}), B1 "
          f"{calls['bpd']['b1']} [{card}]")
    return list(calls.values())


def run_ckpt_check(report, card, root):
    """Phase 16 (d): torch_ckpt --check on every model file the earlier
    phases wrote under `root` (model<N>.pt, latest.tar, the CLIP tower):
    each detected kind loads strictly into the port's module, and every
    kind of CKPT_KINDS is among them. Files of no checker kind (a decomposition
    pair, a GAN's G and D) are listed."""
    import contextlib as cl
    import io

    from regennet_torch.convert import torch_ckpt

    t0 = time.perf_counter()
    checked, other = {}, []
    files = sorted(p for p in Path(root).rglob("*")
                   if p.is_file() and (re.fullmatch(r"model\d+\.pt", p.name)
                                       or p.name in ("latest.tar", "ViT-B-32.pt")))
    for path in files:
        import torch

        try:
            kind = torch_ckpt.detect_kind(torch.load(path, map_location="cpu",
                                                     weights_only=False))
        except ValueError:
            other.append(str(path.relative_to(root)))
            continue
        out = io.StringIO()
        with cl.redirect_stdout(out):
            torch_ckpt.main(["--check", str(path)])
        if not out.getvalue().startswith(f"OK: {path} is a valid {kind} checkpoint"):
            raise AssertionError(f"torch_ckpt --check {path}: {out.getvalue()}")
        checked.setdefault(kind, []).append(str(path.relative_to(root)))
    missing = sorted(set(CKPT_KINDS) - set(checked))
    if missing:
        raise AssertionError(f"torch_ckpt --check: no checkpoint of {missing} under {root}")
    report["phase16_ckpt_check"] = dict(checked=checked, other=other,
                                        seconds=time.perf_counter() - t0)
    print(f"  torch_ckpt --check: {sum(map(len, checked.values()))} files of "
          f"{len(checked)} kinds loaded strictly ({', '.join(sorted(checked))}); no checker "
          f"kind: {other} [{card}]")


def check_phase16_kernels(report):
    """B1 and B2 at phase 16's shapes (f32, causal: the online decoder's
    self-attention) against their plain versions, as phases 2 and 2b hold
    them. The tensor-parallel ranks: B2 at [DIST batch, T, D/2], 2 heads,
    each rank's [B, 3] seed (head0 0 and 2), at TRAIN["rate"], forward and
    gradients; its dropout mask against dropout_bits of that seed and
    against the same heads of the whole model's mask ([B, 2] seed, 4
    heads); B1 at [sample_rows, T, D/2]. The data-parallel ranks' B2 at
    [DIST batch / 2, T, D]; B1 at the extras' batch, the one-process DDPM's
    rows and cgenerate's 4 rows at [., T, D]. Returns the worst errors."""
    import torch

    from regennet_torch.ops import attention

    B, T, D, H = DIST["batch"], FLAGSHIP["T"], FLAGSHIP["latent_dim"], FLAGSHIP["heads"]
    Dl, Hl = D // 2, H // 2
    f32 = "float32"
    worst = {"forward": 0.0, "train_forward": 0.0, "backward": 0.0}
    cases = []
    for b1, b2, d, h, seed, head0 in (
            ([], [(B, T, f32)], Dl, Hl, 20, 0),
            ([], [(B, T, f32)], Dl, Hl, 21, Hl),
            ([(DIST["sample_rows"], T, f32)], [], Dl, Hl, 22, None),
            ([(EXTRAS["batch"], T, f32), (DIST["sample_rows"], T, f32), (4, T, f32)],
             [(B // 2, T, f32)], D, H, 23, None)):
        w, c = hold_kernels_at(b1, b2, True, d, h, seed=seed, head0=head0)
        worst = {k: max(v, w[k]) for k, v in worst.items()}
        cases += c
    rate = TRAIN["rate"]
    gen = torch.Generator(device="cuda").manual_seed(24)
    seeds = torch.randint(-2 ** 31, 2 ** 31, (B, 2), device="cuda", generator=gen,
                          dtype=torch.int32)
    whole = train_mask(B, T, rate, seeds, True, D, H)
    seen = torch.ones(T, T, dtype=torch.bool, device="cuda").tril()
    fracs = []
    for rank in (0, 1):
        seeds3 = torch.cat([seeds, torch.full((B, 1), rank * Hl, dtype=torch.int32,
                                              device="cuda")], dim=1)
        kept = train_mask(B, T, rate, seeds3, True, Dl, Hl)
        want = (attention.dropout_bits(seeds3, B, Hl, T)
                >= attention.dropout_threshold(rate)) & seen
        frac = float(kept.sum()) / (B * Hl * float(seen.sum()))
        if not (torch.equal(kept, want) and torch.equal(kept, whole[:, rank * Hl:(rank + 1) * Hl])
                and abs(frac - (1 - rate)) <= 0.005):
            raise AssertionError(f"phase 16: tensor-parallel rank {rank}'s dropout mask (keep "
                                 f"fraction {frac}) differs from dropout_bits of its [B, 3] "
                                 "seed or from the whole model's heads")
        fracs.append(frac)
    report["phase16_kernel_cases"] = cases
    report["phase16_tp_masks"] = dict(rate=rate, keep_fractions=fracs)
    print(f"  B2 at [{B}, {T}, {Dl}], {Hl} heads, [B, 3] seeds (head0 0 and {Hl}), rate {rate}; "
          f"B1 at [{DIST['sample_rows']}, {T}, {Dl}]; B2 at [{B // 2}, {T}, {D}]; B1 at "
          f"[{EXTRAS['batch']}, {DIST['sample_rows']} and 4, {T}, {D}]: match their plain "
          f"versions (worst max_abs_err B1 {worst['forward']:.3g}, B2 forward "
          f"{worst['train_forward']:.3g}, backward {worst['backward']:.3g} against the plain "
          f"backward; tolerance 1e-5 x max(1, max|plain|)); each tensor-parallel rank's "
          f"mask equals dropout_bits of its seed and heads 0-{Hl - 1} and {Hl}-{H - 1} of "
          f"the whole model's (keep fractions {fracs[0]:.5f}, {fracs[1]:.5f})")
    return worst


def run_phase16(report, card, workdir, device="cuda"):
    """Phase 16: run_distributed, run_sampler_extras on its one-process
    model, run_ckpt_check over `workdir` (the earlier phases' files).
    Returns {"b1", "b2"}: the launches of every run."""
    t0 = time.perf_counter()
    dist_dir = Path(workdir) / "dist"
    dist_dir.mkdir(exist_ok=True)
    runs, loop = run_distributed(report, card, dist_dir, device)
    batches, _ = __import__("torch").load(dist_dir / "batches.pt", weights_only=False)
    runs += run_sampler_extras(report, card, loop, batches, device)
    run_ckpt_check(report, card, workdir)
    out = {"b1": sum(r["b1"] for r in runs),
           "b2": {w: sum(r["b2"][w] for r in runs) for w in ("forward", "backward")}}
    wall_s = time.perf_counter() - t0
    report["phase16"] = dict(wall_s=wall_s, launches=out)
    print(f"  phase 16: {wall_s:.1f} s; B1 launches {out['b1']}, B2 {out['b2']} [{card}]")
    return out


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
        from regennet_torch.device import pin_f32_contract
        from regennet_torch.ops import attention, kernels
    except ImportError as e:
        print(f"chip_smoke: the regennet_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    pin_f32_contract()
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
    print("phase 2d: B1 and B2 timed at the a2m and text CMDMs' shapes (phases 10 and 11), "
          "the full-scale capability study's (head dim 32), the CVAE's (phase 14) and the "
          "GAN's (phase 15)")
    timings = time_model_kernels(report, card)
    cvae_timings = time_cvae_kernels(report, card)
    gan_timings, second_timings = time_gan_kernels(report, card)
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
        print("phase 6: eval_cmdm (debug) on phase 4's checkpoint; the ST-GCN trainer's f32 "
              "contract")
        eval_launches = run_eval(report, card, save_dir / f"model{TRAIN['steps']:09d}.pt")
        check_stgcn_tf32(report, card, Path(tmp))
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
        print("phase 11: the text-to-motion path (HumanML3D, CLIP, generate) at the CLIs' "
              "default width")
        t2m_worst = check_t2m_kernels(report)
        t2m = run_t2m(report, card, Path(tmp) / "t2m")
        print("phase 12: the text evaluation (train_t2m_eval, eval_humanml, the in-training "
              "route, generate --length_estimator) on phase 11's model")
        t2m_eval_worst = check_t2m_eval_kernels(report)
        t2m_eval = run_t2m_eval(report, card, Path(tmp) / "t2m")
        print("phase 13: the comp_v6 generator (train_t2m_gen, eval_humanml and generate's "
              "comp_v6 routes, motion_process) at its published widths")
        run_comp_v6(report, card, Path(tmp) / "t2m")
        print("phase 14: edit, the Predictor, the ACTOR CVAE (train_cvae, "
              "generate_sequences) and mesh rendering")
        cvae_worst = check_cvae_kernels(report)
        phase14 = run_phase14(report, card, Path(tmp), data)
        print("phase 15: the ACTOR GAN (train_gan hinge and wgan-gp, gen_samples_per_class), "
              "evaluate_cvae on phase 14's CVAE and the SMPLify fit")
        gan_worst = check_gan_kernels(report)
        phase15 = run_phase15(report, card, Path(tmp))
        print("phase 16: train_mdm at --data_parallel 2 and --tensor_parallel 2 (two ranks "
              "over gloo on this card), --param_sharding fsdp in an NCCL group of one, the "
              "sampler extras and the VLB terms, torch_ckpt --check on phases 4-15's files")
        p16_worst = check_phase16_kernels(report)
        phase16 = run_phase16(report, card, Path(tmp))
    bf16_b2 = {w: bf16_train[w] + sum(t[w] for t in bf16_trunks)
               for w in ("forward", "backward")}
    paths = {"fused_attention_btd": {"phase 3": launches, "phase 5": offline_launches,
                                     "phase 6": eval_launches,
                                     "phase 8": guard["fused_attention_btd"],
                                     "phase 9": bf16_b1, "phase 10": a2m["b1"],
                                     "phase 11": t2m["b1"], "phase 12": t2m_eval["b1"],
                                     "phase 14": phase14["b1"], "phase 15": phase15["b1"],
                                     "phase 16": phase16["b1"]},
             "fused_attention_btd_train": {"phase 4": train_launches, "phase 5": offline_train,
                                           "phase 8": guard["fused_attention_btd_train"],
                                           "phase 9": bf16_b2, "phase 10": a2m["b2"],
                                           "phase 11": t2m["b2"],
                                           "phase 12": t2m_eval["b2"],
                                           "phase 14": phase14["b2"],
                                           "phase 15": phase15["b2"],
                                           "phase 16": phase16["b2"]},
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
         max(worst, guard_worst["forward"], a2m_worst["forward"], t2m_worst["forward"],
             t2m_eval_worst["forward"], cvae_worst["forward"], gan_worst["forward"],
             p16_worst["forward"])),
        # the evaluation's f32 batch-64 shape: phase 6's launches
        ("fused_attention_btd (f32 [64, 150, 512], phase 6)", b1["phase 6"], eval_shape,
         max(worst, guard_worst["forward"])),
        # the a2m evaluations' shape, non-causal at 61 tokens: phase 10's launches
        ("fused_attention_btd (f32 [64, 61, 512], non-causal, phase 10)", b1["phase 10"],
         timings["a2m"][0], a2m_worst["forward"]),
        # the text CMDM's 197 tokens (the stored-row route): phases 11 and 12
        ("fused_attention_btd (f32 [64, 197, 512], non-causal, phases 11, 12)",
         b1["phase 11"] + b1["phase 12"], timings["t2m"][0],
         max(t2m_worst["forward"], t2m_eval_worst["forward"])))]
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
            err = max(err, *(w["train_forward" if which == "forward" else "backward"]
                             for w in (guard_worst, a2m_worst, t2m_worst, cvae_worst,
                                       gan_worst, p16_worst)))
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
    for (which, line, source), (key, tokens, label, phases, path_worst) in itertools.product(
            (("forward", 382, "attention_fwd.cu"), ("backward", 415, "attention_btd_train.cu")),
            (("a2m", A2M["T"] + 1, "phase 10", ("phase 10",), a2m_worst),
             ("t2m", T2M["T"] + 1, "phases 11, 12", ("phase 11", "phase 12"), t2m_worst))):
        # the model paths' own training shapes, non-causal: the a2m CMDM's 61
        # tokens (phase 10's launches) and the text CMDM's 197 (phases 11, 12)
        b2_timing = timings[key][1]
        kernel_rows.append({
            "name": f"fused_attention_btd_train ({which}, f32 [64, {tokens}, 512], non-causal, "
                    f"{label})",
            "route": "cuda",
            "source": f"regennet_torch/csrc/{source}",
            "replaces": f"regennet_tpu/ops/pallas_attention.py:{line}",
            "launches": sum(paths["fused_attention_btd_train"][p][which] for p in phases),
            "max_abs_err": path_worst["train_forward" if which == "forward" else "backward"],
            "ms": b2_timing[f"kernel_{which}_ms"],
            "plain_ms": b2_timing[f"plain_{which}_ms"],
            "bound_ms": b2_timing[f"{which}_bound_ms"],
            "bound_by": b2_timing[f"{which}_bound_by"],
            "library_ms": b2_timing[f"library_{which}_ms"],
        })
    for T, part in ((CVAE["T"] + 2, "encoder"), (CVAE["T"], "decoder")):
        # the CVAE's head dim 64: phase 14's launches at each shape
        b1_timing, b2_timing = cvae_timings[T]
        shape = f"f32 [{CVAE['batch']}, {T}, {CVAE['latent_dim']}], hd 64, non-causal"
        kernel_rows.append({
            "name": f"fused_attention_btd ({shape}, the CVAE {part}, phase 14)",
            "route": "cuda",
            "source": "regennet_torch/csrc/attention_fwd.cu",
            "replaces": "regennet_tpu/ops/pallas_attention.py:222",
            "launches": phase14["b1_by_T"].get(T, 0),
            "max_abs_err": cvae_worst["forward"],
            **{k: b1_timing[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms")},
        })
        for which, line, source in (("forward", 382, "attention_fwd.cu"),
                                    ("backward", 415, "attention_btd_train.cu")):
            kernel_rows.append({
                "name": f"fused_attention_btd_train ({which}, {shape}, the CVAE {part}, "
                        "phase 14)",
                "route": "cuda",
                "source": f"regennet_torch/csrc/{source}",
                "replaces": f"regennet_tpu/ops/pallas_attention.py:{line}",
                "launches": phase14["b2_by_T"][which].get(T, 0),
                "max_abs_err": cvae_worst["train_forward" if which == "forward"
                                          else "backward"],
                "ms": b2_timing[f"kernel_{which}_ms"],
                "plain_ms": b2_timing[f"plain_{which}_ms"],
                "bound_ms": b2_timing[f"{which}_bound_ms"],
                "bound_by": b2_timing[f"{which}_bound_by"],
                "library_ms": b2_timing[f"library_{which}_ms"],
            })
    for T, part in ((GAN["T"], "D, and evaluate_cvae's decode (B1)"),
                    (GAN["nnoise"], "G at its noise tokens")):
        # the GAN's head dim 64: phase 15's launches at each shape
        b1_timing, b2_timing = gan_timings[T]
        shape = f"f32 [{GAN['batch']}, {T}, {GAN['latent_dim']}], hd 64, non-causal"
        kernel_rows.append({
            "name": f"fused_attention_btd ({shape}, {part}, phase 15)",
            "route": "cuda",
            "source": "regennet_torch/csrc/attention_fwd.cu",
            "replaces": "regennet_tpu/ops/pallas_attention.py:222",
            "launches": phase15["b1_by_T"].get(T, 0),
            "max_abs_err": gan_worst["forward"],
            **{k: b1_timing[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms")},
        })
        for which, line, source in (("forward", 382, "attention_fwd.cu"),
                                    ("backward", 415, "attention_btd_train.cu")):
            kernel_rows.append({
                "name": f"fused_attention_btd_train ({which}, rate 0, {shape}, "
                        f"{part.split(',')[0]}, phase 15)",
                "route": "cuda",
                "source": f"regennet_torch/csrc/{source}",
                "replaces": f"regennet_tpu/ops/pallas_attention.py:{line}",
                "launches": phase15["b2_by_T"][which].get(T, 0),
                "max_abs_err": gan_worst["train_forward" if which == "forward"
                                         else "backward"],
                "ms": b2_timing[f"kernel_{which}_ms"],
                "plain_ms": b2_timing[f"plain_{which}_ms"],
                "bound_ms": b2_timing[f"{which}_bound_ms"],
                "bound_by": b2_timing[f"{which}_bound_by"],
                "library_ms": b2_timing[f"library_{which}_ms"],
            })
    report["second_order"] = dict(calls=phase15["b2_double"], worst=gan_worst["second_order"],
                                  timing={str(t): v for t, v in second_timings.items()})
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
