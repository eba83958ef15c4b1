#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (regennet_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):
  1. the card's name and power limit; build every CUDA kernel with nvcc;
  2. every kernel against its plain PyTorch version on the card, at the
     sampler's shapes, with the kernel's, the plain version's and one
     PyTorch library call's times beside the kernel's bound;
  3. the main path, `regennet_torch.sample.cgenerate.main`, on the flagship
     online CMDM (8 layers, latent 512, 4 heads, ff 1024, Chi3D SMPL-X
     56x6, T=150, random weights from a seed) for three requests built from
     in-memory synthetic clips: f32 batch 16, the same with CFG 2.5, and
     bf16 batch 128, each 1000 DDPM steps, then smoothing and the joint
     decode; the kernels' launch counts over the three requests; one
     denoiser forward through the kernels against the same forward through
     the plain versions.
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.
Exits non-zero without CUDA, or without the regennet_torch package beside it.
"""

from __future__ import annotations

import json
import math
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
FLAGSHIP = dict(layers=8, latent_dim=512, heads=4, T=150, steps=1000)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms over `iters` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(B, T, D, H, dtype, causal, kv_len):
    """Least time for the attention: q, k, v read once and out written once
    over the memory rate, or the QK and AV products this mask needs over
    the peak rate of the dtype; the larger, and which it is."""
    itemsize = 2 if dtype == "bfloat16" else 4
    bytes_moved = 4 * B * T * D * itemsize
    pairs = T * (T + 1) // 2 if causal else T * (kv_len or T)
    flops = 2 * 2 * B * pairs * D  # QK^T and AV over all heads
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_attention_kernel(report):
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
    # bf16 batch 128 (and 256 under CFG), T = 150 (Chi3D), 60 (NTU), 151
    timed = {("float32", 16), ("float32", 32), ("bfloat16", 128), ("bfloat16", 256)}
    cases, worst = [], 0.0
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B in (16, 32, 128, 256):
        for T in (150, 60, 151):
            for dtype, causal, softmax_f32, kv_off in modes:
                if B in (16, 32) and (dtype != "float32" or T != 150):
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
                          f"max_abs_err {err:.3g}")
                cases.append(case)
    print(f"  attention kernel matches its plain version in {len(cases)} cases "
          f"(worst max_abs_err {worst:.3g}; tolerance 1e-5 f32, 2^-6 bf16, "
          "x max(1, max|plain|))")
    report["attention_cases"] = cases
    flagship = next(c for c in cases if "ms" in c and c["dtype"] == "bfloat16"
                    and c["B"] == 128)
    return worst, flagship


def request_args(out_dir, num_samples, guidance, compute_dtype, seed):
    return Namespace(
        seed=seed, device=0, batch_size=num_samples, use_ddim=False,
        timestep_respacing="", noise_schedule="cosine",
        diffusion_steps=FLAGSHIP["steps"], sigma_small=True, setting="cmdm",
        arch="online", emb_trans_dec=False, wo_pos_emb=False, cm_mode="concat",
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


def check_forward(report, data):
    """One denoiser forward through the kernel against the same forward
    through the plain attention, on the same weights on the card."""
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
        args = request_args("", n, 1.0, dtype, seed=7)
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
        print(f"  denoiser forward {dtype} batch {n}: kernel vs plain attention "
              f"max_abs_err {err:.3g} (tolerance {bound:.3g}), mean "
              f"{row['mean_abs_err']:.3g}")
        if not (err <= bound and np.isfinite(err)):
            raise AssertionError(f"denoiser forward disagrees: {row}")
        out.append(row)
    report["forward_checks"] = out


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
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}")
    report["build_s"] = {k: v["seconds"] for k, v in built.items()}

    print("phase 2: kernels against their plain versions")
    worst, flagship = check_attention_kernel(report)
    print("phase 3: cgenerate at the flagship width")
    data, launches = run_requests(report, card)
    check_forward(report, data)

    kernel_rows = [{
        "name": "fused_attention_btd",
        "route": "cuda",
        "source": "regennet_torch/csrc/attention_btd.cu",
        "replaces": "regennet_tpu/ops/pallas_attention.py:222",
        "launches": launches,
        "max_abs_err": worst,
        "ms": flagship["ms"],
        "plain_ms": flagship["plain_ms"],
        "bound_ms": flagship["bound_ms"],
        "bound_by": flagship["bound_by"],
        "library_ms": flagship["library_ms"],
    }]
    report["kernels"] = kernel_rows
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
