#!/usr/bin/env python3
"""Time the port's attention kernels at the main path's shapes, for A/B
runs of two checkouts on one card.

    python3 scripts/time_attention.py [--root CHECKOUT] [--iters 50]

Imports regennet_torch from CHECKOUT (default: this script's checkout),
builds its kernels, and times each case with CUDA events over `--iters`
back-to-back calls after a warm-up (inputs L2-warm, as chip_smoke times
them): B1 `fused_attention_btd` causal at bf16 [128, 150, 512] (the
flagship request), f32 [64, 150, 512] (the evaluation's batch 32 under
CFG) and f32 [16, 150, 512] (the f32 request), 4 heads of 128, q, k, v
column views of one packed projection; B2 `fused_attention_btd_train`
at the training shape, f32 [64, 150, 512] causal with per-row seeds: its
forward at rate 0.1 and at rate 0, and its backward at rate 0.1; B2's
backward also at the text CMDM's f32 and bf16 [64, 197, 512], non-causal,
rate 0.1 (the row pass with P in shared memory); each backward's device
time is also split by pass (row pass, column pass) by kernel name under
torch.profiler; B3 `fused_causal_attention` causal at bf16 [128, 4, 150,
128]. Run it as parent, change, change, parent in one call to compare two
versions. Prints one JSON line with the card's name and power limit.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CASES = (  # (name, kernel, dtype, B, T, causal)
    ("B1 bf16 [128, 150, 512]", "btd", "bfloat16", 128, 150, True),
    ("B1 f32 [64, 150, 512]", "btd", "float32", 64, 150, True),
    ("B1 f32 [16, 150, 512]", "btd", "float32", 16, 150, True),
    ("B2 forward f32 [64, 150, 512] rate 0.1", "train 0.1", "float32", 64, 150, True),
    ("B2 forward f32 [64, 150, 512] rate 0", "train 0.0", "float32", 64, 150, True),
    ("B2 backward f32 [64, 150, 512] rate 0.1", "backward 0.1", "float32", 64, 150, True),
    ("B2 backward f32 [64, 197, 512] rate 0.1 non-causal", "backward 0.1", "float32", 64, 197,
     False),
    ("B2 backward bf16 [64, 197, 512] rate 0.1 non-causal", "backward 0.1", "bfloat16", 64, 197,
     False),
    ("B3 bf16 [128, 4, 150, 128]", "bhtd", "bfloat16", 128, 150, True),
)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    parser.add_argument("--iters", type=int, default=50)
    opts = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_attention: CUDA is not available", file=sys.stderr)
        return 2
    # this checkout's profiler helper, then CHECKOUT's package
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from chip_smoke import backward_pass_ms

    sys.path.insert(0, opts.root)
    from regennet_torch.ops import attention, kernels

    kernels.build_kernels()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    D, H = 512, 4
    gen = torch.Generator(device="cuda").manual_seed(0)
    times, passes = {}, {}
    for name, kind, dtype, B, T, causal in CASES:
        td = getattr(torch, dtype)
        if kind == "btd":
            q, k, v = torch.randn(B, T, 3 * D, device="cuda", generator=gen).to(td).split(D, -1)

            def call():
                return attention.fused_attention_btd(q, k, v, H, causal)
        elif kind.startswith(("train", "backward")):
            # as chip_smoke phase 2b times them: q, k, v [B, T, D] tensors
            rate = float(kind.split()[1])
            backward = kind.startswith("backward")
            q, k, v = (torch.randn(B, T, D, device="cuda", generator=gen).to(td)
                       .requires_grad_(backward) for _ in range(3))
            seeds = torch.randint(-2 ** 31, 2 ** 31, (B, 2), device="cuda", generator=gen,
                                  dtype=torch.int32)
            out = attention.fused_attention_btd_train(q, k, v, H, rate, seeds, causal)
            dout = torch.randn(B, T, D, device="cuda", generator=gen).to(td)

            def call():
                if backward:
                    return torch.autograd.grad(out, (q, k, v), dout, retain_graph=True)
                return attention.fused_attention_btd_train(q, k, v, H, rate, seeds, causal)
        else:
            q, k, v = (torch.randn(B, H, T, D // H, device="cuda", generator=gen).to(td)
                       for _ in range(3))

            def call():
                return attention.fused_causal_attention(q, k, v, causal)
        for _ in range(5):
            call()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(opts.iters):
            call()
        end.record()
        torch.cuda.synchronize()
        times[name] = start.elapsed_time(end) / opts.iters
        if kind.startswith("backward"):
            passes[name] = backward_pass_ms(call, opts.iters)
    print(json.dumps({"root": opts.root, "card": card, "ms": times,
                      "backward_passes_ms": passes}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
