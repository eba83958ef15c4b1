#!/usr/bin/env python3
"""Errors of the training attention's gradients at chip_smoke.py phase
2b's cases, as ratios to their tolerances, for A/B runs of two checkouts
on one card.

    python3 scripts/train_backward_errors.py [--root CHECKOUT] [--t200-inside]

Imports regennet_torch from CHECKOUT (default: this script's checkout) and
runs phase 2b's cases (this checkout's chip_smoke.train_cases and
_train_pair, the same generator and seed) through its kernels, then its
bf16 cases again with an f32 softmax (the third instantiation; generator
seed 6), then the text CMDM's [64, 197, 512], non-causal, rate 0.1, f32
and bf16 (generator seed 12; the row pass with P in shared memory). For
each case it gives max|error| / tolerance of dq, dk and dv:
against autograd of the plain forward (chip_smoke.TOLERANCE: 1e-5 f32,
2^-6 bf16, x max(1, max|autograd|)), against autograd at phase 2b's
tolerance (`_check`: chip_smoke.gradient_tolerance), against the plain
backward (TOLERANCE_VJP: 2^-7 bf16), and of the plain backward itself
against autograd (TOLERANCE), which no kernel that keeps the plain
backward's rounding points can beat by much. --t200-inside draws the T
200 cases right after the other B 8 cases, so the B 64 cases get other
inputs than phase 2b gives them. Writes every case to
chiprun_out/train_backward_errors_<checkout>[_t200_inside].json and prints
the worst ratio of each kind for each instantiation over phase 2b's cases,
with the case, and each ratio of the text cases, as one JSON line. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import runpy
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
GRADS = ("dq", "dk", "dv")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(HERE))
    parser.add_argument("--t200-inside", action="store_true")
    opts = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("train_backward_errors: CUDA is not available", file=sys.stderr)
        return 2
    # this checkout's phase 2b, then CHECKOUT's package
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs

    sys.path.insert(0, opts.root)
    # this checkout's f32 contract: CHECKOUT's package may predate the helper
    runpy.run_path(str(HERE / "regennet_torch" / "device.py"))["pin_f32_contract"]()
    order = cs.TRAIN_CASES
    if opts.t200_inside:
        order = ((8, (150, 60, 151, 200)), (cs.TRAIN["batch"], (150, 60, 151)))

    def ratio(a, b, tolerance, dtype):
        tol = tolerance[dtype] * max(1.0, float(b.float().abs().max()))
        return float((a.float() - b.float()).abs().max()) / tol

    rows = []
    cases = [(case, False, 1) for case in cs.train_cases(order)]
    cases += [(case, True, 6) for case in cs.train_cases(order) if case[4] == "bfloat16"]
    text = cs.TRAIN["batch"], cs.T2M["T"] + 1
    cases += [((*text, False, None, dtype, cs.TRAIN["rate"]), False, 12)
              for dtype in ("float32", "bfloat16")]
    gens = {seed: torch.Generator(device="cuda").manual_seed(seed) for seed in (1, 6, 12)}
    for (B, T, causal, kv_len, dtype, rate), softmax_f32, seed in cases:
        ours, plain, vjp = cs._train_pair(B, T, dtype, causal, kv_len, rate, gens[seed],
                                          softmax_f32)
        row = dict(B=B, T=T, causal=causal, dtype=dtype + "_sf32" * softmax_f32, rate=rate,
                   text=seed == 12)
        for i, g in enumerate(GRADS):
            row[g] = ratio(ours[i + 1], plain[i + 1], cs.TOLERANCE, dtype)
            row[g + "_check"] = cs.max_abs_err(ours[i + 1], plain[i + 1]) / \
                cs.gradient_tolerance(plain[i + 1], vjp[i], dtype)[0]
            row[g + "_vjp"] = ratio(ours[i + 1], vjp[i], cs.TOLERANCE_VJP, dtype)
            row[g + "_spec"] = ratio(vjp[i], plain[i + 1], cs.TOLERANCE, dtype)
        rows.append(row)
    out = HERE / "chiprun_out"
    out.mkdir(exist_ok=True)
    name = Path(opts.root).resolve().name + ("_t200_inside" if opts.t200_inside else "")
    (out / f"train_backward_errors_{name}.json").write_text(json.dumps(rows))
    worst = {}
    for dtype in ("bfloat16", "bfloat16_sf32", "float32"):
        for kind in ("", "_check", "_vjp", "_spec"):
            top = max((r for r in rows if r["dtype"] == dtype and not r["text"]),
                      key=lambda r: max(r[g + kind] for g in GRADS))
            worst[f"{dtype}{kind or '_autograd'}"] = {
                **{g: round(top[g + kind], 3) for g in GRADS},
                "at": {k: top[k] for k in ("B", "T", "causal", "rate")}}
    text_ratios = {r["dtype"]: {g + kind: round(r[g + kind], 3) for g in GRADS
                                for kind in ("", "_vjp")} for r in rows if r["text"]}
    print(json.dumps({"root": opts.root, "t200_inside": opts.t200_inside, "cases": len(rows),
                      "worst_ratio": worst, "text_ratio": text_ratios}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
