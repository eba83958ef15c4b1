#!/usr/bin/env python3
"""How far the training attention's bf16 gradients are from the test's
oracle, at the inputs tests/test_torch_cuda.py gives them.

    python3 scripts/bf16_gradient_oracle.py [--root CHECKOUT]

Imports regennet_torch from CHECKOUT (default: this script's checkout) and
runs tests/test_torch_cuda.py's `_train_case` (B 8, 4 heads of 128, bf16
with a bf16 softmax, causal, rate 0.5) at T 224, 225, 234, 235 and 256. For
dq, dk and dv it prints max|error| over the test's tolerance (2^-6 x
max(1, max|reference|)) of: the kernel against autograd of the plain
forward (the test's first check), the kernel against the plain backward
(its second), and the plain backward itself against autograd; and the
kernel against autograd over chip_smoke phase 2b's bound
(`gradient_tolerance`). One JSON line per T, with the card's name and
power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(HERE))
    opts = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bf16_gradient_oracle: CUDA is not available", file=sys.stderr)
        return 2
    # this checkout's chip_smoke and tests, then CHECKOUT's package
    sys.path[:0] = [str(HERE), str(HERE / "tests")]
    import chip_smoke

    sys.path.insert(0, opts.root)
    import test_torch_cuda

    card = chip_smoke.card_line()

    def ratio(a, b):
        tol = 2.0 ** -6 * max(1.0, float(b.float().abs().max()))
        return round(chip_smoke.max_abs_err(a, b) / tol, 4)

    for T in (224, 225, 234, 235, 256):
        (_, grads), (_, autograd), plain = test_torch_cuda._train_case(
            8, T, "bfloat16", True, None, 0.5)
        row = {"T": T, "card": card}
        for name, ours, auto, back in zip(("dq", "dk", "dv"), grads, autograd, plain):
            bound = chip_smoke.gradient_tolerance(auto, back, "bfloat16")[0]
            row[name] = dict(kernel_autograd=ratio(ours, auto), kernel_plain=ratio(ours, back),
                             plain_autograd=ratio(back, auto),
                             kernel_autograd_phase2b=round(
                                 chip_smoke.max_abs_err(ours, auto) / bound, 4))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
