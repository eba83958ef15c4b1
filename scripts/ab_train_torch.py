"""Time train_mdm's flagship training step in two checkouts of the repo on
one card: chip_smoke phase 4's configuration (online CMDM, 8 layers,
latent 512, batch 64, Chi3D T 150, 40 steps of K = 8) at f32 and at bf16,
each run in a fresh process, the checkouts alternating A, B, B, A, ...

    python scripts/ab_train_torch.py --a DIR --b DIR [--pairs 4]

A run imports chip_smoke.py and regennet_torch from its checkout. The
kernels are built once in A; B reuses that build where its sources hash
the same (regennet_torch/ops/kernels.py names a build by that hash).
Prints one JSON line a run ({"tree", "dtype", "card", "ms_per_step",
"wall_ms_per_step", "loss"}: ms per step over the device-synchronised
blocks after the first, as chip_smoke reports it; the last logged loss)
and, last, the medians per checkout and dtype.
"""

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

DTYPES = ("float32", "bfloat16")


def child(tree: str) -> None:
    """One run: both dtypes in this process, from `tree`'s code."""
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    for dtype in DTYPES:
        with tempfile.TemporaryDirectory() as tmp:
            args = cs.train_args(Path(tmp) / "train")
            args.compute_dtype = dtype
            report = {}
            cs.run_training(report, card, Path(tmp) / "train", args=args)
            row = report["training"]
            print("AB " + json.dumps({"tree": tree, "dtype": dtype, "card": card,
                                      "ms_per_step": row["ms_per_step"],
                                      "wall_ms_per_step": row["wall_ms_per_step"],
                                      "loss": row["last_logged"]["loss"]}),
                  flush=True)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--a", required=True)
    parser.add_argument("--b", required=True)
    parser.add_argument("--pairs", type=int, default=4)
    parser.add_argument("--child", default=None)
    args = parser.parse_args()
    if args.child:
        child(args.child)
        return 0
    a, b = str(Path(args.a).resolve()), str(Path(args.b).resolve())
    subprocess.run([sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
                    "from regennet_torch.ops import kernels; kernels.build_kernels()", a],
                   check=True)
    built = Path(b) / "regennet_torch" / "build"
    built.mkdir(parents=True, exist_ok=True)
    for so in (Path(a) / "regennet_torch" / "build").glob("*.so"):
        shutil.copy2(so, built / so.name)
    rows = []
    order = [t for i in range(args.pairs) for t in ((a, b) if i % 2 == 0 else (b, a))]
    for tree in order:
        out = subprocess.run([sys.executable, __file__, "--a", a, "--b", b, "--child", tree],
                             stdout=subprocess.PIPE, text=True, check=True).stdout
        for line in out.splitlines():
            if line.startswith("AB "):
                print(line[3:], flush=True)
                rows.append(json.loads(line[3:]))
    medians = {f"{name} {dtype}": statistics.median(
        r["ms_per_step"] for r in rows if r["tree"] == tree and r["dtype"] == dtype)
        for name, tree in (("a", a), ("b", b)) for dtype in DTYPES}
    print(json.dumps({"medians_ms_per_step": medians}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
