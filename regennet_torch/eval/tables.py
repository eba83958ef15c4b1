"""Sweep tables over saved evaluation YAMLs: `python -m
regennet_torch.eval.tables <folder> --group_by arch` (the port's copy of
regennet_tpu/eval/tables.py).

Scans a folder for `evaluation*.yaml` results (read with the port's
eval/tools.load_metrics), groups the runs by one argument recorded in each
run's args.json (arch, batch_size, lambda_kl, num_layers, pose_rep, ...),
and prints a plaintext or LaTeX table of mean ± 1.96·var across seeds per
metric, with the metric's direction arrow. Numeric axes sort by value.
The table is host work; `--device` follows the port's CLI contract (the
card unless `--device cpu`, raising without CUDA).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from regennet_torch.device import resolve_device
from regennet_torch.eval.tools import load_metrics
from regennet_torch.utils.parser_util import device_arg

UP = r"$\uparrow$"
DOWN = r"$\downarrow$"
RIGHT = r"$\rightarrow$"

# the direction in which each metric improves
ARROWS = {
    "accuracy": UP,
    "acceleration": RIGHT,
    "rc": DOWN,
    "fid": DOWN,
    "diversity": RIGHT,
    "multimodality": RIGHT,
}

DEFAULT_KEYS = ["fid", "accuracy", "diversity", "multimodality"]


def valformat(val: float, power: int = 3) -> str:
    """`val` rounded to `power` decimals, padded to four characters."""
    p = float(pow(10, power))
    return str(np.round(p * val).astype(int) / p).ljust(4, "0")


def format_values(values: Sequence[float], key: str) -> str:
    """``$mean^{\\pm interval}$`` across seeds (accuracy in percent)."""
    values = np.asarray([float(v) for v in values], dtype=np.float64)
    mean = values.mean()
    if key.startswith("accuracy"):
        mean = 100 * mean
        values = 100 * values
        smean = valformat(mean, 1)
    else:
        smean = valformat(mean, 2)
    interval = valformat(1.96 * values.var(), 2)
    return rf"${smean}^{{\pm{interval}}}$"


def _metric_base(key: str) -> str:
    return next((base for base in ARROWS if key.startswith(base)), key)


def collect_runs(folder: str, pattern: str = "evaluation*.yaml") -> List[Dict]:
    """The eval YAMLs under `folder`, each with its run's args.json."""
    runs = []
    for path in sorted(glob.glob(os.path.join(folder, "**", pattern), recursive=True)):
        run_dir = os.path.dirname(path)
        args_path = os.path.join(run_dir, "args.json")
        args = {}
        if os.path.exists(args_path):
            with open(args_path) as f:
                args = json.load(f)
        metrics = load_metrics(path)
        runs.append({"path": path, "dir": run_dir, "args": args,
                     "feats": metrics.get("feats", metrics)})
    return runs


def sweep_table(folder: str, group_by: str, keys: Optional[Sequence[str]] = None,
                split: str = "test", latex: bool = False) -> str:
    """Metric means across runs grouped by one swept argument. `keys` are
    metric prefixes; the `gen` series of `split` is used when present."""
    keys = list(keys or DEFAULT_KEYS)
    runs = collect_runs(folder)
    if not runs:
        return f"(no evaluation results under {folder})"

    rows = []
    for run in runs:
        label = str(run["args"].get(group_by, "?"))
        cells = []
        for key in keys:
            candidates = [f"{key}_gen_{split}", f"{key}_gen", f"{key}_{split}", key]
            found = next((c for c in candidates if c in run["feats"]), None)
            cells.append("--" if found is None else format_values(run["feats"][found], key))
        rows.append((label, cells))
    # numeric axes (batch_size 8/16/32, lambda values) sort by value
    try:
        rows.sort(key=lambda r: float(r[0]))
    except ValueError:
        rows.sort(key=lambda r: r[0])

    header = [group_by] + [f"{k} {ARROWS[_metric_base(k)]}" if latex else k for k in keys]
    if latex:
        lines = [" & ".join(header) + r" \\", r"\hline"]
        lines += [" & ".join([label] + cells) + r" \\" for label, cells in rows]
        return "\n".join(lines)
    widths = [max(len(str(header[i])),
                  max((len(r[1][i - 1]) if i else len(r[0])) for r in rows))
              for i in range(len(header))]
    out = ["  ".join(str(h).ljust(w) for h, w in zip(header, widths))]
    for label, cells in rows:
        out.append("  ".join(c.ljust(w) for c, w in zip([label] + cells, widths)))
    return "\n".join(out)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("folder", type=str)
    p.add_argument("--group_by", default="arch", type=str)
    p.add_argument("--keys", default=",".join(DEFAULT_KEYS), type=str)
    p.add_argument("--split", default="test", type=str)
    p.add_argument("--latex", action="store_true")
    p.add_argument("--device", default=0, type=device_arg,
                   help="CUDA device id, or 'cpu'.")
    return p.parse_args(argv)


def main(args=None):
    if args is None:
        args = parse_args()
    resolve_device(None, args.device)
    table = sweep_table(args.folder, args.group_by, args.keys.split(","), args.split,
                        args.latex)
    print(table)
    return table


if __name__ == "__main__":
    main()
