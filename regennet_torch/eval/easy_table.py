"""Results tabulation: mean +/- 1.96 var over seeds, plain text and LaTeX
(the port's copy of regennet_tpu/eval/easy_table.py):
`python -m regennet_torch.eval.easy_table <evaluation_results_....yaml>`."""

from __future__ import annotations

import os

import numpy as np

from regennet_torch.eval.tools import load_metrics


def valformat(val, power=3):
    p = float(pow(10, power))
    return str(np.round(p * val).astype(int) / p).ljust(4, "0")


def format_values(values, key, latex=True):
    mean = np.mean(values)
    interval = valformat(1.96 * np.var(values), 4)
    smean = valformat(mean, 3)
    if latex:
        return rf"${smean}^{{\pm{interval}}}$"
    return rf"{smean} +/- {interval}"


def print_results(folder, evaluation):
    evalpath = os.path.join(folder, evaluation)
    metrics = load_metrics(evalpath)
    a2m = metrics["feats"]

    if "fid_gen_test" in a2m:
        keys = [
            "fid_{}_train", "accuracy_{}_train", "multimodality_{}_train",
            "diversity_{}_train", "fid_{}_test", "accuracy_{}_test",
            "multimodality_{}_test", "diversity_{}_test",
        ]
    else:
        keys = ["fid_{}", "accuracy_{}", "diversity_{}", "multimodality_{}"]

    lines = ["gen", "recons"]
    if "fid_gt2" in a2m:
        a2m["fid_gt"] = a2m["fid_gt2"]
        lines = ["gt"] + lines

    rows, rows_latex = [], []
    for model in lines:
        row = ["{:6}".format(model)]
        row_latex = ["{:6}".format(model)]
        try:
            for key in keys:
                ckey = key.format(model)
                values = np.array([float(x) for x in a2m[ckey]])
                row.append(format_values(values, key, latex=False))
                row_latex.append(format_values(values, key, latex=True))
            rows.append(" | ".join(row))
            rows_latex.append(" & ".join(row_latex) + r"\\")
        except KeyError:
            continue

    print("Results")
    print("\n".join(rows))
    print()
    print("Latex table")
    print("\n".join(rows_latex))


def main():
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("evalpath", help="name of the evaluation")
    opt = parser.parse_args()
    folder, evaluation = os.path.split(opt.evalpath)
    print_results(folder, evaluation)


if __name__ == "__main__":
    main()
