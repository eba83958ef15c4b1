"""Readings that set a cell's limits, in one process:

    python3 portbench/calibrate.py --workload <cell> --seeds 11 12 13 \
        [--seconds 25] [--control 3]

runs the cell once per seed (each a whole run: set-up, a window of
`--seconds`, the check; with `--fault`, a fault of portbench/faults.py
planted under the timed path) and then the control,
the reference computed in TF32 in the program's place, on the first
`--control` seeds. Each reading is a line `calibrate {json}` on standard
output. The limits in the cell's file sit above the program's largest
reading and below the control's smallest (PERF.md gives both)."""

import time

START = time.time()

import argparse  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import faults, harness  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, type=int, nargs="+")
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--control", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--fault", choices=faults.NAMES,
                        help="plant this fault under the timed path (portbench/faults.py)")
    args = parser.parse_args(argv)
    import torch

    cell, config = harness.load_cell(args.workload)
    undo = faults.plant(args.fault, cell["driver"] == "train") if args.fault else None
    for seed in args.seeds:
        out = io.StringIO()
        result = harness.run_cell(args.workload, seed, args.seconds, False, device=args.device,
                                  out=out)
        print("calibrate " + json.dumps({"seed": seed, "side": args.fault or "program",
                                         "checks": result["checks"],
                                         "metrics": result["metrics"]}), flush=True)
    if undo:
        undo()
    driver = harness.load_module(harness.ROOT / "drivers" / f"{cell['driver']}.py", "driver")
    for seed in args.seeds[:args.control]:
        with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
            ctx = harness.Context(args.workload, cell, config, seed, torch.device(args.device),
                                  str(harness.CHECKOUT / ".portbench_cache"), tmp, cell["traffic"])
            t = time.time()
            items = driver.control(ctx)
            print("calibrate " + json.dumps({"seed": seed, "side": "control", "items": items,
                                             "seconds": time.time() - t}), flush=True)


if __name__ == "__main__":
    main()
