"""The benchmark's harness: it finds a cell, its configuration, its driver
and its per-layer metric readers by name, runs the cell once and prints
the result line.

Layout (every piece found by the name `BENCHMARK.json` gives it, so that
a cell, a configuration or a metric is added by adding files):

    configs/<config>.json     a configuration: its source, every width,
                              what was cut and assumed, the dtype, and the
                              program's own arguments (`argv`)
    workloads/<cell>.json     a cell: its configuration, driver, traffic,
                              chips, why, and the limit of each number
                              that decides `correct`
    drivers/<driver>.py       a traffic driver: setup, window, check
    metrics/<metric>.py       a per-layer metric: read(trace) -> value

A driver module has `setup(ctx) -> state` (builds the program, warms up
every shape the cell uses, and for training drives the first steps that
the reference follows), `window(state, seconds, steps, traced) -> info`
(the measured work: end-to-end metrics in `info["metrics"]`, counts for
the readers beside them) and `check(state) -> [{number: value}]` (frees
the program's state, runs the reference and returns the numbers of each
answer compared; `correct` holds when every number is within its limit).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "regennet_tpu")


class Refused(SystemExit):
    """Exit with a message and no result line."""

    def __init__(self, message: str):
        print(f"portbench: {message}", file=sys.stderr, flush=True)
        super().__init__(2)


@dataclasses.dataclass
class Context:
    name: str
    cell: dict
    config: dict
    seed: int
    device: object
    cache_dir: str
    tmp: str
    traffic: dict

    @property
    def program_seed(self) -> int:
        """The seed the program's own generators take (numpy's global
        seed takes 32 bits)."""
        return self.seed % 2 ** 32


class Laps:
    """Set-up stages and their seconds, printed to standard error."""

    def __init__(self):
        self.t = time.time()

    def __call__(self, what: str):
        now = time.time()
        print(f"portbench: set-up, {what}: {now - self.t:.3f} s", file=sys.stderr, flush=True)
        self.t = now


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    if not path.is_file():
        raise Refused(f"{path} does not exist")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(name: str, root: Path = ROOT):
    path = root / "workloads" / f"{name}.json"
    if not path.is_file():
        raise Refused(f"no cell {name!r} ({path})")
    cell = load_json(path)
    config = load_json(root / "configs" / f"{cell['config']}.json")
    return cell, config


def cell_metrics(bench: dict, name: str):
    """(end-to-end entries, per-layer entries) that the cell reports."""
    def listed(entry):
        return "workloads" not in entry or name in entry["workloads"]

    e2e = [m for m in bench["end_to_end"] if listed(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if m["moves"] in names and listed(m)]
    return e2e, per_layer


def forbidden_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_info(chips: int, device) -> dict:
    import torch

    if getattr(device, "type", str(device)) == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}


def breakdown(trace) -> dict:
    """The device groups that took most time (the timed window), and the
    longest idle time by the benchmark span that was open on the main
    thread (the spanned window)."""
    from portbench.counts.kernel_groups import kernel_group

    groups: Dict[str, float] = {}
    for name, _, dur, _ in trace.device_ops:
        g = kernel_group(name)
        groups[g] = groups.get(g, 0.0) + dur / 1e6
    busy = trace.busy_intervals()
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    if busy:
        gaps = [(trace.start_us, busy[0][0])] + gaps + [
            (busy[-1][1], trace.start_us + trace.span_window_s * 1e6)]
    main = [s for s in trace.spans if s[0] == "window"]
    tid = main[0][3] if main else None
    labelled: Dict[str, float] = {}
    for s, e in gaps:
        if e <= s:
            continue
        open_ = [(st, name) for name, st, dur, t in trace.spans
                 if t == tid and name != "window" and st <= s <= st + dur]
        label = max(open_)[1] if open_ else "outside the benchmark's spans"
        labelled[label] = labelled.get(label, 0.0) + (e - s) / 1e6
    top = sorted(groups.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(labelled.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in idle]}


def build_kernels() -> float:
    """Build the program's CUDA kernels, or find them built in the
    checkout; returns the seconds it took, which `setup_s` leaves out (the
    first run in a checkout compiles with nvcc, the others find them)."""
    from regennet_torch.ops import kernels

    t = time.time()
    kernels.build_kernels()
    seconds = time.time() - t
    print(f"portbench: the program's kernels built or found: {seconds:.3f} s, apart from setup_s",
          file=sys.stderr, flush=True)
    return seconds


def run_cell(name: str, seed: int, seconds: float, trace: bool, root: Path = ROOT,
             bench: Optional[dict] = None, device: str = "cuda", start: Optional[float] = None,
             out=sys.stdout) -> dict:
    """Run cell `name` once and print its result line; returns the result."""
    start = time.time() if start is None else start
    bench = bench if bench is not None else load_json(CHECKOUT / "BENCHMARK.json")
    cell, config = load_cell(name, root)
    chips = int(cell["chips"])
    import torch

    if device == "cuda":
        if not torch.cuda.is_available():
            raise Refused("CUDA is not available")
        if torch.cuda.device_count() < chips:
            raise Refused(f"the cell needs {chips} cards, {torch.cuda.device_count()} found")
    e2e, per_layer = cell_metrics(bench, name)
    driver = load_module(root / "drivers" / f"{cell['driver']}.py",
                         f"portbench_driver_{cell['driver']}")
    cache = Path(root).resolve().parent / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        ctx = Context(name, cell, config, int(seed), torch.device(device), str(cache), tmp,
                      cell["traffic"])
        print("portbench: set-up, the interpreter, torch and CUDA checks: "
              f"{time.time() - start:.3f} s", file=sys.stderr, flush=True)
        build_s = build_kernels() if device == "cuda" else 0.0
        state = driver.setup(ctx)
        sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
        sync()
        setup_s = time.time() - start - build_s
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
        if trace:
            from portbench import trace as tracing

            tr = tracing.traced_window(
                lambda: driver.window(state, None, cell["trace_steps"], False),
                lambda: driver.window(state, None, cell["trace_steps"], True), sync)
            for m in per_layer:
                reader = load_module(root / "metrics" / f"{m['name']}.py",
                                     "portbench_metric_" + m["name"].replace(".", "_"))
                value = reader.read(tr)
                if value is not None:
                    result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            info = driver.window(state, seconds, None, False)
            values = dict(info["metrics"], setup_s=setup_s)
            for m in e2e:
                if m["name"] in values:
                    result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        dev = device_info(chips, ctx.device)
        if trace:
            dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        checked = time.time()
        items = driver.check(state)
        print(f"portbench: setup {setup_s:.3f} s, window and reading "
              f"{checked - start - build_s - setup_s:.3f} s, check {time.time() - checked:.3f} s",
              file=sys.stderr)
        del state
        gc.collect()
    from portbench import judge

    limits = cell["limits"]
    numbers: Dict[str, float] = {}
    for item in items:
        for k, v in item.items():
            numbers[k] = max(numbers.get(k, v), v) if math.isfinite(v) else math.inf
    rows = judge.verdict(numbers, limits)
    failed = sum(1 for item in items if not all(ok for *_, ok in judge.verdict(item, limits)))
    result.update(correct=bool(rows) and all(ok for *_, ok in rows), attempted=len(items),
                  failed=failed, device=dev)
    if trace:
        result["breakdown"] = breakdown(tr)
    result["checks"] = {n: {"value": v if math.isfinite(v) else None, "limit": lim}
                        for n, v, lim, _ in rows}
    found = forbidden_modules()
    if found:
        raise Refused("the run loaded " + ", ".join(found))
    for n, v, lim, ok in rows:
        print(f"check {n} {v!r} limit {lim!r} {'ok' if ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), file=out, flush=True)
    return result
