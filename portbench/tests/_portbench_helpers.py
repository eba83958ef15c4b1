"""Shared pieces of the benchmark's CPU tests: a copy of portbench/ in a
temporary directory with tiny configurations and cells added as new
files, and a run of one of its cells on the CPU."""

from __future__ import annotations

import io
import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench import harness  # noqa: E402

TINY = dict(layers=2, latent_dim=32, head_dim=8, diffusion_steps=20, batch_size=4,
            steps_per_call=2)
TINY_FLAGS = {"--layers": "2", "--latent_dim": "32", "--diffusion_steps": "20",
              "--batch_size": "4", "--steps_per_call": "2"}
# tiny cell -> (cell it is cut from, configuration it is cut from)
TINY_CELLS = {"tiny.eval_sample": ("chi3d_online.eval_sample", "chi3d_online"),
              "tiny.train": ("chi3d_online.train", "chi3d_online"),
              "tiny_text.train": ("humanml_text.train", "humanml_text")}
# tiny cell -> the listed cell whose metrics it reports (chi3d_online.train
# has its file but no entry in BENCHMARK.json; it runs the same driver)
REPORTS_LIKE = {"tiny.eval_sample": "chi3d_online.eval_sample",
                "tiny.train": "humanml_text.train",
                "tiny_text.train": "humanml_text.train"}


def tiny_root(tmp: Path) -> Path:
    """portbench/ copied under `tmp`, plus tiny configurations (2 layers,
    latent 32, DDPM-20, batch 4, 12 Chi3D frames) and cells that
    use the benchmark's own drivers: new files only."""
    root = tmp / "portbench"
    shutil.copytree(harness.ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests", ".portbench_cache"))
    for name in ("chi3d_online", "humanml_text"):
        config = json.loads((root / "configs" / f"{name}.json").read_text())
        config.update(TINY, name=f"tiny_{name}")
        flags = dict(TINY_FLAGS)
        if name != "humanml_text":
            config["num_frames"] = 12
            flags["--num_frames"] = "12"
        argv = config["argv"]
        for flag, value in flags.items():
            argv[argv.index(flag) + 1] = value
        (root / "configs" / f"tiny_{name}.json").write_text(json.dumps(config))
    for tiny, (cell, config) in TINY_CELLS.items():
        spec = json.loads((root / "workloads" / f"{cell}.json").read_text())
        spec.update(config=f"tiny_{config}", trace_steps=4)
        if "rows" in spec["traffic"]:
            spec["traffic"]["rows"] = 2
        (root / "workloads" / f"{tiny}.json").write_text(json.dumps(spec))
    return root


def bench_with(cells) -> dict:
    """BENCHMARK.json with `cells` reporting what the listed cells of
    their drivers report."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for entry in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in entry:
            entry["workloads"] += [c for c in cells if REPORTS_LIKE[c] in entry["workloads"]]
    return bench


def run(root: Path, cell: str, trace: bool = False, seconds: float = 1.0,
        seed: int = 2 ** 31 + 77, capsys=None) -> dict:
    """Run `cell` of `root` on the CPU; returns the parsed last line."""
    out = io.StringIO()
    harness.run_cell(cell, seed, seconds, trace, root=root, bench=bench_with([cell]),
                     device="cpu", out=out)
    lines = out.getvalue().strip().splitlines()
    return json.loads(lines[-1])
