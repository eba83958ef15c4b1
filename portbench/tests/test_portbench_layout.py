"""BENCHMARK.json against the benchmark's contract, the harness finding
every piece by name, and no JAX in any module the benchmark loads."""

import json
import re
import subprocess
import sys

import pytest

from _portbench_helpers import REPO, harness

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection", "head", "expansion",
               "experts_per_token", "ff_size")


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[key]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    for cell in BENCH["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
        e2e, per_layer = harness.cell_metrics(BENCH, cell["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and per_layer, cell["name"]


def test_configurations_hold_their_widths_and_cut_no_width():
    for entry in BENCH["configs"]:
        assert entry["file"].startswith("portbench/configs/")
        config = json.loads((REPO / entry["file"]).read_text())
        assert config["source"] == entry["source"]
        for key in entry["reduced"]:
            assert not any(w in key for w in WIDTH_WORDS) and not key.endswith(("_dim", "_rank"))
        assert config["latent_dim"] == 512 and config["layers"] == 8 and config["num_heads"] == 4
        assert config["ff_size"] == 1024 and config["compute_dtype"] == "float32"


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_the_harness_finds_each_piece_by_name(cell):
    spec, config = harness.load_cell(cell)
    entry = next(c for c in BENCH["workloads"] if c["name"] == cell)
    assert spec["config"] == entry["config"] == config["name"]
    assert spec["chips"] == entry["chips"] and spec["why"] == entry["why"]
    driver = harness.load_module(harness.ROOT / "drivers" / f"{spec['driver']}.py", "d")
    for fn in ("setup", "window", "check"):
        assert callable(getattr(driver, fn))
    for metric in harness.cell_metrics(BENCH, cell)[1]:
        reader = harness.load_module(harness.ROOT / "metrics" / f"{metric['name']}.py", "m")
        assert callable(reader.read)
    assert set(spec["limits"]) and all(v >= 0 for v in spec["limits"].values())


def test_the_program_arguments_state_the_configuration():
    """Each configuration's widths are what its program arguments build."""
    from regennet_torch.utils import parser_util
    from regennet_torch.utils.model_util import get_model_args

    class Data:
        num_actions = 8

    for entry in BENCH["configs"]:
        config = json.loads((REPO / entry["file"]).read_text())
        args = parser_util.train_args(config["argv"] + ["--save_dir", "unused"])
        built = get_model_args(args, Data())
        for key in ("latent_dim", "ff_size", "num_frames", "njoints", "nfeats", "dropout",
                    "cond_mask_prob", "arch", "cm_mode", "cond_mode"):
            assert built[key] == config[key], (entry["name"], key)
        assert built["num_layers"] == config["layers"] and built["num_heads"] == config["num_heads"]
        assert args.batch_size == config["batch_size"] and args.lr == config["lr"]
        assert args.diffusion_steps == config["diffusion_steps"]
        assert args.steps_per_call == config["steps_per_call"]
        assert args.compute_dtype == config["compute_dtype"]


def test_no_module_the_benchmark_loads_is_jax():
    """Every portbench module, drivers and readers included, imported in a
    fresh process: no top-level jax, jaxlib, flax or regennet_tpu; the
    reference and the yardstick import nothing of the program."""
    code = f"""
import sys, importlib
sys.path.insert(0, {str(REPO)!r})
from pathlib import Path
from portbench import harness
for mod in ("portbench.data", "portbench.judge", "portbench.trace", "portbench.counts.flops",
            "portbench.counts.attention", "portbench.counts.kernel_groups",
            "portbench.reference.model", "portbench.reference.train",
            "portbench.reference.sample", "portbench.reference.clip_bpe"):
    importlib.import_module(mod)
top = {{m.split(".", 1)[0] for m in sys.modules}}
assert "regennet_torch" not in top, "the yardstick imports the program"
for path in sorted((harness.ROOT / "metrics").glob("*.py")):
    harness.load_module(path, "m_" + path.stem.replace(".", "_"))
top = {{m.split(".", 1)[0] for m in sys.modules}}
assert "regennet_torch" not in top, "a reader imports the program"
for path in sorted((harness.ROOT / "drivers").glob("*.py")):
    harness.load_module(path, "d_" + path.stem)
import regennet_torch.train.training_loop, regennet_torch.diffusion.sampling
print(sorted({{m.split(".", 1)[0] for m in sys.modules}} & set(harness.FORBIDDEN)))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
