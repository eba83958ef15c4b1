"""Each driver at a tiny size on the CPU, through the port's plain
attention, from cells and configurations added as new files to a copy of
portbench/; and the faults that `correct` must catch, planted under the
timed path of a whole run."""

import json

import pytest
import torch

from _portbench_helpers import REPO, TINY_CELLS, run, tiny_root
from portbench import faults

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


def well_formed(result, trace):
    assert list(result)[:5] == KEYS and list(result)[-1] == "checks"
    assert result["device"]["platform"] == "cpu" and result["attempted"] >= 1
    for check in result["checks"].values():
        assert set(check) == {"value", "limit"}
    if trace:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(result["device"])
    else:
        assert "setup_s" in result["metrics"]


@pytest.mark.parametrize("cell, rate", [("tiny.eval_sample", "sample_seqs_per_s"),
                                        ("tiny.train", "train_samples_per_s")])
def test_driver_runs_a_new_cell_and_is_correct(root, cell, rate):
    result = run(root, cell)
    well_formed(result, trace=False)
    assert result["correct"] and result["failed"] == 0, result["checks"]
    assert result["metrics"][rate]["value"] > 0


@pytest.mark.parametrize("cell", ["tiny.eval_sample", "tiny.train"])
def test_traced_run_is_well_formed(root, cell):
    result = run(root, cell, trace=True)
    well_formed(result, trace=True)
    assert result["correct"]


def test_text_training_driver(root):
    """The text cell: the CLIP tower written once into the checkout's cache
    and run per batch by the program; the reference's own tower and
    tokenizer give the same embedding."""
    result = run(root, "tiny_text.train")
    well_formed(result, trace=False)
    assert result["correct"], result["checks"]
    assert (root.parent / ".portbench_cache" / "clip" / "ViT-B-32.pt").is_file()


def test_the_repository_cells_are_untouched(root):
    """The tiny cells live in the copy alone."""
    assert not (REPO / "portbench" / "workloads" / "tiny.train.json").exists()
    assert (root / "workloads" / "tiny.train.json").exists()


# -- faults planted under the timed path: `correct` must come out false --

@pytest.mark.parametrize("cell", ["tiny.train", "tiny.eval_sample"])
@pytest.mark.parametrize("fault", faults.NAMES)
def test_a_planted_fault_is_not_correct(root, cell, fault):
    undo = faults.plant(fault, training=cell.endswith("train"))
    try:
        result = run(root, cell)
    finally:
        undo()
    assert not result["correct"], result["checks"]
    assert result["failed"] >= 1


def test_a_fault_in_the_window_alone_is_not_correct(root):
    """The set-up's three steps sound and every timed block's denoiser
    output 1% off: the window's first block, compared with the reference,
    fails."""
    from regennet_torch.models import cmdm
    from regennet_torch.train.training_loop import TrainLoop

    run_block, forward = TrainLoop.run_block, cmdm.CMDM.forward
    blocks = []

    def counted(self, items):
        blocks.append(len(items))
        if len(blocks) > 2:  # set-up runs one step, then two
            cmdm.CMDM.forward = lambda *a, **kw: forward(*a, **kw) * 1.01
        return run_block(self, items)

    TrainLoop.run_block = counted
    try:
        result = run(root, "tiny.train")
    finally:
        TrainLoop.run_block, cmdm.CMDM.forward = run_block, forward
    checks = result["checks"]
    assert not result["correct"], checks
    assert all(checks[k]["value"] <= checks[k]["limit"]
               for k in ("loss_gap", "grad_error_ratio", "update_gap", "ema_gap")), checks
    assert checks["window_loss_gap"]["value"] > checks["window_loss_gap"]["limit"], checks


def test_limits_are_the_cells_own():
    for path in sorted((REPO / "portbench" / "workloads").glob("*.json")):
        spec = json.loads(path.read_text())
        assert spec["limits"], path.name


@pytest.mark.parametrize("tiny", ["tiny.eval_sample", "tiny.train"])
def test_the_control_is_not_correct(root, tiny, tmp_path):
    """The control, the reference computed in TF32 in the program's place
    (the step below the float32 that the configurations state), fails one
    of the numbers of the cell it is cut from, under that cell's limits."""
    from portbench import harness

    cell, config = harness.load_cell(tiny, root)
    driver = harness.load_module(root / "drivers" / f"{cell['driver']}.py", "control_driver")
    limits = json.loads((REPO / "portbench/workloads" / f"{TINY_CELLS[tiny][0]}.json")
                        .read_text())["limits"]
    ctx = harness.Context(tiny, cell, config, 2 ** 31 + 5, torch.device("cpu"),
                          str(root.parent / ".portbench_cache"), str(tmp_path), cell["traffic"])
    items = driver.control(ctx)
    worst = {k: max(item[k] for item in items) for k in items[0]}
    assert any(value > limits[k] for k, value in worst.items()), (worst, limits)
