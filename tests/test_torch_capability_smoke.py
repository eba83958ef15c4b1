"""The port's learning guard (slow tier): scripts/capability_study_torch.py
at its smokefit scale on the CPU (about 90 s on 8 cores), held to the
asserts of tests/test_capability_smoke.py. A break anywhere in the port's
train -> sample -> evaluate composite (the ST-GCN trainer, BatchNorm, the
CMDM's training, the sampler, the evaluator's loading) turns it red."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_capability_smokefit_discriminates_on_the_port(tmp_path):
    out = tmp_path / "capability_smokefit_torch.json"
    proc = subprocess.run(
        [sys.executable, "-u", os.path.join(REPO, "scripts", "capability_study_torch.py"),
         "--scale", "smokefit", "--device", "cpu", "--out", str(out),
         "--workdir", str(tmp_path / "work")],
        capture_output=True, text=True, timeout=1800, cwd=REPO,
    )
    assert proc.returncode == 0, (
        f"capability smokefit failed rc={proc.returncode}\n"
        f"stdout tail: {proc.stdout[-2000:]}\nstderr tail: {proc.stderr[-2000:]}")
    with open(out) as f:
        art = json.load(f)

    assert art["ok"], art["checks"]
    acc_tr = art["trained"]["accuracy_gen_test"]["mean"]
    acc_rd = art["random_init"]["accuracy_gen_test"]["mean"]
    fid_tr = art["trained"]["fid_gen_test"]["mean"]
    fid_rd = art["random_init"]["fid_gen_test"]["mean"]
    acc_or = art["oracle"]["accuracy_gen_test"]["mean"]
    fid_or = art["oracle"]["fid_gen_test"]["mean"]
    chance = 1.0 / 8.0
    assert art["evaluator"]["gt_test_accuracy"] >= 0.6
    assert acc_tr > chance + 0.10, (acc_tr, chance)
    assert acc_tr > acc_rd, (acc_tr, acc_rd)
    assert fid_tr < 0.25 * fid_rd, (fid_tr, fid_rd)
    assert acc_or >= 0.5
    assert fid_or < 0.1 * max(fid_tr, 1e-9)
    assert acc_tr <= acc_or + 0.05
