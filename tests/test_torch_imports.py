"""regennet_torch stands alone: no module of it, and neither chip_smoke.py
nor scripts/capability_study_torch.py, imports JAX or the JAX package; and its entry points run on the GPU
unless the caller asks for the CPU."""

import os
import subprocess
import sys
from argparse import Namespace

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "orbax", "regennet_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import regennet_torch
names = [m.name for m in pkgutil.walk_packages(regennet_torch.__path__, "regennet_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
chip_smoke.load_capability_study()
banned = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "flax", "orbax", "regennet_tpu")
          and sys.modules[m] is not None]
assert not banned, banned
print(len(names))
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) >= 53  # every module was walked


def test_entry_point_without_device_needs_cuda(monkeypatch, tmp_path):
    from regennet_torch.device import resolve_device
    from regennet_torch.sample import cgenerate

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    args = Namespace(seed=0, device=0, dataset="chi3d", model_path="random",
                     output_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cgenerate.main(args)
    assert not os.listdir(tmp_path)  # nothing ran on the CPU instead


def test_train_entry_point_without_device_needs_cuda(monkeypatch, tmp_path):
    from regennet_torch.train import train_mdm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    save_dir = tmp_path / "run"
    args = Namespace(seed=0, device=0, save_dir=str(save_dir), overwrite=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_mdm.main(args)
    assert not save_dir.exists() and not os.listdir(tmp_path)  # nothing written


def test_eval_entry_point_without_device_needs_cuda(monkeypatch, tmp_path):
    from regennet_torch.eval import eval_cmdm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = Namespace(seed=0, device=0, model_path=str(tmp_path / "model000000001.pt"),
                     eval_mode="debug")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_cmdm.main(args)
    assert not os.listdir(tmp_path)  # no results file


@pytest.mark.parametrize("entry", ["eval_humanact12_uestc", "compute_accuracy"])
def test_a2m_eval_entry_points_without_device_need_cuda(monkeypatch, tmp_path, entry):
    import importlib

    module = importlib.import_module(f"regennet_torch.eval.{entry}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = Namespace(seed=0, device=0, model_path=str(tmp_path / "model000000001.pt"),
                     checkpoint=str(tmp_path / "model000000001.pt"), eval_mode="debug")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(args)
    assert not os.listdir(tmp_path)  # no results file


def test_learning_guard_entry_points_without_device_need_cuda(monkeypatch, tmp_path):
    from regennet_torch.eval import train_stgcn

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import capability_study_torch as study
    finally:
        sys.path.pop(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = Namespace(seed=0, save_dir=str(tmp_path / "stgcn"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_stgcn.run_training(args)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        study.run_study(workdir=str(tmp_path / "guard"))
    assert not os.listdir(tmp_path)  # nothing ran on the CPU instead
