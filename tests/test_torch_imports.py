"""regennet_torch stands alone: no module of it, and neither chip_smoke.py
nor scripts/capability_study_torch.py, imports JAX or the JAX package, and
every module imports without matplotlib and imageio (the GPU machine has
neither: rendering imports them where it draws), and without joblib (the
PyMAF-X reader imports it where it reads); and its entry points run on
the GPU unless the caller asks for the CPU."""

import os
import subprocess
import sys
from argparse import Namespace

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "orbax", "regennet_tpu", "matplotlib", "imageio",
             "joblib"):
    sys.modules[name] = None  # any import of these now raises ImportError
import regennet_torch
names = [m.name for m in pkgutil.walk_packages(regennet_torch.__path__, "regennet_torch.")]
for name in names:
    importlib.import_module(name)
new = {"regennet_torch.sample.edit", "regennet_torch.sample.predict",
       "regennet_torch.sample.generate_sequences", "regennet_torch.render.plot_script",
       "regennet_torch.render.renderer", "regennet_torch.render.rasterizer",
       "regennet_torch.models.actor_cvae", "regennet_torch.models.actor_losses",
       "regennet_torch.train.train_cvae", "regennet_torch.models.actor_gan",
       "regennet_torch.train.train_gan", "regennet_torch.eval.evaluate_cvae",
       "regennet_torch.eval.othermetrics", "regennet_torch.eval.tables",
       "regennet_torch.visualize.pose_prior", "regennet_torch.visualize.joints2smpl",
       "regennet_torch.visualize.fit_seq", "regennet_torch.visualize.vis_utils",
       "regennet_torch.visualize.render_mesh", "regennet_torch.render.rendermotion",
       "regennet_torch.render.crendermotion", "regennet_torch.preprocess.actor_reactor",
       "regennet_torch.preprocess.split_2p", "regennet_torch.preprocess.prepare_data"}
assert new <= set(names), new - set(names)
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
    assert int(proc.stdout.split()[-1]) >= 80  # every module was walked


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


def test_generate_entry_point_without_device_needs_cuda(monkeypatch, tmp_path):
    from regennet_torch.sample import generate
    from regennet_torch.utils import parser_util

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = parser_util.generate_args([
        "--model_path", str(tmp_path / "model000000001.pt"), "--data_path", str(tmp_path),
        "--text_prompt", "a person walks", "--output_dir", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate.main(args)
    assert not os.listdir(tmp_path)  # nothing ran on the CPU instead


def test_device_cpu_on_the_command_line_asks_for_the_cpu(monkeypatch):
    from regennet_torch.device import resolve_device
    from regennet_torch.utils import parser_util

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["--save_dir", "x"], ["--save_dir", "x", "--device", "cpu"]):
        index = parser_util.train_args(argv).device
        if index == "cpu":
            assert resolve_device(None, index) == torch.device("cpu")
        else:
            assert index == 0
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                resolve_device(None, index)


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


def test_text_evaluation_entry_points_without_device_need_cuda(monkeypatch, tmp_path):
    """eval_humanml and train_t2m_eval run on the GPU unless asked for the
    CPU: without CUDA they raise before writing anything."""
    from regennet_torch.eval import eval_humanml
    from regennet_torch.train import train_t2m_eval

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = Namespace(seed=0, device=0, model_path=str(tmp_path / "model000000001.pt"),
                     eval_mode="debug")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_humanml.main(args)
    args = train_t2m_eval.parse_args(["--data_path", str(tmp_path), "--save_dir",
                                      str(tmp_path / "run")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_t2m_eval.main(args)
    assert not os.listdir(tmp_path)  # nothing ran on the CPU instead


def test_comp_v6_entry_points_without_device_need_cuda(monkeypatch, tmp_path):
    """train_t2m_gen and the dataset-build CLI run on the GPU unless asked for
    the CPU: without CUDA they raise before writing anything."""
    from regennet_torch.data.humanml import motion_process
    from regennet_torch.train import train_t2m_gen

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = train_t2m_gen.parse_args(["--data_path", str(tmp_path), "--save_dir",
                                     str(tmp_path / "run")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_t2m_gen.main(args)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        motion_process._cli(["--joints_dir", str(tmp_path), "--out_dir", str(tmp_path / "out"),
                             "--example_id", "000000"])
    assert not os.listdir(tmp_path)  # nothing ran on the CPU instead


@pytest.mark.parametrize("module,argv", [
    ("regennet_torch.train.train_gan", ["--data_path", "", "--save_dir", "{tmp}/gan"]),
    ("regennet_torch.eval.evaluate_cvae", ["--model_path", "{tmp}/model000000001.pt",
                                           "--data_path", ""]),
    ("regennet_torch.eval.tables", ["{tmp}"]),
    ("regennet_torch.visualize.fit_seq", ["--data_folder", "{tmp}", "--save_folder",
                                          "{tmp}/fits"]),
    ("regennet_torch.visualize.render_mesh", ["--input_path", "{tmp}/sample00_rep00.mp4"]),
    ("regennet_torch.render.rendermotion", ["--data_path", "{tmp}/generation.npy"]),
    ("regennet_torch.render.crendermotion", ["--data_path", "{tmp}/results.npy"]),
])
def test_gan_and_tooling_entry_points_without_device_need_cuda(monkeypatch, tmp_path, module,
                                                               argv):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(module)
    args = mod.parse_args([a.format(tmp=tmp_path) for a in argv])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(args)
    assert not os.listdir(tmp_path)  # nothing ran on the CPU instead
