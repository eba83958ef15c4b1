"""The port's f32 contract: no TF32 in cuBLAS matmuls or cuDNN convolutions.

PyTorch leaves `torch.backends.cudnn.allow_tf32` True. One helper,
`regennet_torch.device.pin_f32_contract`, sets both flags False, and every
entry point calls it, the ST-GCN trainer included. The flags are global
settings that the CPU build also keeps, so these tests read them here.
"""

import importlib.util
import re
from argparse import Namespace
from pathlib import Path

import pytest
import torch

from regennet_torch.data import synthetic
from regennet_torch.data.feeder import Feeder
from regennet_torch.device import pin_f32_contract, tf32_allowed
from regennet_torch.eval import train_stgcn

REPO = Path(__file__).resolve().parent.parent


def _flags():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


@pytest.fixture
def tf32_on():
    """Both flags True for the test, as a fresh process leaves the cuDNN
    one; restored after it."""
    saved = _flags()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_pin_f32_contract_sets_both_flags_false(tf32_on):
    assert _flags() == (True, True)
    pin_f32_contract()
    assert _flags() == (False, False)


def test_tf32_allowed_lifts_the_contract_inside_its_block_only():
    pin_f32_contract()
    with tf32_allowed():
        assert _flags() == (True, True)
    assert _flags() == (False, False)
    with pytest.raises(ValueError), tf32_allowed():
        raise ValueError
    assert _flags() == (False, False)


def test_train_stgcn_pins_the_contract(tf32_on, tmp_path):
    """run_training at a cut size (the reduced classifier, one epoch of 8
    clips) leaves both flags False, having started True."""
    T = 16
    pair = synthetic.make_clip_pair("chi3d", 8, min_len=T + 4, max_len=T + 16, learnable=True)
    data = Feeder(clips=pair["train"], test_clips=pair["test"], dataname="chi3d",
                  split="train", num_frames=T, num_person=2)
    args = Namespace(dataset="chi3d", data_path="", pose_rep="rot6d", body_model="smplx",
                     glob=True, translation=True, num_frames=T, batch_size=4, lr=1e-3,
                     num_epochs=1, save_every=1, save_dir=str(tmp_path / "stgcn"), seed=0,
                     keep_best=False, stgcn_channels=(8, 8), stgcn_strides=(1, 1))
    assert _flags() == (True, True)
    train_stgcn.run_training(args, device="cpu", data=data)
    assert _flags() == (False, False)


def test_capability_study_pins_the_contract_before_its_evaluator(tf32_on, tmp_path):
    """--eval_only included: run_study pins both flags before it reads its
    workdir (here an empty one, so it then raises)."""
    spec = importlib.util.spec_from_file_location(
        "capability_study_torch", REPO / "scripts" / "capability_study_torch.py")
    study = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(study)
    with pytest.raises(FileNotFoundError):
        study.run_study(device="cpu", workdir=str(tmp_path), scale="smoke", eval_only=True)
    assert _flags() == (False, False)


def test_only_the_helper_assigns_the_tf32_flags():
    """No module of regennet_torch, no script and not chip_smoke.py
    assigns allow_tf32, except regennet_torch/device.py."""
    files = [*sorted((REPO / "regennet_torch").rglob("*.py")),
             *sorted((REPO / "scripts").glob("*.py")), REPO / "chip_smoke.py"]
    assigns = re.compile(r"allow_tf32\s*=(?!=)")
    found = sorted(str(path.relative_to(REPO)) for path in files
                   if assigns.search(path.read_text()))
    assert found == ["regennet_torch/device.py"]
