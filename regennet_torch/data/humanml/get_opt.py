"""Parser for the t2m release's ``opt.txt`` option files (the port's copy
of regennet_tpu/data/humanml/get_opt.py).

The released text-to-motion evaluator/generator bundles (Comp_v6_KLD01,
text_mot_match, length_est_bigru, ...) each ship an ``opt.txt`` of
``key: value`` lines that the reference parses to reconstruct network
sizes and dataset paths (reference:
data_loaders/humanml/utils/get_opt.py:29-87). This port keeps the same
key grammar and derived fields so a dropped-in release directory
configures our modules identically.

Deviation (documented): the reference coerces booleans with
``bool(value)``, which is True for BOTH the strings 'True' and 'False'
(any non-empty string is truthy); every flag the reference later relies
on (is_train, is_continue) is explicitly overwritten after parsing, so
the bug is latent there. We parse 'False' as False.
"""

from __future__ import annotations

import os
import re
from argparse import Namespace
from typing import Dict

_SKIP = (
    "-------------- End ----------------",
    "------------ Options -------------",
    "",
)

_FLOAT_RE = re.compile(r"^[-+]?[0-9]+\.[0-9]+$")


def _coerce(value: str):
    if value == "True":
        return True
    if value == "False":
        return False
    stripped = value.strip().lstrip("-").lstrip("+")
    if _FLOAT_RE.match(stripped):
        return float(value)
    if stripped.isdigit():
        return int(value)
    return value


def parse_opt_file(opt_path: str) -> Namespace:
    """Parse an opt.txt into a Namespace with the reference's derived
    dataset constants (reference: get_opt.py:29-87 minus the torch device
    plumbing). Unknown dataset_name values keep only the raw keys."""
    opt = Namespace()
    opt_dict: Dict = vars(opt)
    with open(opt_path) as f:
        for line in f:
            line = line.strip()
            if line in _SKIP:
                continue
            if ": " not in line:
                continue
            key, value = line.split(": ", 1)
            opt_dict[key] = _coerce(value)

    opt.which_epoch = "latest"
    if hasattr(opt, "checkpoints_dir") and hasattr(opt, "name") and hasattr(
        opt, "dataset_name"
    ):
        opt.save_root = os.path.join(
            opt.checkpoints_dir, opt.dataset_name, opt.name
        )
        opt.model_dir = os.path.join(opt.save_root, "model")
        opt.meta_dir = os.path.join(opt.save_root, "meta")

    dataset_name = getattr(opt, "dataset_name", None)
    if dataset_name == "t2m":
        opt.data_root = "./dataset/HumanML3D"
        opt.joints_num = 22
        opt.dim_pose = 263
        opt.max_motion_length = 196
    elif dataset_name == "kit":
        opt.data_root = "./dataset/KIT-ML"
        opt.joints_num = 21
        opt.dim_pose = 251
        opt.max_motion_length = 196
    if hasattr(opt, "data_root"):
        opt.motion_dir = os.path.join(opt.data_root, "new_joint_vecs")
        opt.text_dir = os.path.join(opt.data_root, "texts")

    opt.dim_word = 300
    if hasattr(opt, "unit_length"):
        opt.num_classes = 200 // int(opt.unit_length)
    from regennet_torch.data.humanml.word_vectorizer import DIM_POS

    opt.dim_pos_ohot = DIM_POS
    opt.is_train = False
    opt.is_continue = False
    return opt


def comp_v6_sizes_from_opt(opt: Namespace) -> Dict[str, int]:
    """Map a comp_v6 opt.txt's network dims onto CompV6Generator kwargs
    (reference key usage: comp_v6_model_dataset.py:10-39)."""
    sizes = {}
    mapping = {
        "dim_z": "dim_z",
        "dim_pri_hidden": "pri_hidden",
        "dim_dec_hidden": "dec_hidden",
        "dim_text_hidden": "text_hidden",
        "dim_att_vec": "att_vec",
        "n_layers_pri": "n_layers",
        "dim_movement_latent": "mov_latent",
    }
    for ref_key, our_key in mapping.items():
        if hasattr(opt, ref_key):
            sizes[our_key] = int(getattr(opt, ref_key))
    if hasattr(opt, "unit_length"):
        sizes["unit_length"] = int(opt.unit_length)
    return sizes


def find_opt_file(model_path: str) -> str | None:
    """Locate the opt.txt for a released checkpoint path: the release
    layout is <save_root>/{opt.txt, model/latest.tar}, so look next to the
    file and one directory up."""
    d = os.path.dirname(os.path.abspath(model_path.rstrip("/")))
    for candidate in (os.path.join(d, "opt.txt"),
                      os.path.join(os.path.dirname(d), "opt.txt")):
        if os.path.exists(candidate):
            return candidate
    return None
