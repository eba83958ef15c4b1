"""results.npy -> per-frame OBJ meshes and an SMPL parameter dump (the
port's counterpart of regennet_tpu/visualize/vis_utils.py).

`Npy2Obj` loads a generation `results.npy`, picks one (sample,
repetition), decodes the body model's vertices (`make_rot2xyz` with
jointstype "vertices", on the given device), and writes Wavefront OBJ
frames and a `_smpl_params.npy` dict. A motion stored as xyz (nfeats 3)
is first turned back into rot6d poses by the SMPLify-style fit
(`joints2smpl.fit_sequence`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from regennet_torch.device import resolve_device
from regennet_torch.ops import body_model as bm
from regennet_torch.ops.pose_decode import make_rot2xyz
from regennet_torch.visualize.joints2smpl import export_obj, fit_sequence


class Npy2Obj:
    """Mesh exporter for one (sample, repetition) of a results.npy dict: the
    absolute index is rep_idx * num_samples + sample_idx. device: "cpu",
    "cuda:N" or a torch.device; None means cuda:0 and raises without
    CUDA."""

    def __init__(self, npy_path: str, sample_idx: int, rep_idx: int,
                 body_model: Optional[str] = None, fit_steps: int = 300, device=None):
        self.npy_path = npy_path
        device = resolve_device(device)
        motions = np.load(npy_path, allow_pickle=True)
        if npy_path.endswith(".npz"):
            motions = motions["arr_0"]
        self.motions = motions[None][0]
        if hasattr(self.motions, "item") and not isinstance(self.motions, dict):
            self.motions = self.motions.item()

        motion = np.asarray(self.motions["motion"])
        self.bs, self.njoints, self.nfeats, self.nframes = motion.shape
        self.sample_idx = sample_idx
        self.rep_idx = rep_idx
        self.total_num_samples = int(self.motions.get("num_samples", self.bs))
        self.absl_idx = rep_idx * self.total_num_samples + sample_idx

        name = body_model or ("smplx" if self.njoints in (56, 55) else "smpl")
        self.body = bm.get_body_model(name).to(device)
        self.faces = self.body.faces

        lengths = np.asarray(self.motions.get("lengths", [self.nframes] * self.bs))
        self.real_num_frames = int(lengths[self.absl_idx])

        if self.nfeats == 3:
            print(f"Running SMPLify for sample [{sample_idx}], repetition [{rep_idx}], "
                  "it may take a few minutes.")
            target = motion[self.absl_idx].transpose(2, 0, 1)  # [T, J, 3]
            fit = fit_sequence(self.body, target[:, :self.body.num_joints],
                               num_steps=fit_steps)
            rot_part = fit["pose6d"].transpose(1, 2, 0)  # [J, 6, T]
            trans_row = np.zeros((1, 6, rot_part.shape[-1]), np.float32)
            trans_row[0, :3] = fit["transl"].T
            self.motion = np.concatenate([rot_part, trans_row], 0)[None]
            self.njoints, self.nfeats = self.motion.shape[1:3]
        else:
            self.motion = motion[[self.absl_idx]]

        rot2xyz = make_rot2xyz(self.body, pose_rep="rot6d", translation=True, glob=True,
                               jointstype="vertices", vertstrans=True, num_person=1)
        with torch.no_grad():
            verts = rot2xyz(torch.as_tensor(self.motion, dtype=torch.float32, device=device))
        # the root location added back
        root_loc = self.motion[:, -1, :3, :].reshape(1, 1, 3, -1)
        self.vertices = verts.cpu().numpy() + root_loc

    def get_vertices(self, sample_i: int, frame_i: int) -> np.ndarray:
        return self.vertices[sample_i, :, :, frame_i]

    def save_obj(self, save_path: str, frame_i: int) -> str:
        export_obj(self.get_vertices(0, frame_i), self.faces, save_path)
        return save_path

    def save_npy(self, save_path: str):
        T = self.real_num_frames
        text = self.motions.get("text", [""])
        data_dict = {
            "motion": self.motion[0, :, :, :T],
            "thetas": self.motion[0, :-1, :, :T],
            "root_translation": self.motion[0, -1, :3, :T],
            "faces": self.faces,
            "vertices": self.vertices[0, :, :, :T],
            "text": text[0] if len(text) else "",
            "length": T,
        }
        np.save(save_path, data_dict)


npy2obj = Npy2Obj  # the reference's lower-case name
