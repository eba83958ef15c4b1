"""SMPL / SMPL-X body model parameters as torch tensors (counterpart of
regennet_tpu/ops/body_model.py, without JAX).

Three ways to get a model, as there:
  * `load_smplx_npz(path)` / `load_smplx_pkl(path)`: official SMPL-X archives
  * `load_smpl_pkl(path)`: the official SMPL archive (chumpy pickle)
  * `synthetic(...)`: a deterministic random model with the real kinematic
    topology, for tests and benchmarks when licensed assets are absent.
    Same seed, same arrays as the JAX package's `synthetic`.
The loaders read numpy only; `BodyModel.to(device)` moves the tensors.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import pickle
from typing import Optional, Tuple

import numpy as np
import torch

SMPL_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18,
     19, 20, 21],
    dtype=np.int32,
)

SMPLX_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18,
     19, 15, 15, 15,
     # left hand: index, middle, pinky, ring, thumb (3 links each)
     20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,
     # right hand
     21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53],
    dtype=np.int32,
)

NUM_BETAS = 10

# landmark vertex ids of the SMPL wrapper's extended joint output
SMPL_LANDMARK_VERTEX_IDS = np.array(
    [332, 6260, 2800, 4071, 583,
     3216, 3226, 3387, 6617, 6624, 6787,
     2746, 2319, 2445, 2556, 2673,
     6191, 5782, 5905, 6016, 6133],
    dtype=np.int32,
)


def _levels_from_parents(parents: np.ndarray) -> Tuple[Tuple[tuple, tuple], ...]:
    """(joint_indices, parent_indices) per tree depth, root excluded: every
    joint of a level has its parent in an earlier level."""
    depth = np.zeros(len(parents), dtype=np.int32)
    for j in range(1, len(parents)):
        depth[j] = depth[parents[j]] + 1
    levels = []
    for d in range(1, depth.max() + 1):
        idx = np.nonzero(depth == d)[0]
        levels.append((tuple(int(i) for i in idx),
                       tuple(int(p) for p in parents[idx])))
    return tuple(levels)


@dataclasses.dataclass(frozen=True)
class BodyModel:
    """Parameters of an SMPL-family body model (float32 tensors)."""

    v_template: torch.Tensor          # [V, 3]
    shapedirs: torch.Tensor           # [V, 3, n_betas]
    posedirs: torch.Tensor            # [P, V*3], P = 9 * (J - 1)
    j_regressor: torch.Tensor         # [J, V]
    lbs_weights: torch.Tensor         # [V, J]
    extra_joint_regressor: Optional[torch.Tensor]  # [K_extra, V] or None
    parents: Tuple[int, ...]
    levels: Tuple[Tuple[tuple, tuple], ...]
    landmark_vertex_ids: Optional[Tuple[int, ...]]
    name: str
    # [NF, 3] int32 triangles for rendering; left out of == and hash()
    faces: Optional[np.ndarray] = dataclasses.field(default=None, compare=False)

    @property
    def num_joints(self) -> int:
        return len(self.parents)

    @property
    def num_vertices(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_betas(self) -> int:
        return self.shapedirs.shape[-1]

    def to(self, device) -> "BodyModel":
        fields = ("v_template", "shapedirs", "posedirs", "j_regressor",
                  "lbs_weights", "extra_joint_regressor")
        return dataclasses.replace(self, **{
            f: None if getattr(self, f) is None else getattr(self, f).to(device)
            for f in fields
        })


def _make(name, v_template, shapedirs, posedirs, j_regressor, lbs_weights,
          extra_joint_regressor, parents, landmark_vertex_ids,
          faces=None) -> BodyModel:
    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))

    return BodyModel(
        v_template=f32(v_template),
        shapedirs=f32(shapedirs),
        posedirs=f32(posedirs),
        j_regressor=f32(j_regressor),
        lbs_weights=f32(lbs_weights),
        extra_joint_regressor=(None if extra_joint_regressor is None
                               else f32(extra_joint_regressor)),
        parents=tuple(int(p) for p in np.asarray(parents)),
        levels=_levels_from_parents(np.asarray(parents)),
        landmark_vertex_ids=(None if landmark_vertex_ids is None
                             else tuple(int(i) for i in
                                        np.asarray(landmark_vertex_ids))),
        name=name,
        faces=None if faces is None else np.ascontiguousarray(faces, dtype=np.int32),
    )


def _to_np(x) -> np.ndarray:
    """numpy / chumpy / scipy-sparse leaves -> dense numpy."""
    if hasattr(x, "toarray"):
        return np.asarray(x.toarray())
    return np.asarray(x)


def _smplx_from_mapping(data, num_betas: int) -> BodyModel:
    shapedirs = _to_np(data["shapedirs"])[:, :, :num_betas]
    posedirs = _to_np(data["posedirs"])
    posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T  # [V, 3, P] -> [P, V*3]
    parents = _to_np(data["kintree_table"])[0].astype(np.int64)
    parents[0] = -1
    nj = 55
    return _make(
        "smplx",
        v_template=_to_np(data["v_template"]),
        shapedirs=shapedirs,
        posedirs=posedirs[: 9 * (nj - 1)],
        j_regressor=_to_np(data["J_regressor"])[:nj],
        lbs_weights=_to_np(data["weights"])[:, :nj],
        extra_joint_regressor=None,
        parents=parents[:nj],
        landmark_vertex_ids=None,
        faces=_to_np(data["f"]) if "f" in data else None,
    )


def load_smplx_npz(path: str, num_betas: int = NUM_BETAS) -> BodyModel:
    """Official SMPL-X npz archive (e.g. SMPLX_NEUTRAL.npz)."""
    return _smplx_from_mapping(np.load(path, allow_pickle=True), num_betas)


def load_smplx_pkl(path: str, num_betas: int = NUM_BETAS) -> BodyModel:
    """Official SMPL-X pkl archive (chumpy pickle)."""
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    return _smplx_from_mapping(data, num_betas)


def load_smpl_pkl(path: str, num_betas: int = NUM_BETAS,
                  extra_regressor_path: Optional[str] = None) -> BodyModel:
    """Official SMPL pkl archive (chumpy pickle)."""
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    shapedirs = _to_np(data["shapedirs"])[:, :, :num_betas]
    posedirs = _to_np(data["posedirs"])
    posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T
    parents = _to_np(data["kintree_table"])[0].astype(np.int64)
    parents[0] = -1
    extra = None
    if extra_regressor_path and os.path.exists(extra_regressor_path):
        extra = np.load(extra_regressor_path)
    return _make(
        "smpl",
        v_template=_to_np(data["v_template"]),
        shapedirs=shapedirs,
        posedirs=posedirs,
        j_regressor=_to_np(data["J_regressor"]),
        lbs_weights=_to_np(data["weights"]),
        extra_joint_regressor=extra,
        parents=parents,
        landmark_vertex_ids=SMPL_LANDMARK_VERTEX_IDS,
        faces=_to_np(data["f"]) if "f" in data else None,
    )


def synthetic(name: str = "smplx", num_vertices: int = 512,
              num_betas: int = NUM_BETAS, seed: int = 0) -> BodyModel:
    """Deterministic random body model with the real kinematic topology.

    Rest joints are spread along the tree (bones ~20 cm); nj extra
    "virtual" vertices sit exactly at the joints and the joint regressor
    selects them, so J_regressor @ v_template == joints exactly."""
    parents = SMPLX_PARENTS if name == "smplx" else SMPL_PARENTS
    nj = len(parents)
    rng = np.random.default_rng(seed)

    offsets = rng.normal(scale=0.12, size=(nj, 3))
    joints = np.zeros((nj, 3))
    for j in range(1, nj):
        joints[j] = joints[parents[j]] + offsets[j]

    dominant = rng.integers(0, nj, size=num_vertices)
    v_template = joints[dominant] + rng.normal(scale=0.05, size=(num_vertices, 3))

    w = np.full((num_vertices, nj), 1e-4)
    w[np.arange(num_vertices), dominant] += 0.8
    par = np.where(parents[dominant] >= 0, parents[dominant], dominant)
    w[np.arange(num_vertices), par] += 0.2
    w /= w.sum(axis=1, keepdims=True)

    v_template = np.concatenate([v_template, joints], axis=0)
    jreg = np.concatenate([np.zeros((nj, num_vertices)), np.eye(nj)], axis=1)
    w = np.concatenate([w, np.eye(nj) + 1e-6], axis=0)
    w /= w.sum(axis=1, keepdims=True)
    V = v_template.shape[0]

    shapedirs = rng.normal(scale=0.01, size=(V, 3, num_betas))
    posedirs = rng.normal(scale=0.001, size=(9 * (nj - 1), V * 3))
    posedirs.reshape(9 * (nj - 1), V, 3)[:, num_vertices:, :] = 0.0

    landmark_ids = None
    extra = None
    if name == "smpl":
        landmark_ids = rng.integers(0, V, size=21).astype(np.int32)
        extra = rng.dirichlet(np.ones(V) * 0.05, size=9)
    # consecutive triples: faces to draw without licensed assets
    faces = np.stack([np.arange(0, num_vertices - 2), np.arange(1, num_vertices - 1),
                      np.arange(2, num_vertices)], axis=1)
    return _make(name, v_template, shapedirs, posedirs, jreg, w, extra,
                 parents, landmark_ids, faces=faces)


@functools.lru_cache(maxsize=4)
def get_body_model(name: str, model_dir: str = "./body_models",
                   allow_synthetic: bool = True) -> BodyModel:
    """Real assets if present, else the synthetic fallback (on the CPU):
    `{model_dir}/smplx/SMPLX_NEUTRAL.npz` or `{model_dir}/smpl/SMPL_NEUTRAL.pkl`."""
    if name == "smplx":
        path = os.path.join(model_dir, "smplx", "SMPLX_NEUTRAL.npz")
        if os.path.exists(path):
            return load_smplx_npz(path)
    elif name == "smpl":
        path = os.path.join(model_dir, "smpl", "SMPL_NEUTRAL.pkl")
        if os.path.exists(path):
            return load_smpl_pkl(
                path,
                extra_regressor_path=os.path.join(
                    model_dir, "smpl", "J_regressor_extra.npy"),
            )
    else:
        raise ValueError(f"unknown body model {name}")
    if not allow_synthetic:
        raise FileNotFoundError(path)
    return synthetic(name)
