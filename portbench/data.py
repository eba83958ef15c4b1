"""The benchmark's seeded inputs: weights, clips, captions and actors.

Everything is drawn from the run's --seed on the run's device, in a few
large calls, and handed to both the program and the reference. Every seed
gets the same set of sizes (clip lengths, caption lengths); the seed only
changes the values and their order. Nothing here imports the program.
"""

from __future__ import annotations

import gzip
import math
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

# the CLIP text tower's published shapes (ViT-B/32)
CLIP_TOWER = dict(vocab_size=49408, context_length=77, dim=512, heads=8, layers=12,
                  proj_dim=512)
# a tiny BPE merge table: the public one is not in the repository
BPE_MERGES = [("a", "</w>"), ("p", "e"), ("r", "s"), ("pe", "rs"), ("o", "n</w>"),
              ("pers", "on</w>"), ("w", "a"), ("l", "k"), ("wa", "lk"), ("s", "</w>"),
              ("walk", "s</w>"), ("t", "u"), ("r", "n"), ("tu", "rn"), ("turn", "s</w>")]
CAPTION_WORDS = ("a", "person", "walks", "turns", "runs", "forward", "left", "right",
                 "slowly", "then", "jumps", "and", "waves", "sits", "down", "back")


class ActionData:
    """What the program's model factory reads of an action dataset."""

    def __init__(self, num_actions: int):
        self.num_actions = num_actions


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def weight_std(name: str, shape) -> Tuple[float, float]:
    """(mean, std) of a leaf: LayerNorm gains 1 and offsets about 0, biases
    small, embeddings as CLIP and MDM draw them, matrices at 1/sqrt(fan in)."""
    leaf = name.rsplit(".", 1)[-1]
    norm = "norm" in name or ".ln_" in name or name.startswith("ln_")
    if norm and leaf == "weight":
        return 1.0, 0.02
    if leaf == "bias" or leaf.endswith("_bias") or norm:
        return 0.0, 0.02
    if "action_embedding" in name:
        return 0.0, 1.0
    if name == "token_embedding.weight":
        return 0.0, 0.02
    if name == "positional_embedding":
        return 0.0, 0.01
    return 0.0, 1.0 / math.sqrt(shape[-1])


def draw_weights(shapes: Dict[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 leaves of `shapes`, from one normal draw on `device`."""
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=generator(seed, device), device=device)
    out, start = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        mean, std = weight_std(name, shape)
        out[name] = (flat[start:start + n].view(shape) * std + mean)
        start += n
    return out


def clip_shapes() -> Dict[str, Tuple[int, ...]]:
    """The OpenAI ViT-B/32 text tower's state-dict layout."""
    c = CLIP_TOWER
    D, P = c["dim"], c["proj_dim"]
    shapes = {"token_embedding.weight": (c["vocab_size"], D),
              "positional_embedding": (c["context_length"], D)}
    for i in range(c["layers"]):
        n = f"transformer.resblocks.{i}"
        shapes.update({
            f"{n}.ln_1.weight": (D,), f"{n}.ln_1.bias": (D,),
            f"{n}.attn.in_proj_weight": (3 * D, D), f"{n}.attn.in_proj_bias": (3 * D,),
            f"{n}.attn.out_proj.weight": (D, D), f"{n}.attn.out_proj.bias": (D,),
            f"{n}.ln_2.weight": (D,), f"{n}.ln_2.bias": (D,),
            f"{n}.mlp.c_fc.weight": (4 * D, D), f"{n}.mlp.c_fc.bias": (4 * D,),
            f"{n}.mlp.c_proj.weight": (D, 4 * D), f"{n}.mlp.c_proj.bias": (D,),
        })
    shapes.update({"ln_final.weight": (D,), "ln_final.bias": (D,),
                   "text_projection": (D, P)})
    return shapes


CLIP_SEED = 13  # the tower is frozen pretrained weights: the same in every run


def clip_files(cache_dir: str, device) -> Dict[str, str]:
    """The CLIP tower (an OpenAI-layout state dict) and the merge table,
    written once into `cache_dir` and read by every later run. Returns
    {"clip": path, "bpe": path}."""
    os.makedirs(cache_dir, exist_ok=True)
    paths = {"clip": os.path.join(cache_dir, "ViT-B-32.pt"),
             "bpe": os.path.join(cache_dir, "bpe_simple_vocab_16e6.txt.gz")}
    if not os.path.exists(paths["bpe"]):
        tmp = paths["bpe"] + ".part"
        with gzip.open(tmp, "wt", encoding="utf-8") as f:
            f.write("#version: 0.2\n" + "\n".join(" ".join(m) for m in BPE_MERGES))
        os.replace(tmp, paths["bpe"])
    if not os.path.exists(paths["clip"]):
        tower = {k: v.cpu() for k, v in draw_weights(clip_shapes(), CLIP_SEED, device).items()}
        tmp = paths["clip"] + ".part"
        torch.save(tower, tmp)
        os.replace(tmp, paths["clip"])
    return paths


def captions(count: int, seed: int) -> List[str]:
    """`count` captions of 4 to 19 words from a fixed vocabulary; every
    seed gets the same lengths in another order."""
    rng = np.random.default_rng(seed)
    lengths = rng.permutation(4 + np.arange(count) % 16)
    return [" ".join(CAPTION_WORDS[i] for i in rng.integers(0, len(CAPTION_WORDS), n))
            for n in lengths]


def pose_clips(rows: int, joints: int, feats: int, frames: int, seed: int, device) -> np.ndarray:
    """[rows, joints, feats, frames] float32 rot6d poses, the last joint
    row the root translation (its first three channels; the rest 0)."""
    x = torch.randn(rows, joints, feats, frames, generator=generator(seed, device),
                    device=device)
    x[:, -1, 3:] = 0.0
    x[:, -1, :3] *= 0.5
    return x.cpu().numpy()


def chi3d_batches(cfg: dict, rows: int, count: int, seed: int, device) -> List[tuple]:
    """`count` collated Chi3D batches of `rows` clips, as the two-person
    loader yields them: (reactor [B, J, F, T], {"y": {mask, lengths,
    action, cmotion}}), every clip whole (T valid frames)."""
    J, Fe, T = cfg["njoints"], cfg["nfeats"], cfg["num_frames"]
    n = rows * count
    both = pose_clips(2 * n, J, Fe, T, seed, device)
    actions = np.random.default_rng(seed).integers(0, cfg["num_actions"], (n, 1))
    out = []
    for b in range(count):
        sl = slice(b * rows, (b + 1) * rows)
        lengths = np.full((rows,), T, dtype=np.int64)
        mask = (np.arange(T)[None, :] < lengths[:, None])[:, None, None, :]
        y = {"mask": mask, "lengths": lengths, "action": actions[sl].astype(np.int64),
             "cmotion": both[n:][sl]}
        out.append((both[:n][sl], {"y": y}))
    return out


def humanml_batches(cfg: dict, rows: int, count: int, seed: int, device) -> List[tuple]:
    """`count` collated HumanML3D batches of `rows` clips, as the text
    loader yields them: (features [B, 263, 1, 196] zero past each clip's
    length, {"y": {mask, lengths, text}}). Lengths run evenly over
    40..196 frames in every seed, in the seed's order."""
    J, Fe, T = cfg["njoints"], cfg["nfeats"], cfg["num_frames"]
    n = rows * count
    rng = np.random.default_rng(seed)
    lengths = rng.permutation(np.linspace(40, T, n).round().astype(np.int64))
    x = pose_clips(n, J, Fe, T, seed, device)
    valid = np.arange(T)[None, :] < lengths[:, None]
    x = x * valid[:, None, None, :]
    texts = captions(n, seed)
    out = []
    for b in range(count):
        sl = slice(b * rows, (b + 1) * rows)
        y = {"mask": valid[sl][:, None, None, :], "lengths": lengths[sl], "text": texts[sl]}
        out.append((x[sl], {"y": y}))
    return out


def actor_requests(cfg: dict, rows: int, count: int, seed: int,
                   device) -> List[Dict[str, torch.Tensor]]:
    """`count` sampling requests of `rows` actor clips each, on `device`:
    {"cmotion" [B, J, F, T], "action" [B, 1], "mask" [B, 1, 1, T]}."""
    J, Fe, T = cfg["njoints"], cfg["nfeats"], cfg["num_frames"]
    actors = torch.as_tensor(pose_clips(rows * count, J, Fe, T, seed, device), device=device)
    actions = torch.as_tensor(
        np.random.default_rng(seed).integers(0, cfg["num_actions"], (rows * count, 1)),
        device=device)
    mask = torch.ones((rows, 1, 1, T), dtype=torch.bool, device=device)
    return [{"cmotion": actors[i * rows:(i + 1) * rows], "action": actions[i * rows:(i + 1) * rows],
             "mask": mask} for i in range(count)]
