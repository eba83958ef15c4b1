"""Conditional generation CLI: `python -m regennet_torch.sample.cgenerate`
(counterpart of regennet_tpu/sample/cgenerate.py).

Loads the model hyperparameters from the checkpoint's args.json, picks
actor ("cmotion") clips per action for each repetition, runs DDPM or
DDIM sampling on the GPU, smooths temporally, decodes to joints, and
writes results.npy with the JAX CLI's dict layout and shapes.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np
import torch
from scipy.ndimage import gaussian_filter1d

from regennet_torch.data.collate import ccollate
from regennet_torch.data.get_data import get_dataset
from regennet_torch.device import pin_f32_contract, resolve_device
from regennet_torch.diffusion import sampling
from regennet_torch.models.cmdm import make_cfg_model_fn, make_model_fn
from regennet_torch.ops import body_model as bm
from regennet_torch.ops.pose_decode import make_rot2xyz
from regennet_torch.train import checkpoint
from regennet_torch.utils import parser_util
from regennet_torch.utils.fixseed import fixseed
from regennet_torch.utils.model_util import create_model_and_diffusion, model_dtype


def load_dataset(args, split="test"):
    return get_dataset(
        name=args.dataset,
        num_frames=args.num_frames if hasattr(args, "num_frames") else -1,
        num_person=args.num_person,
        data_path=args.data_path,
        split=split,
        setting=args.setting,
        pose_rep=args.pose_rep,
        body_model=args.body_model,
    )


def main(args=None, device=None, data=None,
         generate_ms: Optional[List[float]] = None) -> str:
    """Sample args.num_repetitions batches and write results.npy; returns
    its path.

    device: "cpu", "cuda:N" or a torch.device; None means cuda:{args.device}
    and raises without CUDA. data: a dataset (e.g. Feeder(clips=...)) to
    draw the actor clips from instead of args.data_path. generate_ms, if
    given, receives each repetition's sampling time in ms (synchronised)."""
    if args is None:
        args = parser_util.cgenerate_args()
    device = resolve_device(device, getattr(args, "device", 0))
    pin_f32_contract()
    fixseed(args.seed)

    if not getattr(args, "num_frames", None) or args.num_frames <= 0:
        args.num_frames = {"ntu": 60, "chi3d": 150}.get(args.dataset, 60)

    out_path = args.output_dir
    if not out_path:
        base = os.path.dirname(args.model_path) or "."
        name = os.path.basename(args.model_path).replace("model", "samples_")
        out_path = os.path.join(base, f"{name}_seed{args.seed}")

    if data is None:
        print(f"Loading dataset {args.dataset} from {args.data_path} ...")
        data = load_dataset(args)
    args.num_actions = data.num_actions
    # --action_name "name1,name2" / --action_file (one name per line)
    action_text = []
    if getattr(args, "action_name", ""):
        action_text = [s for s in args.action_name.split(",") if s]
    elif getattr(args, "action_file", ""):
        with open(args.action_file) as fr:
            action_text = [line.strip() for line in fr if line.strip()]
    fixed_actions = None
    if action_text:
        known = set(getattr(data, "_action_classes", {}).values())
        unknown = [t for t in action_text if known and t not in known]
        if unknown:
            raise ValueError(
                f"unknown action name(s) {unknown}; choose from "
                f"{sorted(known)}"
            )
        fixed_actions = [
            int(a) for a in np.atleast_1d(
                np.asarray(data.action_name_to_action(action_text))
            )
        ]
        args.num_samples = len(fixed_actions)
    total_num_samples = args.num_samples * args.num_repetitions

    print("Creating model and diffusion...")
    model, sched, cfg = create_model_and_diffusion(args, data, device=device)
    if args.model_path and args.model_path != "random":
        checkpoint.load_model(model, args.model_path)
    model = model.to(device=device, dtype=model_dtype(args)).eval()
    guidance = float(getattr(args, "guidance_param", 1.0))
    if guidance != 1.0:
        model_fn = make_cfg_model_fn(model, guidance)
    else:
        model_fn = make_model_fn(model)
    sampler = sampling.ddim_sample_loop if args.use_ddim else sampling.p_sample_loop
    generator = torch.Generator(device=device).manual_seed(int(args.seed))
    rot2xyz = make_rot2xyz(
        bm.get_body_model(args.body_model).to(device),
        pose_rep=args.pose_rep, jointstype=args.body_model,
        translation=True, glob=True, vertstrans=True,
    )

    all_motions, all_output, all_cmotions, all_lengths, all_text = [], [], [], [], []
    times_ms = []
    for rep_i in range(args.num_repetitions):
        print(f"### Sampling [repetitions #{rep_i}]")
        actions = (
            fixed_actions if fixed_actions is not None
            else [i % data.num_actions for i in range(args.num_samples)]
        )
        items = [
            data.get_cmotion(a, mode="appointed", data_index=rep_i) for a in actions
        ]
        motion, cond_np = ccollate(items)
        cond = {
            "cmotion": torch.as_tensor(cond_np["y"]["cmotion"], device=device),
            "action": torch.as_tensor(cond_np["y"]["action"], device=device),
            "mask": torch.as_tensor(cond_np["y"]["mask"], device=device),
        }
        if "text_emb" in cond_np["y"]:  # a text-conditioned model's CLIP embeddings
            cond["text_emb"] = torch.as_tensor(cond_np["y"]["text_emb"], device=device)
        t0 = time.perf_counter()
        sample = sampler(sched, cfg, model_fn, motion.shape, cond,
                         clip_denoised=False, generator=generator)
        sample_np = sample.cpu().numpy()  # waits for the device
        dt = (time.perf_counter() - t0) * 1000
        times_ms.append(dt)
        print(f"Generate time: {dt:.1f} ms for {motion.shape[0]} sequences")

        sample_np = gaussian_filter1d(sample_np, sigma=1, axis=-1)
        lengths = cond_np["y"]["lengths"]
        mask = torch.as_tensor(
            np.asarray(cond_np["y"]["mask"])[:, 0, 0].astype(bool), device=device
        )
        joints = rot2xyz(torch.as_tensor(sample_np, device=device), mask)

        all_output.append(sample_np)
        all_motions.append(joints.cpu().numpy())
        all_cmotions.append(np.asarray(cond_np["y"]["cmotion"]))
        all_text.append(cond_np["y"]["action_text"])
        all_lengths.append(np.asarray(lengths))

    print(
        f"Average generate time: {np.mean(times_ms):.1f} ms "
        f"({np.mean(times_ms) / max(args.num_samples, 1):.2f} ms/seq)"
    )
    if generate_ms is not None:
        generate_ms.extend(times_ms)

    all_motions_np = np.concatenate(all_motions, axis=0)[:total_num_samples]
    all_output_np = np.concatenate(all_output, axis=0)[:total_num_samples]
    all_cmotions_np = np.concatenate(all_cmotions, axis=0)[:total_num_samples]
    all_lengths_np = np.concatenate(all_lengths, axis=0)[:total_num_samples]
    all_text_flat = [t for rep in all_text for t in rep][:total_num_samples]

    os.makedirs(out_path, exist_ok=True)
    npy_path = os.path.join(out_path, "results.npy")
    print(f"saving results file to [{npy_path}]")
    np.save(
        npy_path,
        {
            "motion": all_motions_np,
            "output": all_output_np,
            "cmotion": all_cmotions_np,
            "text": all_text_flat,
            "lengths": all_lengths_np,
            "num_samples": args.num_samples,
            "num_repetitions": args.num_repetitions,
        },
    )
    with open(npy_path.replace(".npy", ".txt"), "w") as fw:
        fw.write("\n".join(all_text_flat))
    with open(npy_path.replace(".npy", "_len.txt"), "w") as fw:
        fw.write("\n".join([str(int(l)) for l in all_lengths_np]))
    return npy_path


if __name__ == "__main__":
    main()
