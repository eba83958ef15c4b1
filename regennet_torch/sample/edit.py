"""Motion inpainting CLI: `python -m regennet_torch.sample.edit`
(counterpart of regennet_tpu/sample/edit.py).

Generates motion while holding part of an input clip fixed, through the
diffusion inpainting hook: cond['inpainted_motion'] and
cond['inpainting_mask'] overwrite the x_0 prediction of every step inside
`diffusion.gaussian.p_mean_variance`.

Modes:
  * in_between: the frames before prefix_end and from suffix_start on
    (fractions of each clip's own length) are kept, the middle generated;
  * upper_body: the lower-body joints (and the translation row) are kept,
    the upper body generated; for HumanML3D features (hml_vec) the
    lower-body feature dims.

The a2m and two-person route edits clips drawn from the dataset through
ccollate; a text model (humanml, kit) edits dataset clips under
--text_condition, through t2m_collate and the CLIP encoder (an empty text
generates unconditioned, guidance 0). The sampler's noise comes from a
torch.Generator seeded by --seed. Writes results.npy with the JAX CLI's
keys to `edit_{mode}_seed{seed}` beside the checkpoint (or --output_dir).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from regennet_torch.data.collate import ccollate
from regennet_torch.device import pin_f32_contract, resolve_device
from regennet_torch.diffusion import sampling
from regennet_torch.models.cmdm import make_cfg_model_fn, make_model_fn
from regennet_torch.sample.cgenerate import load_dataset
from regennet_torch.train import checkpoint
from regennet_torch.utils import parser_util
from regennet_torch.utils.fixseed import fixseed
from regennet_torch.utils.model_util import create_model_and_diffusion, model_dtype

# lower-body joint rows (pelvis, hips, knees, ankles, feet) in the SMPL and
# SMPL-X joint order; the translation row (the last) is kept with them
LOWER_BODY_JOINTS = [0, 1, 2, 4, 5, 7, 8, 10, 11]


def build_inpainting_cond(motion: np.ndarray, mode: str, prefix_end: float,
                          suffix_start: float, data_rep: str = "rot6d",
                          lengths=None) -> dict:
    """{'inpainted_motion': motion, 'inpainting_mask': bool mask} as numpy,
    the mask set where the motion is kept."""
    B, J, F, T = motion.shape
    mask = np.zeros(motion.shape, dtype=bool)
    if mode == "in_between":
        # the boundaries scale with each clip's own length; the kept
        # suffix runs to the end of the window
        lens = np.full((B,), T) if lengths is None else np.asarray(lengths, np.int64)
        for i, L in enumerate(lens):
            mask[i, :, :, : int(prefix_end * L)] = True
            mask[i, :, :, int(suffix_start * L):] = True
    elif mode == "upper_body":
        if data_rep == "hml_vec":
            from regennet_torch.data.humanml.humanml_utils import HML_LOWER_BODY_MASK

            mask[:, HML_LOWER_BODY_MASK[:J]] = True
        else:
            mask[:, LOWER_BODY_JOINTS + [J - 1]] = True
    else:
        raise ValueError(f"unknown edit mode {mode}")
    return {"inpainted_motion": motion, "inpainting_mask": mask}


def edit_cli_args(argv=None):
    """The CLI's options: the base, data, sampling and edit groups, the
    model and diffusion groups from the args.json beside --model_path."""
    parser = parser_util.ArgumentParser()
    parser_util.add_base_options(parser)
    parser_util.add_data_options(parser)
    parser_util.add_sampling_options(parser)
    parser_util.add_edit_options(parser)
    return parser_util.parse_and_load_from_model_wo_data(parser, argv)


def _batch(args, data, num_samples, device):
    """(motion, cond_np) of the first num_samples clips of the dataset; for a
    text model the captions replaced by --text_condition, its CLIP
    embeddings in cond_np['y']['text_emb']."""
    items = [data[i % len(data)] for i in range(num_samples)]
    if args.dataset not in ("humanml", "kit"):
        return ccollate(items)
    from regennet_torch.data.humanml.dataset import t2m_collate
    from regennet_torch.models.clip_text import encode_text_or_fallback

    motion, cond_np = t2m_collate(items)
    texts = [args.text_condition] * len(items)
    if args.text_condition == "":
        args.guidance_param = 0.0  # no text: generate unconditioned
    cond_np["y"]["cmotion"] = np.zeros_like(motion)
    cond_np["y"]["text_emb"] = encode_text_or_fallback(texts, device)
    cond_np["y"]["action_text"] = texts
    return motion, cond_np


def main(args=None, device=None, data=None) -> str:
    """Edit args.num_samples clips and write results.npy; returns its path.

    device: "cpu", "cuda:N" or a torch.device; None means cuda:{args.device}
    (or the CPU for --device cpu) and raises without CUDA. data: a dataset
    to draw the clips from instead of args.data_path."""
    if args is None:
        args = edit_cli_args()
    device = resolve_device(device, getattr(args, "device", 0))
    pin_f32_contract()
    fixseed(args.seed)

    if not getattr(args, "num_frames", None) or args.num_frames <= 0:
        args.num_frames = {"ntu": 60, "chi3d": 150}.get(args.dataset, 60)
    if data is None:
        data = load_dataset(args)
    args.num_actions = data.num_actions
    model, sched, cfg = create_model_and_diffusion(args, data, device=device)

    motion, cond_np = _batch(args, data, args.num_samples, device)
    if args.model_path and args.model_path != "random":
        checkpoint.load_model(model, args.model_path)
    model = model.to(device=device, dtype=model_dtype(args)).eval()
    guidance = float(getattr(args, "guidance_param", 1.0))
    model_fn = make_cfg_model_fn(model, guidance) if guidance != 1.0 else make_model_fn(model)

    y = cond_np["y"]
    inpaint = build_inpainting_cond(motion, args.edit_mode, args.prefix_end,
                                    args.suffix_start, data_rep=model.data_rep,
                                    lengths=y.get("lengths"))
    cond = {key: torch.as_tensor(np.asarray(value), device=device)
            for key, value in {**y, **inpaint}.items()
            if key in ("cmotion", "mask", "action", "text_emb", *inpaint)}
    sampler = sampling.ddim_sample_loop if args.use_ddim else sampling.p_sample_loop
    generator = torch.Generator(device=device).manual_seed(int(args.seed))
    sample = sampler(sched, cfg, model_fn, motion.shape, cond, clip_denoised=False,
                     generator=generator).cpu().numpy()

    out_path = args.output_dir or os.path.join(
        os.path.dirname(args.model_path), f"edit_{args.edit_mode}_seed{args.seed}")
    os.makedirs(out_path, exist_ok=True)
    npy_path = os.path.join(out_path, "results.npy")
    np.save(npy_path, {
        "motion": sample,
        "output": sample,
        "cmotion": np.asarray(y["cmotion"]),
        "input_motion": motion,
        "inpainting_mask": inpaint["inpainting_mask"],
        "text": y.get("action_text", []),
        "lengths": np.asarray(y["lengths"]),
        "edit_mode": args.edit_mode,
    })
    print(f"saved edit results to [{npy_path}]")
    return npy_path


if __name__ == "__main__":
    main()
