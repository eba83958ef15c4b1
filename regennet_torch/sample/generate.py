"""Free-text text-to-motion generation: `python -m regennet_torch.sample.generate`
(counterpart of regennet_tpu/sample/generate.py).

Generates motions for text prompts from one of two checkpoints:
- an MDM-style diffusion model (`train_mdm --dataset humanml` or `kit`):
  the model is rebuilt from the args.json beside the .pt, the prompts
  become CLIP embeddings (or the hashed stand-in without CLIP weights,
  `models/clip_text`), and DDPM sampling runs at the 196-frame window
  with classifier-free guidance folded into one 2B forward
  (`--guidance_param`);
- the comp_v6 generator (train_t2m_gen's .pt or a released latest.tar,
  told apart as eval_humanml tells them): the prompts' GloVe word inputs
  (--glove_root), T rounded down to whole snippets, and the prior sampled
  over them from the movement encoder's start token, its noise from a
  torch.Generator seeded by --seed.
The RIC features are denormalised with the dataset's Mean/Std and decoded
to joints (`recover_from_ric`). Writes results.npy (motion [N, T, J, 3],
feature [N, T, F], text, lengths, num_samples) and results.txt, as the
JAX CLI does.

Prompts come from --text_prompt (one prompt, repeated --num_samples
times) or --input_text (a file, one prompt per line). With
--length_estimator (train_t2m_eval's length .pt or a released
latest.tar) each prompt's length is drawn from the estimator's logits
over its GloVe word inputs (--glove_root), in bins of 4 frames clipped to
[4, T], by a torch.Generator seeded by --seed (the JAX CLI draws with
jax.random.categorical; the logits agree, the draws do not). --render (on
by default, as in the JAX CLI) draws each motion as a stick figure along
the T2M or KIT chain (render/plot_script.py: matplotlib and imageio) into
sample{i:02d}.mp4, or a gif without an FFmpeg writer, beside results.npy.
"""

from __future__ import annotations

import json
import os
import time
from argparse import Namespace
from typing import List

import numpy as np
import torch

from regennet_torch.data.humanml.motion_process import recover_from_ric
from regennet_torch.device import pin_f32_contract, resolve_device
from regennet_torch.diffusion import sampling
from regennet_torch.eval.eval_humanml import is_comp_v6, load_comp_v6_checkpoint
from regennet_torch.models import t2m_gen
from regennet_torch.models.clip_text import encode_text_or_fallback
from regennet_torch.models.cmdm import make_cfg_model_fn, make_model_fn
from regennet_torch.models.t2m_eval import FOOT_FEATS, load_length_estimator
from regennet_torch.train import checkpoint
from regennet_torch.utils import parser_util
from regennet_torch.utils.fixseed import fixseed
from regennet_torch.utils.model_util import (
    HML_FRAMES,
    TextData,
    create_model_and_diffusion,
    model_dtype,
)


def _prompts(args) -> List[str]:
    if args.input_text:
        with open(args.input_text) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        if not lines:
            raise ValueError(f"no prompts in {args.input_text}")
        return lines
    if not args.text_prompt:
        raise ValueError("pass --text_prompt or --input_text")
    return [args.text_prompt] * args.num_samples


def _word_inputs(prompts, glove_root):
    """The prompts' evaluator-style word inputs through the word vectorizer
    (GloVe when present, the hashed stand-in otherwise): word embeddings
    [N, 22, 300], POS one-hots [N, 22, 15], lengths [N]."""
    from regennet_torch.data.humanml.word_vectorizer import WordVectorizer

    wv = WordVectorizer(glove_root, "our_vab")
    max_len = 20
    word_embs, pos_ohots, lens = [], [], []
    for text in prompts:
        tokens = [f"{w}/OTHER" for w in text.split()][:max_len]
        tokens = ["sos/OTHER"] + tokens + ["eos/OTHER"]
        embs, poss = zip(*(wv[tok] for tok in tokens))
        lens.append(len(tokens))
        pad = (max_len + 2) - len(tokens)
        word_embs.append(np.stack(list(embs) + [np.zeros_like(embs[0])] * pad))
        pos_ohots.append(np.stack(list(poss) + [np.zeros_like(poss[0])] * pad))
    return (np.stack(word_embs).astype(np.float32), np.stack(pos_ohots).astype(np.float32),
            np.asarray(lens, np.int64))


@torch.no_grad()
def estimate_lengths(estimator, prompts, glove_root, T: int, seed: int, unit: int = 4):
    """(logits [N, bins], lengths [N]): lengths are a bin drawn from each
    prompt's logits by torch.Generator(seed), times `unit`, within [unit, T]."""
    device = next(estimator.parameters()).device
    word_embs, pos_ohots, cap_lens = _word_inputs(prompts, glove_root)
    logits = estimator(torch.as_tensor(word_embs, device=device),
                       torch.as_tensor(pos_ohots, device=device), cap_lens)
    probs = torch.softmax(logits.double().cpu(), dim=-1)
    bins = torch.multinomial(probs, 1, generator=torch.Generator().manual_seed(int(seed)))
    lengths = np.clip(bins[:, 0].numpy() * unit, unit, T).astype(np.int64)
    return logits.cpu().numpy(), lengths


def diffusion_features(args, prompts, T: int, generator, device) -> np.ndarray:
    """The diffusion route: features [N, T, F] of the CMDM of args.model_path."""
    args_path = os.path.join(os.path.dirname(args.model_path.rstrip("/")), "args.json")
    with open(args_path) as f:
        margs = Namespace(**json.load(f))
    model, sched, cfg = create_model_and_diffusion(margs, TextData(), device=device)
    checkpoint.load_model(model, args.model_path)
    model = model.to(device=device, dtype=model_dtype(margs)).eval()
    guidance = float(args.guidance_param)
    model_fn = make_cfg_model_fn(model, guidance) if guidance != 1.0 else make_model_fn(model)

    shape = (len(prompts), model.njoints, model.nfeats, HML_FRAMES)
    cond = {
        "cmotion": torch.zeros(shape, device=device),
        "text_emb": torch.as_tensor(encode_text_or_fallback(prompts, device), device=device),
    }
    t0 = time.perf_counter()
    sample = sampling.p_sample_loop(sched, cfg, model_fn, shape, cond, clip_denoised=False,
                                    generator=generator)
    features = sample[:, :, 0, :].transpose(1, 2)[:, :T].cpu().numpy()  # waits for the device
    print(f"Generate time: {(time.perf_counter() - t0) * 1e3:.1f} ms for {len(prompts)} "
          f"sequences ({sched.num_timesteps} steps)", flush=True)
    return features


@torch.no_grad()
def comp_v6_features(args, prompts, T: int, dim_pose: int, generator,
                     device) -> np.ndarray:
    """The comp_v6 route: features [N, T', F] sampled from the prior of the
    generator of args.model_path, T' = T rounded down to whole snippets."""
    gen, mov_enc, unit = load_comp_v6_checkpoint(args.model_path, dim_pose, device)
    T = (T // unit) * unit
    B, mov_len = len(prompts), T // unit
    word_embs, pos_ohots, cap_lens = _word_inputs(prompts, args.glove_root)
    mov_in0 = mov_enc(torch.zeros(B, unit, dim_pose - FOOT_FEATS, device=device))[:, 0]
    t0 = time.perf_counter()
    out = gen.generate(torch.as_tensor(word_embs, device=device),
                       torch.as_tensor(pos_ohots, device=device), cap_lens,
                       np.full(B, T), mov_in0, mov_len,
                       t2m_gen.prior_noise(generator, mov_len, B, gen.dim_z, device),
                       unit_length=unit)
    features = out["fake_motions"].cpu().numpy()  # waits for the device
    print(f"Generate time: {(time.perf_counter() - t0) * 1e3:.1f} ms for {B} sequences "
          f"({mov_len} snippets)", flush=True)
    return features


def main(args=None, device=None) -> dict:
    """Generate, write results.npy and results.txt, and return the results.

    device: "cpu", "cuda:N" or a torch.device; None means cuda:{args.device}
    (or the CPU for --device cpu) and raises without CUDA."""
    if args is None:
        args = parser_util.generate_args()
    device = resolve_device(device, getattr(args, "device", 0))
    pin_f32_contract()
    fixseed(args.seed)
    prompts = _prompts(args)
    estimator = (load_length_estimator(args.length_estimator, device)
                 if args.length_estimator else None)
    B = len(prompts)

    # only the normalisation stats are needed, not the whole dataset
    mean = np.load(os.path.join(args.data_path, "Mean.npy"))
    std = np.load(os.path.join(args.data_path, "Std.npy"))
    joints_num = 22 if args.dataset == "humanml" else 21
    fps = 20 if args.dataset == "humanml" else 12.5  # KIT runs at 12.5 fps
    T = min(int(args.motion_length * fps), HML_FRAMES)

    generator = torch.Generator(device=device).manual_seed(int(args.seed))
    if is_comp_v6(args.model_path):
        features = comp_v6_features(args, prompts, T, int(mean.shape[0]), generator, device)
    else:
        features = diffusion_features(args, prompts, T, generator, device)

    # denormalise and recover the joints
    denorm = features * std + mean
    joints = recover_from_ric(torch.as_tensor(denorm, dtype=torch.float32, device=device),
                              joints_num).cpu().numpy()  # [B, T, J, 3]

    lengths = np.full(B, joints.shape[1])
    if estimator is not None:
        _, lengths = estimate_lengths(estimator, prompts, args.glove_root, joints.shape[1],
                                      args.seed)
        print(f"estimated lengths: {lengths.tolist()}", flush=True)

    out_dir = args.output_dir or os.path.join(
        os.path.dirname(args.model_path.rstrip("/")) or ".", f"samples_seed{args.seed}")
    os.makedirs(out_dir, exist_ok=True)
    result = {"motion": joints, "feature": denorm, "text": prompts,
              "lengths": lengths, "num_samples": B}
    np.save(os.path.join(out_dir, "results.npy"), result, allow_pickle=True)
    with open(os.path.join(out_dir, "results.txt"), "w") as f:
        f.write("\n".join(prompts))
    print(f"wrote {os.path.join(out_dir, 'results.npy')}", flush=True)

    if args.render:
        from regennet_torch.data.humanml.motion_process import (
            KIT_KINEMATIC_CHAIN,
            T2M_KINEMATIC_CHAIN,
        )
        from regennet_torch.render.plot_script import plot_3d_motion

        chain = T2M_KINEMATIC_CHAIN if args.dataset == "humanml" else KIT_KINEMATIC_CHAIN
        for i, text in enumerate(prompts):
            path = plot_3d_motion(os.path.join(out_dir, f"sample{i:02d}.mp4"), chain,
                                  joints[i, : int(lengths[i])], title=text,
                                  dataset=args.dataset, fps=int(fps))
            print(f"rendered {path}", flush=True)
    return result


if __name__ == "__main__":
    main()
