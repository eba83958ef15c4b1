"""Free-text text-to-motion generation: `python -m regennet_torch.sample.generate`
(counterpart of regennet_tpu/sample/generate.py, its diffusion route).

Generates motions for text prompts from an MDM-style diffusion checkpoint
(`train_mdm --dataset humanml` or `kit`): the model is rebuilt from the
args.json beside the .pt, the prompts become CLIP embeddings (or the
hashed stand-in without CLIP weights, `models/clip_text`), DDPM sampling
runs at the 196-frame window with classifier-free guidance folded into one
2B forward (`--guidance_param`), and the RIC features are denormalised
with the dataset's Mean/Std and decoded to joints (`recover_from_ric`).
Writes results.npy (motion [N, T, J, 3], feature [N, T, F], text,
lengths, num_samples) and results.txt, as the JAX CLI does.

Prompts come from --text_prompt (one prompt, repeated --num_samples
times) or --input_text (a file, one prompt per line). With
--length_estimator (train_t2m_eval's length .pt or a released
latest.tar) each prompt's length is drawn from the estimator's logits
over its GloVe word inputs (--glove_root), in bins of 4 frames clipped to
[4, T], by a torch.Generator seeded by --seed (the JAX CLI draws with
jax.random.categorical; the logits agree, the draws do not). Not ported,
and raising: the comp_v6 generator route (a released `.tar`) and
--render.
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
from regennet_torch.device import resolve_device
from regennet_torch.diffusion import sampling
from regennet_torch.models.clip_text import encode_text_or_fallback
from regennet_torch.models.cmdm import make_cfg_model_fn, make_model_fn
from regennet_torch.models.t2m_eval import load_length_estimator
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


def _check_ported(args):
    if args.model_path.endswith(".tar"):
        raise NotImplementedError(
            "the comp_v6 generator route (a .tar checkpoint) needs the t2m stack, "
            "which is not ported (ROADMAP A.8)")
    if args.render:
        raise NotImplementedError("--render is not ported (ROADMAP A.8, render/)")


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


def main(args=None, device=None) -> dict:
    """Generate, write results.npy and results.txt, and return the results.

    device: "cpu", "cuda:N" or a torch.device; None means cuda:{args.device}
    (or the CPU for --device cpu) and raises without CUDA."""
    if args is None:
        args = parser_util.generate_args()
    device = resolve_device(device, getattr(args, "device", 0))
    _check_ported(args)
    # f32 means f32 on the GPU: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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

    args_path = os.path.join(os.path.dirname(args.model_path.rstrip("/")), "args.json")
    with open(args_path) as f:
        margs = Namespace(**json.load(f))
    model, sched, cfg = create_model_and_diffusion(margs, TextData(), device=device)
    checkpoint.load_model(model, args.model_path)
    model = model.to(device=device, dtype=model_dtype(margs)).eval()
    guidance = float(args.guidance_param)
    model_fn = make_cfg_model_fn(model, guidance) if guidance != 1.0 else make_model_fn(model)

    shape = (B, model.njoints, model.nfeats, HML_FRAMES)
    cond = {
        "cmotion": torch.zeros(shape, device=device),
        "text_emb": torch.as_tensor(encode_text_or_fallback(prompts, device), device=device),
    }
    generator = torch.Generator(device=device).manual_seed(int(args.seed))
    t0 = time.perf_counter()
    sample = sampling.p_sample_loop(sched, cfg, model_fn, shape, cond, clip_denoised=False,
                                    generator=generator)
    features = sample[:, :, 0, :].transpose(1, 2)[:, :T].cpu().numpy()  # waits for the device
    print(f"Generate time: {(time.perf_counter() - t0) * 1e3:.1f} ms for {B} sequences "
          f"({sched.num_timesteps} steps)", flush=True)

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
    return result


if __name__ == "__main__":
    main()
