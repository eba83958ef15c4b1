"""HumanML3D / KIT text-to-motion evaluation: `python -m
regennet_torch.eval.eval_humanml` (counterpart of
regennet_tpu/eval/eval_humanml.py, its diffusion route; reference:
eval/eval_humanml.py).

Matching score, R-precision (top 3), FID, diversity and, in mm_short,
per-prompt multimodality of motions sampled from an MDM-style text CMDM,
under the frozen T2M co-embedding evaluators (models/t2m_eval.py: a
released finest.tar, the port's matching .pt from train_t2m_eval, or
random ones from --seed), over several replications with mean +- 95%
intervals. Sampling is DDPM with clip_denoised=False, a zero cmotion and
CLIP text embeddings (the hashed stand-in without CLIP weights), classifier-
free guidance in one 2B forward when --guidance_param is not 1; each batch
draws its noise from one generator seeded by --seed. Items draw from
`random` and numpy's ambient stream, and diversity and multimodality
from numpy's, in the JAX harness's order.

Protocols (--eval_mode), at batch 32: debug 32 samples, 2 replications;
wo_mm and full 1000 samples, 20 replications; mm_short 1000 samples, 5
replications and multimodality over 100 prompts x 30 repeats. Outside
debug the GloVe archive must be present (REGENNET_ALLOW_HASHED_GLOVE=1
overrides). The log goes to eval_humanml_<run>_<mode>.log beside the
checkpoint.

The comp_v6 route (a released CompTrainerV6 `.tar`, or train_t2m_gen's
`.pt`, which holds the generator's networks) samples each caption's
motion from the generator's prior instead (the reference's
comp_v6_model_dataset): sizes from the args.json beside the checkpoint,
else the release's opt.txt, else the published ones. With
--length_estimator each prompt's length is drawn from the estimator's
softmax as the JAX harness draws it (np.random.default_rng(seed * 7919 +
call), up to 3 draws below the minimum length of 10 snippets, 6 for kit)
and the motion is zeroed past it; without one the ground-truth lengths
are used (said on stderr). The prior's noise comes from
torch.Generator(seed) (t2m_gen.prior_noise).
"""

from __future__ import annotations

import functools
import os
import sys
from collections import OrderedDict
from typing import Callable, Dict, List

import numpy as np
import torch

from regennet_torch.eval import humanml_metrics as M
from regennet_torch.models.t2m_eval import FOOT_FEATS, T2MEvaluatorWrapper

# (num_samples, replications, multimodality: (prompts, repeats, times) or None)
PROTOCOLS = {"debug": (32, 2, None), "wo_mm": (1000, 20, None), "full": (1000, 20, None),
             "mm_short": (1000, 5, (100, 30, 10))}


def _log(file, line):
    print(line)
    if file is not None:
        print(line, file=file, flush=True)


def evaluate_matching_score(eval_wrapper, motion_loaders, file=None):
    match_score_dict = OrderedDict()
    R_precision_dict = OrderedDict()
    activation_dict = OrderedDict()
    for name, loader in motion_loaders.items():
        all_motion_embeddings = []
        matching_score_sum, top_k_count, all_size = 0.0, np.zeros(3), 0
        for batch in loader:
            word_embs, pos_ohot, _, sent_lens, motions, m_lens, _ = batch
            text_emb, motion_emb = eval_wrapper.get_co_embeddings(
                word_embs, pos_ohot, sent_lens, motions, m_lens)
            dist_mat = M.euclidean_distance_matrix(text_emb, motion_emb)
            matching_score_sum += dist_mat.trace()
            top_k_count = top_k_count + M.calculate_top_k(
                np.argsort(dist_mat, axis=1), 3).sum(axis=0)
            all_size += text_emb.shape[0]
            all_motion_embeddings.append(motion_emb)
        matching_score = matching_score_sum / max(all_size, 1)
        R_precision = top_k_count / max(all_size, 1)
        match_score_dict[name] = matching_score
        R_precision_dict[name] = R_precision
        activation_dict[name] = np.concatenate(all_motion_embeddings, axis=0)
        _log(file, f"---> [{name}] Matching Score: {matching_score:.4f}")
        _log(file, f"---> [{name}] R_precision: "
             + " ".join(f"(top {i + 1}): {R_precision[i]:.4f}" for i in range(3)))
    return match_score_dict, R_precision_dict, activation_dict


def evaluate_fid(eval_wrapper, groundtruth_loader, activation_dict, file=None):
    gt_embeddings = np.concatenate([
        eval_wrapper.get_motion_embeddings(batch[4], batch[5]) for batch in groundtruth_loader])
    gt_mu, gt_cov = M.calculate_activation_statistics(gt_embeddings)
    eval_dict = OrderedDict()
    for name, embeddings in activation_dict.items():
        mu, cov = M.calculate_activation_statistics(embeddings)
        eval_dict[name] = M.calculate_frechet_distance(gt_mu, gt_cov, mu, cov)
        _log(file, f"---> [{name}] FID: {eval_dict[name]:.4f}")
    return eval_dict


def evaluate_diversity(activation_dict, file=None, diversity_times=300):
    eval_dict = OrderedDict()
    for name, embeddings in activation_dict.items():
        eval_dict[name] = M.calculate_diversity(embeddings,
                                                min(diversity_times, len(embeddings)))
        _log(file, f"---> [{name}] Diversity: {eval_dict[name]:.4f}")
    return eval_dict


def evaluate_multimodality(eval_wrapper, mm_motion_loaders, file=None, mm_num_times=10):
    eval_dict = OrderedDict()
    for name, mm_loader in mm_motion_loaders.items():
        # one [num_repeats, D] stack of embeddings per prompt
        mm_embeddings = [eval_wrapper.get_motion_embeddings(motions, m_lens)
                         for motions, m_lens in mm_loader]
        if not mm_embeddings:
            eval_dict[name] = 0.0
            continue
        stacked = np.stack(mm_embeddings)  # [num_prompts, num_repeats, D]
        eval_dict[name] = M.calculate_multimodality(stacked,
                                                    min(mm_num_times, stacked.shape[1]))
        _log(file, f"---> [{name}] Multimodality: {eval_dict[name]:.4f}")
    return eval_dict


def _full_batches(n: int, bs: int, what: str):
    """Full-batch starts over n items; the tail is dropped, as the
    reference's DataLoader(drop_last=True) drops it, because R-precision
    ranks each prompt against its own batch of 32. The dropped share is
    said on stderr."""
    dropped = n % bs
    if dropped:
        print(f"[eval_humanml] {what}: evaluating {n - dropped}/{n} samples (tail of "
              f"{dropped} dropped to keep full batches of {bs}, reference drop_last parity)",
              file=sys.stderr)
    return range(0, n - bs + 1, bs)


def _stack_items(items):
    cols = list(zip(*items))
    return (np.stack(cols[0]), np.stack(cols[1]), list(cols[2]),
            np.asarray(cols[3], dtype=np.int64), np.stack(cols[4]),
            np.asarray(cols[5], dtype=np.int64), list(cols[6]))


def _sizes(dataset, batch_size: int, num_samples: int):
    n = len(dataset) if num_samples == -1 else min(num_samples, len(dataset))
    bs = min(batch_size, n)
    if bs == 0:
        raise ValueError("evaluation dataset is empty")
    return n, bs


def make_gt_loader_factory(dataset, batch_size: int, num_samples: int = -1):
    """Fresh ground-truth 7-tuple batches per replication."""

    def factory():
        n, bs = _sizes(dataset, batch_size, num_samples)
        return [_stack_items([dataset[i] for i in range(start, start + bs)])
                for start in _full_batches(n, bs, "gt")]

    return factory


def make_gen_loader_factory(dataset, model, sched, cfg, batch_size: int,
                            num_samples: int = -1, guidance: float = 1.0, seed: int = 0,
                            text_encoder: Callable = None, mm_num_samples: int = 0,
                            mm_num_repeats: int = 0):
    """Sample motions for the dataset's prompts with `model` on the
    schedule's device and pack them into the evaluator's 7-tuple batches
    (the reference's get_mdm_loader), in the dataset's normalised feature
    space. With mm_num_samples > 0 the factory returns (batches, mm_list):
    for each of mm_num_samples prompts, chosen afresh per call by
    np.random.default_rng(seed + call), its mm_num_repeats motions
    [repeats, T, F] and lengths, sampled as one batch."""
    from regennet_torch.diffusion import sampling
    from regennet_torch.models.clip_text import encode_text_or_fallback
    from regennet_torch.models.cmdm import make_cfg_model_fn, make_model_fn

    device = sched.device
    if text_encoder is None:
        # as in training: CLIP when its weights are present, else the stand-in
        text_encoder = functools.partial(encode_text_or_fallback, device=device)
    model_fn = make_cfg_model_fn(model, guidance) if guidance != 1.0 else make_model_fn(model)
    generator = torch.Generator(device=device).manual_seed(int(seed))
    calls = {"mm": 0}

    def sample_batch(captions, bs, T):
        shape = (bs, model.njoints, model.nfeats, T)
        cond = {"cmotion": torch.zeros(shape, device=device),
                "text_emb": torch.as_tensor(text_encoder(list(captions)), device=device)}
        sample = sampling.p_sample_loop(sched, cfg, model_fn, shape, cond,
                                        clip_denoised=False, generator=generator)
        return sample[:, :, 0, :].transpose(1, 2).float().cpu().numpy()

    def factory():
        n, bs = _sizes(dataset, batch_size, num_samples)
        batches = []
        for start in _full_batches(n, bs, "gen"):
            (word_embs, pos_ohot, captions, sent_lens, motions, m_lens,
             tokens) = _stack_items([dataset[i] for i in range(start, start + bs)])
            batches.append((word_embs, pos_ohot, captions, sent_lens,
                            sample_batch(captions, bs, motions.shape[1]), m_lens, tokens))
        if mm_num_samples <= 0:
            return batches
        calls["mm"] += 1
        mm_rng = np.random.default_rng(seed + calls["mm"])
        mm_idxs = mm_rng.choice(len(dataset), min(mm_num_samples, len(dataset)),
                                replace=False)
        mm_list = []
        for idx in np.sort(mm_idxs):
            _, _, captions, _, motions, m_lens, _ = _stack_items(
                [dataset[int(idx)]] * mm_num_repeats)
            mm_list.append((sample_batch(captions, mm_num_repeats, motions.shape[1]),
                            m_lens))
        return batches, mm_list

    return factory


def make_comp_gen_loader_factory(dataset, gen, mov_enc, batch_size: int,
                                 num_samples: int = -1, seed: int = 0, unit_length: int = 4,
                                 mm_num_samples: int = 0, mm_num_repeats: int = 0,
                                 len_estimator=None, min_mov_length: int = 10):
    """Sample each caption's motion from the comp_v6 generator's prior (on
    its device) and pack them into the evaluator's 7-tuple batches; with
    mm_num_samples > 0 the factory returns (batches, mm_list), the repeats
    of each prompt sampled as one batch (see make_gen_loader_factory).

    With a trained length estimator each prompt's length (in frames, a
    multiple of unit_length within [unit_length, T]) is drawn from its
    softmax, up to 3 draws while below min_mov_length snippets (the last
    kept), by np.random.default_rng(seed * 7919 + call_idx) over the
    float64-renormalised probabilities, and the motion is zeroed past it;
    those lengths go into the batch. Without one the ground-truth lengths
    are used."""
    from regennet_torch.models import t2m_gen

    device = next(gen.parameters()).device
    generator = torch.Generator(device=device).manual_seed(int(seed))
    calls = {"call": 0, "mm": 0}

    @torch.no_grad()
    def sample_m_lens(word_embs, pos_ohot, sent_lens, T, call_idx):
        logits = len_estimator(torch.as_tensor(word_embs, device=device),
                               torch.as_tensor(pos_ohot, device=device), sent_lens)
        probs = torch.softmax(logits, dim=-1).cpu().numpy().astype(np.float64)
        probs = probs / probs.sum(-1, keepdims=True)
        est_rng = np.random.default_rng(seed * 7919 + call_idx)
        lens = np.empty(probs.shape[0], dtype=np.int64)
        for i in range(probs.shape[0]):
            for _ in range(3):
                mov_length = est_rng.choice(probs.shape[1], p=probs[i])
                if mov_length >= min_mov_length:
                    break
            lens[i] = mov_length * unit_length
        return np.clip(lens, unit_length, T)

    @torch.no_grad()
    def sample_batch(word_embs, pos_ohot, sent_lens, m_lens, motions):
        """The prior's motions [B, T, F] for the captions, T and F motions'."""
        B, T, nfeats = motions.shape
        mov_len = T // unit_length
        mov_in0 = mov_enc(torch.zeros(B, unit_length, nfeats - FOOT_FEATS, device=device))[:, 0]
        out = gen.generate(torch.as_tensor(word_embs, device=device),
                           torch.as_tensor(pos_ohot, device=device), sent_lens, m_lens,
                           mov_in0, mov_len,
                           t2m_gen.prior_noise(generator, mov_len, B, gen.dim_z, device),
                           unit_length=unit_length)
        fake = out["fake_motions"].cpu().numpy()
        if len_estimator is not None:  # zeroed past each sampled length
            fake = np.where(np.arange(fake.shape[1])[None, :, None] < m_lens[:, None, None],
                            fake, 0.0)
        return fake.astype(np.float32)

    def factory():
        n, bs = _sizes(dataset, batch_size, num_samples)
        calls["call"] += 1
        if len_estimator is None:
            print("[eval_humanml] comp_gen: no --length_estimator given; evaluating at "
                  "ground-truth lengths (published protocol samples lengths from the "
                  "trained estimator)", file=sys.stderr)
        batches = []
        for start in _full_batches(n, bs, "comp_gen"):
            (word_embs, pos_ohot, captions, sent_lens, motions, m_lens,
             tokens) = _stack_items([dataset[i] for i in range(start, start + bs)])
            if len_estimator is not None:
                m_lens = sample_m_lens(word_embs, pos_ohot, sent_lens, motions.shape[1],
                                       calls["call"] * 100003 + start)
            batches.append((word_embs, pos_ohot, captions, sent_lens,
                            sample_batch(word_embs, pos_ohot, sent_lens, m_lens, motions),
                            m_lens, tokens))
        if mm_num_samples <= 0:
            return batches
        calls["mm"] += 1
        mm_rng = np.random.default_rng(seed + calls["mm"])
        mm_idxs = mm_rng.choice(len(dataset), min(mm_num_samples, len(dataset)),
                                replace=False)
        mm_list = []
        for idx in np.sort(mm_idxs):
            word_embs, pos_ohot, _, sent_lens, motions, m_lens, _ = _stack_items(
                [dataset[int(idx)]] * mm_num_repeats)
            if len_estimator is not None:  # each repeat draws its own length
                m_lens = sample_m_lens(word_embs, pos_ohot, sent_lens, motions.shape[1],
                                       calls["call"] * 100003 + 50021 + int(idx))
            mm_list.append((sample_batch(word_embs, pos_ohot, sent_lens, m_lens, motions),
                            m_lens))
        return batches, mm_list

    return factory


def is_comp_v6(model_path: str) -> bool:
    """A comp_v6 checkpoint: a released .tar, or a file holding the
    generator's networks (train_t2m_gen's .pt)."""
    if model_path.endswith(".tar"):
        return True
    state = torch.load(model_path, map_location="cpu", weights_only=True)
    return isinstance(state, dict) and "seq_pri" in state


def rebuild_comp_v6_generator(model_path: str, dim_pose: int):
    """(generator, movement encoder, unit_length) for a comp_v6 checkpoint,
    untrained: sizes from the args.json beside it (train_t2m_gen's), else
    from the release's opt.txt (data/humanml/get_opt), else the published
    ones; the movement encoder at T2M_OPT's widths."""
    import json

    from regennet_torch.data.humanml.get_opt import (
        comp_v6_sizes_from_opt,
        find_opt_file,
        parse_opt_file,
    )
    from regennet_torch.models import t2m_eval, t2m_gen

    args_path = os.path.join(os.path.dirname(model_path.rstrip("/")), "args.json")
    sizes = {}
    if os.path.exists(args_path):
        with open(args_path) as f:
            sizes = json.load(f)
    else:
        opt_path = find_opt_file(model_path)
        if opt_path:
            sizes = comp_v6_sizes_from_opt(parse_opt_file(opt_path))
    opt = t2m_eval.T2M_OPT
    gen = t2m_gen.CompV6Generator(
        dim_pose=dim_pose, dim_word=opt["dim_word"], dim_pos_ohot=opt["dim_pos_ohot"],
        **{k: int(sizes.get(k, default)) for k, default in (
            ("dim_z", 128), ("pri_hidden", 1024), ("dec_hidden", 1024), ("text_hidden", 512),
            ("att_vec", 512), ("n_layers", 1), ("mov_latent", 512))})
    (mov_enc,) = t2m_eval.networks(dim_pose, "movement_enc")
    return gen, mov_enc, int(sizes.get("unit_length", 4))


def load_comp_v6_checkpoint(model_path: str, dim_pose: int, device):
    """rebuild_comp_v6_generator's networks with the checkpoint's weights
    (a released latest.tar or train_t2m_gen's .pt), in eval mode on
    `device`: (generator, movement encoder, unit_length)."""
    from regennet_torch.models import t2m_eval, t2m_gen

    gen, mov_enc, unit = rebuild_comp_v6_generator(model_path, dim_pose)
    t2m_gen.load_comp_v6(gen, mov_enc, t2m_eval.load_torch_file(model_path))
    return gen.to(device).eval(), mov_enc.to(device).eval(), unit


def _comp_gen_factory(args, dataset, device, mm_num_samples: int = 0,
                      mm_num_repeats: int = 0):
    from regennet_torch.models.t2m_eval import load_length_estimator

    gen, mov_enc, unit = load_comp_v6_checkpoint(args.model_path, dataset[0][4].shape[-1],
                                                 device)
    estimator = (load_length_estimator(args.length_estimator, device)
                 if getattr(args, "length_estimator", "") else None)
    return make_comp_gen_loader_factory(
        dataset, gen, mov_enc, args.batch_size, args.num_samples, seed=args.seed,
        unit_length=unit, mm_num_samples=mm_num_samples, mm_num_repeats=mm_num_repeats,
        len_estimator=estimator,
        # the reference's minimum: 10 snippets for t2m, 6 for kit
        min_mov_length=10 if args.dataset in ("humanml", "t2m") else 6)


def evaluation(eval_wrapper: T2MEvaluatorWrapper, gt_loader_factory: Callable[[], List],
               eval_motion_loaders: Dict[str, Callable[[], List]], log_file: str,
               replication_times: int = 3, diversity_times: int = 300,
               mm_num_times: int = 0, run_mm: bool = False) -> Dict:
    """The replication loop, its lines written to log_file, and the summary
    {"<metric>_<loader>": mean} with mean +- 1.96 std / sqrt(n) logged.
    Loader factories return lists of 7-tuple batches, sampled afresh each
    replication (generated ones may return (batches, mm_list))."""
    all_metrics = OrderedDict((k, OrderedDict()) for k in (
        "Matching Score", "R_precision", "FID", "Diversity", "MultiModality"))
    with open(log_file, "w") as f:
        for rep in range(replication_times):
            _log(f, f"==================== Replication {rep} ====================")
            gt_batches = gt_loader_factory()
            motion_loaders = {"ground truth": gt_batches}
            mm_loaders = {}
            for name, factory in eval_motion_loaders.items():
                result = factory()
                motion_loaders[name], mm_loaders[name] = (
                    result if isinstance(result, tuple) else (result, []))
            mat_dict, r_dict, act_dict = evaluate_matching_score(eval_wrapper,
                                                                 motion_loaders, f)
            fid_dict = evaluate_fid(eval_wrapper, gt_batches, act_dict, f)
            div_dict = evaluate_diversity(act_dict, f, diversity_times)
            mm_dict = (evaluate_multimodality(eval_wrapper, mm_loaders, f, mm_num_times)
                       if run_mm else {})
            for store, values in (("Matching Score", mat_dict), ("R_precision", r_dict),
                                  ("FID", fid_dict), ("Diversity", div_dict),
                                  ("MultiModality", mm_dict)):
                for name, v in values.items():
                    all_metrics[store].setdefault(name, []).append(v)

        mean_dict = {}
        for metric_name, store in all_metrics.items():
            for model_name, values in store.items():
                arr = np.asarray(values, dtype=np.float64)
                mean = arr.mean(axis=0)
                conf = (1.96 * arr.std(axis=0) / np.sqrt(len(arr)) if len(arr) > 1
                        else np.zeros_like(mean))
                key = f"{metric_name}_{model_name}"
                mean_dict[key] = mean.tolist() if np.ndim(mean) else float(mean)
                _log(f, f"========== {key}: {mean} ± {conf} ==========")
    return mean_dict


def load_t2m_wrapper(dataset_name: str, rec_model_path: str, seed: int, device):
    """The evaluators of rec_model_path (a released finest.tar or the port's
    matching .pt), or with '' or 'random' random ones from `seed`."""
    if rec_model_path and rec_model_path != "random":
        return T2MEvaluatorWrapper(dataset_name, state=rec_model_path, device=device)
    print("eval_humanml: using randomly initialised T2M evaluators (pass --rec_model_path "
          "finest.tar for published-comparable numbers)")
    return T2MEvaluatorWrapper(dataset_name, device=device, seed=seed)


def main(args=None, device=None) -> Dict:
    """Evaluate args.model_path under args.eval_mode's protocol, write the
    log and return the summary.

    device: "cpu", "cuda:N" or a torch.device; None means cuda:{args.device}
    (or the CPU for --device cpu) and raises without CUDA."""
    from regennet_torch.data.humanml.dataset import Text2MotionDataset
    from regennet_torch.device import resolve_device
    from regennet_torch.train import checkpoint
    from regennet_torch.utils import parser_util
    from regennet_torch.utils.fixseed import fixseed
    from regennet_torch.utils.model_util import (
        TextData,
        create_model_and_diffusion,
        model_dtype,
    )

    if args is None:
        args = parser_util.evaluation_parser()
    device = resolve_device(device, getattr(args, "device", 0))
    # f32 means f32 on the GPU: no TF32 in matmuls, convolutions or cuDNN's GRU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fixseed(args.seed)
    if args.eval_mode not in PROTOCOLS:
        raise ValueError(f"unknown eval mode {args.eval_mode}")
    args.batch_size = 32
    args.num_samples, replication_times, mm = PROTOCOLS[args.eval_mode]
    if args.eval_mode == "full":
        print("eval_humanml: 'full' runs the wo_mm protocol (MultiModality needs "
              "--eval_mode mm_short)", flush=True)
    mm_num_samples, mm_num_repeats, mm_num_times = mm or (0, 0, 0)

    # the published protocols must not hash words in place of GloVe
    strict_glove = args.eval_mode != "debug" and os.environ.get(
        "REGENNET_ALLOW_HASHED_GLOVE", "") != "1"
    dataset = Text2MotionDataset(args.data_path, split="test", dataset_name=args.dataset,
                                 strict_glove=strict_glove)
    if is_comp_v6(args.model_path):
        gen_factory = _comp_gen_factory(args, dataset, device, mm_num_samples, mm_num_repeats)
    else:
        model, sched, cfg = create_model_and_diffusion(args, TextData(), device=device)
        checkpoint.load_model(model, args.model_path)
        model = model.to(device=device, dtype=model_dtype(args)).eval()
        gen_factory = make_gen_loader_factory(
            dataset, model, sched, cfg, args.batch_size, args.num_samples,
            guidance=float(getattr(args, "guidance_param", 1.0)), seed=args.seed,
            mm_num_samples=mm_num_samples, mm_num_repeats=mm_num_repeats)
    eval_wrapper = load_t2m_wrapper(args.dataset, args.rec_model_path, args.seed, device)
    gt_factory = make_gt_loader_factory(dataset, args.batch_size, args.num_samples)
    name = os.path.basename(os.path.dirname(args.model_path)) or "model"
    log_file = os.path.join(os.path.dirname(args.model_path) or ".",
                            f"eval_humanml_{name}_{args.eval_mode}.log")
    return evaluation(eval_wrapper, gt_factory, {name: gen_factory}, log_file,
                      replication_times=replication_times, run_mm=mm is not None,
                      mm_num_times=mm_num_times)


if __name__ == "__main__":
    main()
