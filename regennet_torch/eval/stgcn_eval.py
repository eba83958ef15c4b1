"""ST-GCN evaluation of the CMDM (counterpart of
regennet_tpu/eval/stgcn_eval.py).

Per seed: reshuffle the data, build ground-truth batches and generated
batches (full diffusion sampling per batch on the sampler's device),
concatenate actor and reactor into the two-person representation, run
the frozen ST-GCN and compute accuracy, FID, diversity and multimodality
for the train and test splits. The auto-regressive online protocol runs
one full sampling pass per revealed condition frame.

The host-side random streams (`random` for the shuffles and frame
windows, numpy's for the metrics) are consumed in the JAX package's
order, so the same seeds select the same batches and metric draws. The
sampling noise cannot be the JAX package's: each (seed-stacked) batch
draws it from a torch.Generator on the sampler's device, seeded from
(the chunk's first seed, the batch index, the split index).

Under a process group of more than one data rank (the JAX package shards
each sampling batch over its devices), each rank samples its rows of the
batch from the whole batch's noise, the ranks gather the rows, and rank 0
computes the metrics: they are those of one process. The other ranks
return no metrics.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from regennet_torch.data.collate import ccollate, collate
from regennet_torch.data.get_data import BatchLoader
from regennet_torch.diffusion import sampling
from regennet_torch.eval import metrics as M
from regennet_torch.models.stgcn import STGCN
from regennet_torch.parallel import mesh
from regennet_torch.train import checkpoint
from regennet_torch.utils.fixseed import fixseed


class STGCNEvaluator:
    """The frozen classifier on a device: batch {"output": [N, V, C, T]
    numpy} -> {"features", "yhat"} numpy."""

    def __init__(self, dataname: str, body_model: str, num_classes: int,
                 nfeats: int, num_person: int, state_dict: Dict[str, Any],
                 channels=None, strides=None, device="cpu"):
        """state_dict: the reference recognition classifier's layout.
        channels/strides override the 10-block default (the reduced
        evaluators of the CPU tests)."""
        self.num_classes = num_classes
        size_kw = {}
        if channels is not None:
            size_kw = dict(channels=tuple(channels), strides=tuple(strides))
        model = STGCN(in_channels=nfeats, num_class=num_classes, num_person=num_person,
                      layout=body_model, **size_kw)
        checkpoint.load_classifier_state(model, state_dict)
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()

    @torch.no_grad()
    def __call__(self, batch: Dict[str, Any]) -> Dict[str, np.ndarray]:
        x = torch.as_tensor(np.asarray(batch["output"]), dtype=torch.float32,
                            device=self.device)
        out = self.model(x)
        return {"features": out["features"].cpu().numpy(),
                "yhat": out["yhat"].cpu().numpy()}


def collect_gen_conds(dataiterator, num_samples: int,
                      keep_motion: bool = False) -> List[Dict]:
    """The host-side conditioning of every generated batch, collected
    before sampling so that several seeds' batches can be stacked into one
    sampling call. keep_motion also keeps the loader's reactor motion,
    which the oracle route puts in place of the sampler's output."""
    entries = []
    for motions, model_kwargs in dataiterator:
        if num_samples != -1 and len(entries) * dataiterator.batch_size > num_samples:
            continue  # keep consuming, like the reference
        y = model_kwargs["y"]
        cond = {"mask": np.asarray(y["mask"])}
        if "cmotion" in y:
            cond["cmotion"] = np.asarray(y["cmotion"])
        else:
            # single-person collate: the denoiser still takes a zero actor
            cond["cmotion"] = np.zeros(np.asarray(motions).shape, dtype=np.float32)
        if "action" in y:
            cond["action"] = np.asarray(y["action"])
        entry = {
            "cond": cond,
            "shape": tuple(np.asarray(motions).shape),
            "lengths": np.asarray(y["lengths"]),
            "y": np.asarray(y["action"])[:, 0],
            "text": y.get("action_text"),
        }
        if keep_motion:
            entry["motion"] = np.asarray(motions)
        entries.append(entry)
    return entries


def _sample_output(sample_fn, generator, cond_np: Dict[str, np.ndarray], shape,
                   setting: str, auto_regressive: bool, device) -> np.ndarray:
    """Sample one (possibly seed-stacked) batch: sample_fn(generator, cond,
    shape) -> [B, V, C, T] on `device`. For the cmdm setting the actor is
    concatenated before the reactor on the channel axis. The
    auto-regressive protocol reveals the actor one frame at a time and
    keeps frame f of the pass that saw frames [0, f]."""
    cond = {k: torch.tensor(v, device=device) for k, v in cond_np.items()}
    if not auto_regressive:
        sample = sample_fn(generator, cond, shape).cpu().numpy()
        if setting == "cmdm":
            return np.concatenate([cond_np["cmotion"], sample], axis=2)
        return sample
    cmotion_bak = cond_np["cmotion"]
    T = cmotion_bak.shape[-1]
    V, C = cmotion_bak.shape[1], cmotion_bak.shape[2]
    revealed = np.zeros_like(cmotion_bak)
    output = np.zeros(
        (cmotion_bak.shape[0], V, C * 2 if setting == "cmdm" else C, T),
        dtype=np.float32,
    )
    for frame_idx in range(T):
        revealed[:, :, :, frame_idx] = cmotion_bak[:, :, :, frame_idx]
        cond_ar = dict(cond, cmotion=torch.tensor(revealed, device=device))
        sample = sample_fn(generator, cond_ar, shape).cpu().numpy()
        tmp = np.concatenate([revealed, sample], axis=2) if setting == "cmdm" else sample
        output[:, :, :, frame_idx] = tmp[:, :, :, frame_idx]
    return output


def build_generated_batches(sample_fn, generator, dataiterator, num_samples: int,
                            setting: str, auto_regressive: bool = False,
                            device="cpu") -> List[Dict]:
    """Full diffusion sampling for every batch of the loader, the batches
    drawing their noise from `generator` one after another."""
    batches = []
    for entry in collect_gen_conds(dataiterator, num_samples):
        output = _sample_output(sample_fn, generator, entry["cond"], entry["shape"],
                                setting, auto_regressive, device)
        batches.append({"output": output, "lengths": entry["lengths"],
                        "y": entry["y"], "text": entry["text"]})
    _trim_last_batch(batches, num_samples, dataiterator.batch_size)
    return batches


def build_gt_batches(dataiterator, num_samples: int) -> List[Dict]:
    batches = []
    for motions, model_kwargs in dataiterator:
        if num_samples != -1 and len(batches) * dataiterator.batch_size > num_samples:
            continue
        y = model_kwargs["y"]
        batches.append({
            "output": np.asarray(motions),
            "lengths": np.asarray(y["lengths"]),
            "y": np.asarray(y["action"])[:, 0],
        })
    _trim_last_batch(batches, num_samples, dataiterator.batch_size)
    return batches


def _trim_last_batch(batches, num_samples, batch_size):
    if not batches or num_samples <= 0:
        return
    rem = num_samples % batch_size
    if rem > 0:
        for k, v in batches[-1].items():
            if v is not None and hasattr(v, "__getitem__"):
                batches[-1][k] = v[:rem]


def compute_features(evaluator: STGCNEvaluator, batches: List[Dict]):
    feats, labels, logits = [], [], []
    for batch in batches:
        out = evaluator(batch)
        feats.append(out["features"])
        logits.append(out["yhat"])
        labels.append(batch["y"])
    return np.concatenate(feats, 0), np.concatenate(labels, 0), np.concatenate(logits, 0)


def evaluate_seed_metrics(evaluator: STGCNEvaluator,
                          loaders: Dict[str, Dict[str, List[Dict]]],
                          acc_only: bool = False, seed: Optional[int] = None,
                          actor_quirks: bool = False) -> Dict[str, float]:
    """accuracy / FID / diversity / multimodality for {gen, gt} x {train,
    test}; seed=None lets the diversity draws consume the ambient numpy
    stream."""
    metrics_all = {}
    for sets in ["train", "test"]:
        computed = {}
        metrics: Dict[str, float] = {}
        for key, loader_sets in loaders.items():
            feats, labels, logits = compute_features(evaluator, loader_sets[sets])
            acc, _ = M.calculate_accuracy(logits, labels, evaluator.num_classes)
            metrics[f"accuracy_{key}"] = acc
            if not acc_only:
                stats = M.calculate_activation_statistics(feats)
                computed[key] = {"feats": feats, "labels": labels, "stats": stats}
                div, mult = M.calculate_diversity_multimodality(
                    feats, labels, evaluator.num_classes, seed=seed,
                    actor_quirks=actor_quirks,
                )
                metrics[f"diversity_{key}"] = div
                metrics[f"multimodality_{key}"] = mult
        if not acc_only:
            gtstats = computed["gt"]["stats"]
            for key in computed:
                metrics[f"fid_{key}"] = float(M.calculate_fid(gtstats, computed[key]["stats"]))
        metrics_all[sets] = metrics

    out = {}
    for sets in ["train", "test"]:
        for key, val in metrics_all[sets].items():
            out[f"{key}_{sets}"] = val
    return out


def _resolve_seed_batch(args, bs: int) -> int:
    """How many evaluation seeds to stack into one sampling batch:
    --eval_seed_batch, else 128 // batch size (1 stacks nothing). Rows are
    independent through the sampler, so stacking changes only which noise
    each row draws."""
    explicit = getattr(args, "eval_seed_batch", 0) or 0
    if explicit:
        return max(1, int(explicit))
    return max(1, 128 // max(1, bs))


def batch_generator(first_seed: int, batch_index: int, split_index: int,
                    device) -> torch.Generator:
    """The sampling noise source of one (seed-stacked) batch."""
    seed = np.random.SeedSequence([first_seed, batch_index, split_index]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(seed))


def row_range(batch: int, rank: int, size: int):
    """[start, stop) of a rank's rows when `batch` rows split over `size`
    ranks as evenly as they go, the first ranks taking one more."""
    base, extra = divmod(batch, size)
    start = rank * base + min(rank, extra)
    return start, start + base + (rank < extra)


def sharded_sampler(sample_fn, layout: Optional[mesh.Layout] = None):
    """sample_fn(generator, cond, shape, rows=None) run on this data
    rank's rows of every batch, the rows gathered from every rank: the
    whole batch, on each rank. The sampler itself without a process group
    of more than one data rank."""
    rank, size = mesh.process_shard_info(layout)
    if size == 1:
        return sample_fn
    group = None if layout is None else layout.data_group

    def fn(generator, cond, shape):
        start, stop = row_range(shape[0], rank, size)
        local = {k: v[start:stop] if torch.is_tensor(v) and v.dim() and v.shape[0] == shape[0]
                 else v for k, v in cond.items()}
        out = sample_fn(generator, local, (stop - start,) + tuple(shape[1:]),
                        rows=(start, shape[0]))
        parts = mesh.gather_objects(out.cpu(), group)
        return torch.cat(parts).to(out.device)

    return fn


def evaluate(args, model_fn_builder, sched, cfg, data, evaluator: STGCNEvaluator,
             setting: str = "cmdm", acc_only: bool = False,
             auto_regressive: bool = False, oracle: bool = False,
             layout: Optional[mesh.Layout] = None) -> Dict:
    """The multi-seed evaluation loop (args: batch_size, num_samples,
    num_seeds, and optionally eval_seed_batch and seed_start).

    `model_fn_builder()` returns the diffusion ModelFn (CFG folded in if
    asked for); sampling runs on the schedule's device. Seeds [seed_start,
    seed_start + num_seeds) are evaluated, `seed_batch` at a time: their
    same-index batches are stacked into one sampling call.

    oracle=True puts the loader's ground-truth reactor motion in place of
    the sampler's output, through the same generated-side pipeline: an
    upper bound on what any model can score under this protocol.

    layout: the training run's ranks (its "data" group shares the rows);
    by default every rank of an initialised process group. Rank 0 returns
    the metrics, the others {"feats": {}}."""
    bs = args.batch_size
    device = sched.device
    model_fn = None if oracle else model_fn_builder()

    def sample_one(generator, cond, shape, rows=None):
        return sampling.p_sample_loop(sched, cfg, model_fn, shape, cond,
                                      clip_denoised=False, generator=generator, rows=rows)

    sample_fn = sharded_sampler(sample_one, layout)
    is_main = mesh.global_rank() == 0

    data_types = ["train", "test"]
    datasets = {k: copy.deepcopy(data) for k in data_types}
    for k in data_types:
        datasets[k].split = k

    seed_batch = min(_resolve_seed_batch(args, bs), args.num_seeds)
    stgcn_metrics = {}
    seed0 = int(getattr(args, "seed_start", 0) or 0)
    seeds = list(range(seed0, seed0 + args.num_seeds))
    for c0 in range(0, len(seeds), seed_batch):
        chunk = seeds[c0: c0 + seed_batch]
        # host: each seed's reshuffle and batches, consuming the seeded
        # `random` stream in the reference's order (both splits shuffled,
        # then gt train / test, then gen train / test: the frame windows
        # drawn while iterating advance the same stream)
        gt_batches: Dict[int, Dict[str, List[Dict]]] = {}
        gen_entries: Dict[int, Dict[str, List[Dict]]] = {}
        for seed in chunk:
            print(f"Evaluation number: {seed + 1}/{args.num_seeds}")
            fixseed(seed)
            gt_batches[seed] = {}
            gen_entries[seed] = {}
            for key in data_types:
                datasets[key].reset_shuffle()
                datasets[key].shuffle()
            for key in data_types:
                gt_iter = BatchLoader(datasets[key], bs, collate, shuffle=False,
                                      drop_last=True)
                gt_batches[seed][key] = build_gt_batches(gt_iter, args.num_samples)
            for key in data_types:
                gen_iter = BatchLoader(datasets[key], bs,
                                       ccollate if setting == "cmdm" else collate,
                                       shuffle=False, drop_last=True)
                gen_entries[seed][key] = collect_gen_conds(gen_iter, args.num_samples,
                                                           keep_motion=oracle)

        # device: sampling, same-index batches stacked across the chunk's seeds
        gen_batches = {seed: {key: [] for key in data_types} for seed in chunk}
        for split_index, key in enumerate(data_types):
            entries_by_seed = [gen_entries[seed][key] for seed in chunk]
            for i in range(min(len(e) for e in entries_by_seed)):
                group = [e[i] for e in entries_by_seed]
                cond_np = {name: np.concatenate([g["cond"][name] for g in group], axis=0)
                           for name in group[0]["cond"]}
                shape = (sum(g["shape"][0] for g in group),) + group[0]["shape"][1:]
                if oracle:
                    motion = np.concatenate([g["motion"] for g in group], axis=0)
                    output = (np.concatenate([cond_np["cmotion"], motion], axis=2)
                              if setting == "cmdm" else motion)
                else:
                    generator = batch_generator(chunk[0], i, split_index, device)
                    output = _sample_output(sample_fn, generator, cond_np, shape,
                                            setting, auto_regressive, device)
                offset = 0
                for seed, g in zip(chunk, group):
                    n = g["shape"][0]
                    gen_batches[seed][key].append({
                        "output": output[offset: offset + n], "lengths": g["lengths"],
                        "y": g["y"], "text": g["text"],
                    })
                    offset += n
            for seed in chunk:
                _trim_last_batch(gen_batches[seed][key], args.num_samples, bs)

        # host: per-seed metrics. numpy is seeded once per evaluation seed
        # and the diversity draws consume that ambient stream across the
        # four loader passes (seed=None below), as in the reference
        for seed in chunk:
            if not is_main:
                continue
            np.random.seed(seed)
            loaders = {"gen": gen_batches[seed], "gt": gt_batches[seed]}
            stgcn_metrics[seed] = evaluate_seed_metrics(evaluator, loaders,
                                                        acc_only=acc_only, seed=None)

    if not is_main:
        return {"feats": {}}
    return {"feats": {
        key: ["{:.6}".format(stgcn_metrics[seed][key]) for seed in seeds]
        for key in stgcn_metrics[seeds[0]]
    }}
