"""CMDM training through `train/training_loop.TrainLoop`, built as
`train_mdm` builds it from the configuration's arguments, fed K-step
blocks (`run_block`) from a seeded pool of collated batches, cycled.
The loop's bookkeeping (a log line every --log_interval steps, a
checkpoint every --save_interval steps, step 0 included) is left out, so
that no run writes a checkpoint; the steps are counted into the loop's
step as it counts them.

Set-up builds the one TrainLoop, loads the benchmark's weights into it
and drives its first three optimizer steps through `run_block` on
batches that all differ (one step, then two), keeping the loss of each,
the first gradient (from AdamW's first moment after one step: 0.1 g) and
the change of every parameter and of its EMA after the third step. The
window then runs on that same loop, and its first K-step block is held:
each step's loss, and every parameter and its EMA at the block's end.
The traffic (cell file, `traffic`): `pool` (collated batches in the
pool; at least 3 + K, so that every compared step has rows of its own).

`correct`: the reference (portbench/reference/train.py) follows the same
3 + K steps from the seed: the timestep draws, the noise and every
dropout mask replayed from generators seeded as the program's are.
Numbers: `loss_gap` (the worst of the first three steps' relative gaps),
`grad_error_ratio` (the worst leaf's gap between the norms of the first
gradient and the float64 reference's, over the same gap of the float32
reference: the program's gradient error in units of plain float32's own
on the same batch, which some batches amplify a hundredfold),
`update_gap` (the same for the parameters' change after three steps,
over the entries whose reference gradient is at least a thousandth of
the median leaf's root-mean-square gradient: the key third of each
packed attention bias has a gradient of nought to rounding under softmax
and moves under Adam by round-off alone) and `ema_gap` (the median
leaf's gap for the EMA's change over those entries: the EMA moves by
1e-4 of each update, a few float32 spacings of a weight, so its worst
leaf reads the rounding of the EMA itself; a fault of the EMA moves
every leaf). `window_loss_gap`, `window_update_gap` and
`window_ema_gap` are the same for the window's first block: its K
steps' losses, and the changes after step 3 + K.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import os
import sys
import time

import numpy as np
import torch

from portbench import data, harness, judge, trace
from portbench.reference import clip_bpe
from portbench.reference import model as ref_model
from portbench.reference import train as ref_train

FIRST_STEPS = 3
NO_SAVE = 10 ** 12


def _program_args(ctx, save_dir):
    from regennet_torch.utils import parser_util

    argv = list(ctx.config["argv"]) + [
        "--save_dir", save_dir, "--seed", str(ctx.program_seed),
        "--save_interval", str(NO_SAVE), "--num_steps", str(NO_SAVE)]
    return parser_util.train_args(argv)


def _text(cfg) -> bool:
    return cfg["cond_mode"] == "text"


def _pool(ctx):
    """The pool of collated batches."""
    cfg = ctx.config
    make = data.humanml_batches if _text(cfg) else data.chi3d_batches
    return make(cfg, cfg["batch_size"], ctx.traffic["pool"], ctx.seed, ctx.device)


def setup(ctx):
    from regennet_torch.device import pin_f32_contract
    from regennet_torch.train.train_platforms import NoPlatform
    from regennet_torch.train.training_loop import TrainLoop
    from regennet_torch.utils import kvlogger as logger
    from regennet_torch.utils.fixseed import fixseed
    from regennet_torch.utils.model_util import (TextData, _pick_activation,
                                                 create_model_and_diffusion)

    lap = harness.Laps()
    cfg, device = ctx.config, ctx.device
    if _text(cfg):
        files = data.clip_files(os.path.join(ctx.cache_dir, "clip"), device)
        os.environ.update(REGENNET_CLIP_PATH=files["clip"], REGENNET_CLIP_BPE=files["bpe"])
    save_dir = os.path.join(ctx.tmp, "run")
    args = _program_args(ctx, save_dir)
    args.activation = _pick_activation(args)
    pin_f32_contract()
    fixseed(ctx.program_seed)
    logger.configure(None, formats=(), quiet=True)
    lap("the CLIP files and the program's arguments")
    pool = _pool(ctx)
    if len(pool) < FIRST_STEPS + cfg["steps_per_call"]:
        raise ValueError(f"the pool holds {len(pool)} batches, fewer than the "
                         f"{FIRST_STEPS} + K steps that are compared")
    lap("the batch pool")
    stub = TextData() if _text(cfg) else data.ActionData(cfg["num_actions"])
    model, sched, dcfg = create_model_and_diffusion(args, stub, device=device)
    model = model.to(device)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    weights = data.draw_weights(shapes, ctx.seed, device)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[n])
    del weights
    lap("the model and its weights")
    loop = TrainLoop(args, NoPlatform(save_dir), model, sched, dcfg, pool, device)
    lap("the TrainLoop")
    params = dict(loop.model.named_parameters())
    start = {n: p.detach().cpu().clone() for n, p in params.items()}
    first = _block(loop, pool[:1])
    # a leaf that AdamW left without state read as no gradient
    grad = {n: (loop.optimizer.state[p].get("exp_avg", torch.zeros_like(p)) / (1.0 - 0.9)).cpu()
            for n, p in params.items()}
    rest = _block(loop, pool[1:FIRST_STEPS])
    readings = {"loss": [float(m["loss"]) for m in first + rest], "grad": grad,
                "at": {FIRST_STEPS: _changes(params, loop.ema, start)}}
    lap("the first three steps")
    feed = itertools.islice(itertools.cycle(pool), FIRST_STEPS, None)
    return dict(ctx=ctx, loop=loop, pool=pool, feed=feed, shapes=shapes, start=start,
                readings=readings, held=None, device=device)


def _changes(params, ema, start) -> dict:
    """The change of every parameter and of its EMA since `start`."""
    return {"change": {n: p.detach().cpu() - start[n] for n, p in params.items()},
            "ema_change": {n: ema[n].cpu() - start[n] for n in params}}


def _hold(loop, per_step) -> dict:
    """The first timed block's losses, parameters and EMA, copied on the
    device as the block leaves them; read once the window has closed."""
    with torch.no_grad():
        return {"loss": torch.stack([m["loss"].detach().reshape(()) for m in per_step]),
                "params": {n: p.detach().clone() for n, p in loop.model.named_parameters()},
                "ema": {n: t.clone() for n, t in loop.ema.items()}}


def _block(loop, items):
    per_step = loop.run_block(items)
    loop.step += len(items)
    return per_step


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _blocks(state, seconds, steps, traced, marks) -> int:
    """K-step blocks until `seconds` pass or `steps` are done, the host's
    clock at each block's start appended to `marks`; the first block after
    set-up is held for the check. Returns the steps done."""
    loop, feed = state["loop"], state["feed"]
    K = loop.steps_per_call
    t0 = time.perf_counter()
    done = 0
    while (time.perf_counter() - t0 < seconds) if seconds is not None else done < steps:
        marks.append(time.perf_counter())
        block = [next(feed) for _ in range(K)]
        with trace.span("block") if traced else contextlib.nullcontext():
            per_step = _block(loop, block)
        if state["held"] is None:
            state["held"] = _hold(loop, per_step)
        done += K
    _sync(state["device"])
    return done


def _pace(marks, cpu_s, wall):
    """A line on standard error of how the host paced the window: the
    quartiles of the blocks' host-clock lengths, and the process's CPU
    seconds over the wall (equal where one host thread paces the card)."""
    ms = 1e3 * np.diff(marks)
    q = np.percentile(ms, [25, 50, 75]) if len(ms) else [0.0] * 3
    print(f"portbench: window pace, {len(ms)} blocks of {q[0]:.1f} / {q[1]:.1f} / {q[2]:.1f} ms "
          f"(quartiles), longest {max(ms, default=0.0):.1f} ms; CPU {cpu_s:.2f} s of "
          f"{wall:.2f} s wall, {torch.get_num_threads()} torch threads", file=sys.stderr, flush=True)


def window(state, seconds, steps, traced):
    ctx, loop = state["ctx"], state["loop"]
    calls = []
    stack = contextlib.ExitStack()
    if traced:
        from regennet_torch.models import transformer

        def attention(original):
            def fn(q, k, v, num_heads, dropout_rate, seed, causal=True, *a, **kw):
                calls.append((q.shape[0], q.shape[1], q.shape[2], num_heads, causal))
                backward = trace.BackwardSpan("attention_bwd")
                q, k, v = backward.enter(q, k, v)
                with trace.span("attention_fwd"):
                    out = original(q, k, v, num_heads, dropout_rate, seed, causal, *a, **kw)
                return backward.exit(out)
            return fn

        def spanned(name, method):
            def fn(*a, **kw):
                with trace.span(name):
                    return method(*a, **kw)
            return fn

        loop._make_host_batch = spanned("host_batch", loop._make_host_batch)
        loop._to_device = spanned("to_device", loop._to_device)
        stack.enter_context(trace.wrapped(transformer, "fused_attention_btd_train", attention))
    _sync(state["device"])
    marks = []
    cpu0, t0 = time.process_time(), time.perf_counter()
    try:
        done = _blocks(state, seconds, steps, traced, marks)
    finally:
        stack.close()
        if traced:
            del loop._make_host_batch, loop._to_device
    wall = time.perf_counter() - t0
    if seconds is not None:
        _pace(marks + [t0 + wall], time.process_time() - cpu0, wall)
    rows = loop.global_batch
    return {"metrics": {"train_samples_per_s": done * rows / wall}, "steps": done, "rows": rows,
            "config": ctx.config,
            "attention": [(kind,) + c for c in calls for kind in ("forward", "backward")]}


def reference_inputs(ctx, pool, count, precision="float32", dtype=torch.float32):
    """The first `count` pool batches as the reference takes them, on the
    device in `dtype`; text batches carry the reference's own CLIP
    embedding."""
    cfg = ctx.config
    batches = []
    if _text(cfg):
        files = data.clip_files(os.path.join(ctx.cache_dir, "clip"), ctx.device)
        clip = {k: v.to(ctx.device, dtype) for k, v in torch.load(files["clip"]).items()}
        tokenizer = clip_bpe.ClipTokenizer(files["bpe"])
    for motion, cond in pool[:count]:
        y = cond["y"]
        x = torch.as_tensor(motion, device=ctx.device).to(dtype)
        c = {"mask": torch.as_tensor(y["mask"], device=ctx.device)}
        if _text(cfg):
            tokens = tokenizer.tokenize(list(y["text"]), context_length=22, truncate=True)
            tokens = np.pad(tokens, ((0, 0), (0, data.CLIP_TOWER["context_length"] - 22)))
            with torch.no_grad():
                c["text_emb"] = ref_model.clip_text(
                    clip, torch.as_tensor(tokens, device=ctx.device).long(),
                    data.CLIP_TOWER["heads"], data.CLIP_TOWER["layers"], precision)
            c["cmotion"] = torch.zeros_like(x)
        else:
            c["cmotion"] = torch.as_tensor(y["cmotion"], device=ctx.device).to(dtype)
            c["action"] = torch.as_tensor(y["action"], device=ctx.device)
        batches.append({"motion": x, "cond": c})
    return batches


# plain float32's own worst leaf error, floored near its rounding
F32_ERROR_FLOOR = 1e-7


def _update_numbers(side, ref, step, moving) -> tuple:
    """(worst leaf's parameter change gap, median leaf's EMA change gap)
    after `step`."""
    s, r = side["at"][step], ref["at"][step]
    ema = judge.leaf_gaps(s["ema_change"], r["ema_change"], moving)
    return (judge.leaf_gap(s["change"], r["change"], moving),
            float(np.median(list(ema.values()))))


def compare(side, ref, exact) -> dict:
    """The numbers of one side (the program, or the control) against the
    float32 reference `ref`; the gradient against the float64 reference
    `exact`, in units of the float32 reference's own error there."""
    moving = judge.moving_entries(ref["grad"])
    losses = [judge.scalar_gap(p, r) for p, r in zip(side["loss"], ref["loss"])]
    unit = max(judge.leaf_gap(ref["grad"], exact["grad"]), F32_ERROR_FLOOR)
    update, ema = _update_numbers(side, ref, FIRST_STEPS, moving)
    last = len(ref["loss"])
    window_update, window_ema = _update_numbers(side, ref, last, moving)
    return {"loss_gap": max(losses[:FIRST_STEPS]),
            "grad_error_ratio": judge.leaf_gap(side["grad"], exact["grad"]) / unit,
            "update_gap": update, "ema_gap": ema,
            "window_loss_gap": max(losses[FIRST_STEPS:last]),
            "window_update_gap": window_update, "window_ema_gap": window_ema}


def follow_reference(ctx, shapes, pool, steps, precision="float32", dtype=torch.float32):
    """The reference's first `steps` steps from the seed, its changes kept
    after step 3 and after the last."""
    weights = {k: v.to(dtype) for k, v in data.draw_weights(shapes, ctx.seed, ctx.device).items()}
    batches = reference_inputs(ctx, pool, steps, precision, dtype)
    ref = ref_train.follow(weights, ctx.config, batches, ctx.program_seed, ctx.device, precision,
                           keep=(FIRST_STEPS, steps))
    return {"loss": ref["loss"], "grad": {n: t.float().cpu() for n, t in ref["grad"].items()},
            "at": {step: {k: {n: t.float().cpu() for n, t in v.items()} for k, v in at.items()}
                   for step, at in ref["at"].items()}}


def _compared_steps(ctx) -> int:
    return FIRST_STEPS + int(ctx.config["steps_per_call"])


def check(state):
    ctx, shapes, pool, prog = state["ctx"], state["shapes"], state["pool"], state["readings"]
    held = state["held"]
    steps = FIRST_STEPS + len(held["loss"])
    prog["loss"] = prog["loss"] + [float(v) for v in held["loss"].cpu()]
    prog["at"][steps] = _changes(held["params"], held["ema"], state["start"])
    state.clear()
    del held
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = follow_reference(ctx, shapes, pool, steps)
    exact = follow_reference(ctx, shapes, pool, 1, dtype=torch.float64)
    return [compare(prog, ref, exact)]


def _shapes(ctx):
    """The program's parameter shapes, from a model built on the CPU."""
    from regennet_torch.utils.model_util import TextData, create_model_and_diffusion

    args = _program_args(ctx, os.path.join(ctx.tmp, "run"))
    stub = TextData() if _text(ctx.config) else data.ActionData(ctx.config["num_actions"])
    model, _, _ = create_model_and_diffusion(args, stub)
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def control(ctx, precision="tf32"):
    """The control: the reference at `precision` in the program's place,
    judged as the program is; [{number: value}]."""
    shapes, pool, steps = _shapes(ctx), _pool(ctx), _compared_steps(ctx)
    low = follow_reference(ctx, shapes, pool, steps, precision)
    ref = follow_reference(ctx, shapes, pool, steps)
    exact = follow_reference(ctx, shapes, pool, 1, dtype=torch.float64)
    return [compare(low, ref, exact)]
