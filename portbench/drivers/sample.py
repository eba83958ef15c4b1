"""Closed-loop reaction sampling: requests back to back, each one
`sampling.p_sample_loop` over every step of the configuration's DDPM with
the classifier-free-guided model function of `models/cmdm.py`, as the
evaluation's sampler calls it (`eval/stgcn_eval.py`: clip_denoised
False, the noise from a generator). A request is a batch of actor clips
and actions from the seeded pool; its noise generator is seeded from the
run's seed and the request's index.

The window counts every denoiser step of every row it completes; the
request that is running when the window closes stops there. The
benchmark's traffic (cell file, `traffic`): `rows` per request,
`guidance` (the CFG scale), `requests` (the pool of actor batches,
cycled), `checked_steps` (how many steps of each request, besides its
first and last, the check draws from the seed).

`correct`: at the drawn steps the sampler is held step by step from its
own state: the step's input x_t, the generator's state before the step's
z, and the step's guided x0 prediction and output x_{t-1} are kept;
afterwards the reference (plain PyTorch, portbench/reference) works out
x0 and x_{t-1} again from x_t and the same z. Numbers: `denoise_gap`
(x0), `step_gap` (x_{t-1}), each the largest gap over the largest
reference entry; `start_gap`, each request's first x against the
reference's draw from the request's generator (exact).
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from portbench import data, harness, judge, trace
from portbench.reference import numerics
from portbench.reference import sample as ref_sample


class _Stop(Exception):
    """The window closed."""


def _program_args(ctx):
    from regennet_torch.utils import parser_util

    argv = list(ctx.config["argv"]) + ["--save_dir", ctx.tmp, "--seed", str(ctx.program_seed)]
    return parser_util.train_args(argv)


def setup(ctx):
    from regennet_torch.device import pin_f32_contract
    from regennet_torch.models.cmdm import make_cfg_model_fn
    from regennet_torch.utils.fixseed import fixseed
    from regennet_torch.utils.model_util import _pick_activation, create_model_and_diffusion

    lap = harness.Laps()
    cfg, traffic = ctx.config, ctx.traffic
    args = _program_args(ctx)
    args.activation = _pick_activation(args)
    pin_f32_contract()
    fixseed(ctx.program_seed)
    model, sched, dcfg = create_model_and_diffusion(args, data.ActionData(cfg["num_actions"]),
                                                    device=ctx.device)
    model = model.to(ctx.device)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    weights = data.draw_weights(shapes, ctx.seed, ctx.device)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[n])
    del weights
    model.eval()
    lap("the model and its weights")
    requests = data.actor_requests(cfg, traffic["rows"], traffic["requests"], ctx.seed,
                                   ctx.device)
    state = dict(ctx=ctx, model=model, sched=sched, dcfg=dcfg, requests=requests,
                 model_fn=make_cfg_model_fn(model, traffic["guidance"]), shapes=shapes,
                 captures=[], started=0, rng=np.random.default_rng(ctx.seed))
    lap("the actor pool")
    _run(state, steps=3, capture=False)  # every shape of the window, once
    state["started"] = 0
    lap("the warm-up")
    return state


def _request_generator(ctx, index: int) -> torch.Generator:
    return data.generator(ctx.seed * 7919 + index, ctx.device)


def _run(state, seconds=None, steps=None, capture=True, traced=False):
    """Requests back to back until `seconds` pass or `steps` denoiser steps
    are done; returns the steps done."""
    from regennet_torch.diffusion import sampling

    ctx, traffic = state["ctx"], state["ctx"].traffic
    cfg = ctx.config
    total = cfg["diffusion_steps"]
    shape = (traffic["rows"], cfg["njoints"], cfg["nfeats"], cfg["num_frames"])
    done = 0
    t0 = time.perf_counter()
    inner = state["model_fn"]
    while True:
        index = state["started"]
        state["started"] += 1
        cond = state["requests"][index % len(state["requests"])]
        gen = _request_generator(ctx, index)
        drawn = set(state["rng"].choice(np.arange(1, total - 1), traffic["checked_steps"],
                                         replace=False).tolist()) | {0, total - 1}
        keep = drawn | {t - 1 for t in drawn}
        record = {"request": index, "gen_start": gen.get_state(), "steps": {}}
        calls = [0]

        def model_fn(x, t, c):
            nonlocal done
            if (seconds is not None and time.perf_counter() - t0 >= seconds) or (
                    steps is not None and done >= steps):
                raise _Stop
            i = total - 1 - calls[0]
            calls[0] += 1
            if capture and i in keep:
                record["steps"][i] = {"x": x.clone(), "gen": gen.get_state()}
            out = inner(x, t, c)
            if capture and i in drawn:
                record["steps"][i]["x0"] = out.clone()
            done += 1
            return out

        model_fn.prepare = inner.prepare
        try:
            with trace.span("request") if traced else contextlib.nullcontext():
                final = sampling.p_sample_loop(state["sched"], state["dcfg"], model_fn, shape,
                                               cond, clip_denoised=False, generator=gen)
            if capture:
                record["steps"][-1] = {"x": final.clone()}
        except _Stop:
            final = None
        if capture:
            record["drawn"] = drawn
            state["captures"].append(record)
        if final is None:
            return done


def window(state, seconds, steps, traced):
    ctx = state["ctx"]
    cfg, traffic = ctx.config, ctx.traffic
    if traced:
        from regennet_torch.models import transformer

        calls = []
        model = state["model"]

        def attention(original):
            def fn(q, k, v, num_heads, causal=True, *a, **kw):
                calls.append((q.shape[0], q.shape[1], q.shape[2], num_heads, causal))
                with trace.span("attention"):
                    return original(q, k, v, num_heads, causal, *a, **kw)
            return fn

        opened = []
        pre = model.register_forward_pre_hook(
            lambda m, a: opened.append(trace.span("denoiser").__enter__()))
        post = model.register_forward_hook(
            lambda m, a, o: opened.pop().__exit__(None, None, None))
        try:
            with trace.wrapped(transformer, "fused_attention_btd", attention):
                done = _run(state, steps=steps, traced=True)
        finally:
            pre.remove()
            post.remove()
        return {"steps": done, "denoiser_calls": done, "config": cfg,
                "rows": 2 * traffic["rows"], "attention": [("forward",) + c for c in calls]}
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = _run(state, seconds=seconds, steps=steps)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    seqs = done * traffic["rows"] / cfg["diffusion_steps"]
    return {"metrics": {"sample_seqs_per_s": seqs / wall}, "steps": done, "config": cfg,
            "rows": 2 * traffic["rows"]}


def check(state):
    ctx = state["ctx"]
    cfg, traffic = ctx.config, ctx.traffic
    captures, shapes, requests = state["captures"], state["shapes"], state["requests"]
    state.clear()
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    numerics.pinned_f32()
    weights = data.draw_weights(shapes, ctx.seed, ctx.device)
    sched = ref_sample.schedule(cfg, ctx.device)
    refcfg = dict(cfg)
    items = []
    shape = (traffic["rows"], cfg["njoints"], cfg["nfeats"], cfg["num_frames"])
    total = cfg["diffusion_steps"]
    with torch.no_grad():
        for record in captures:
            steps = record["steps"]
            req = requests[record["request"] % len(requests)]
            cond = {"cmotion": req["cmotion"], "action": req["action"]}
            g = torch.Generator(device=ctx.device)
            if total - 1 in steps:
                g.set_state(record["gen_start"])
                x_start = torch.randn(shape, generator=g, device=ctx.device)
                items.append({"start_gap": judge.relative_gap(steps[total - 1]["x"], x_start)})
            for t in sorted(record["drawn"]):
                after = steps.get(t - 1 if t > 0 else -1)
                if t not in steps or "x0" not in steps[t] or after is None:
                    continue
                g.set_state(steps[t]["gen"])
                z = torch.randn(shape, generator=g, device=ctx.device)
                x0, x_prev = ref_sample.step(weights, refcfg, sched, steps[t]["x"], t, cond,
                                             traffic["guidance"], z)
                items.append({"denoise_gap": judge.relative_gap(steps[t]["x0"], x0),
                              "step_gap": judge.relative_gap(after["x"], x_prev)})
    return items


def control(ctx, precision="tf32"):
    """The control: the reference at `precision` in the program's place,
    at this cell's size, on states x_t drawn as q_sample of a seeded clip
    at the request's first and last steps and `checked_steps` drawn ones;
    [{number: value}] per step, judged against the float32 reference as
    the program is."""
    cfg, traffic = ctx.config, ctx.traffic
    shape = (traffic["rows"], cfg["njoints"], cfg["nfeats"], cfg["num_frames"])
    sched = ref_sample.schedule(cfg, ctx.device)
    weights = data.draw_weights(_shapes(ctx), ctx.seed, ctx.device)
    req = data.actor_requests(cfg, traffic["rows"], 1, ctx.seed, ctx.device)[0]
    cond = {"cmotion": req["cmotion"], "action": req["action"]}
    g = data.generator(ctx.seed, ctx.device)
    total = cfg["diffusion_steps"]
    drawn = np.random.default_rng(ctx.seed).choice(np.arange(1, total - 1),
                                                   traffic["checked_steps"], replace=False)
    items = []
    for t in [0, total - 1] + drawn.tolist():
        x0 = torch.randn(shape, generator=g, device=ctx.device)
        x_t = (sched["sqrt_ab"][t] * x0
               + sched["sqrt_one_minus_ab"][t] * torch.randn(shape, generator=g, device=ctx.device))
        z = torch.randn(shape, generator=g, device=ctx.device)
        with torch.no_grad():
            a0, ap = ref_sample.step(weights, cfg, sched, x_t, t, cond, traffic["guidance"], z,
                                     precision)
            b0, bp = ref_sample.step(weights, cfg, sched, x_t, t, cond, traffic["guidance"], z)
        items.append({"denoise_gap": judge.relative_gap(a0, b0),
                      "step_gap": judge.relative_gap(ap, bp)})
    return items


def _shapes(ctx):
    """The program's parameter shapes, from a model built on the CPU."""
    from regennet_torch.utils.model_util import create_model_and_diffusion

    args = _program_args(ctx)
    model, _, _ = create_model_and_diffusion(args, data.ActionData(ctx.config["num_actions"]))
    return {n: tuple(p.shape) for n, p in model.named_parameters()}
