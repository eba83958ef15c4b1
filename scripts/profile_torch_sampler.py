#!/usr/bin/env python3
"""Where a denoiser step of the port's sampler spends its time on the GPU.

    python3 scripts/profile_torch_sampler.py [--steps 20]

For each chip_smoke request shape (flagship CMDM, Chi3D T=150, random
weights: the online trunk at f32 batch 16, f32 batch 16 with CFG 2.5,
bf16 batch 128; the offline trunk at f32 batch 16 (phase 5's request);
the online trunk at f32 batch 32 with CFG 2.5 (phase 6's evaluation
batches)) it runs `--steps` DDPM steps of `regennet_torch.diffusion.sampling`
after a warm-up: once untraced for the wall ms per step, once under
torch.profiler for the device's busy ms per step (the sum of kernel
time), the kernels by device time and their groups (chip_smoke's
`_kernel_group`: the attention kernels, cuBLAS GEMMs, LayerNorm, ...);
idle share = 1 - busy / wall.
Prints one JSON object and writes it to
chiprun_out/profile_torch_sampler.json. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def profile_request(arch, batch, guidance, dtype, steps):
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from regennet_torch.data import synthetic
    from regennet_torch.data.collate import ccollate
    from regennet_torch.data.feeder import Feeder
    from regennet_torch.diffusion import sampling
    from regennet_torch.models.cmdm import make_cfg_model_fn, make_model_fn
    from regennet_torch.utils.model_util import create_model_and_diffusion

    T = chip_smoke.FLAGSHIP["T"]
    data = Feeder(clips=synthetic.make_clips("chi3d", "test", num_clips=16,
                                             min_len=T + 10, max_len=2 * T),
                  dataname="chi3d", split="test", num_frames=T, num_person=2)
    args = chip_smoke.request_args("", batch, guidance, dtype, seed=0, arch=arch)
    args.timestep_respacing = str(steps)  # `steps` steps of the 1000-step schedule
    torch.manual_seed(0)
    model, sched, cfg = create_model_and_diffusion(args, data, device="cuda")
    model = model.to(device="cuda", dtype=getattr(torch, dtype)).eval()
    model_fn = (make_cfg_model_fn(model, guidance) if guidance != 1.0
                else make_model_fn(model))
    motion, cond_np = ccollate([data.get_cmotion(i % 8, "appointed", 0)
                                for i in range(batch)])
    cond = {"cmotion": torch.as_tensor(cond_np["y"]["cmotion"], device="cuda"),
            "action": torch.as_tensor(cond_np["y"]["action"], device="cuda")}
    gen = torch.Generator(device="cuda").manual_seed(0)

    def run():
        return sampling.p_sample_loop(sched, cfg, model_fn, motion.shape, cond,
                                      clip_denoised=False, generator=gen)

    run()  # warm-up
    torch.cuda.synchronize()
    # wall time untraced (the profiler slows the host side), kernels traced
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", 0) or 0
        if dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + dev_us / 1e3
    busy_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    groups = {}
    for name, ms in kernels.items():
        group = chip_smoke._kernel_group(name)
        groups[group] = groups.get(group, 0.0) + ms / steps
    return {
        "arch": arch, "batch": batch, "guidance": guidance, "dtype": dtype, "steps": steps,
        "wall_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": busy_ms / steps,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "groups_ms_per_step": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "kernels_ms_per_step": {k: v / steps for k, v in top},
    }


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=20)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_sampler: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from regennet_torch.device import pin_f32_contract

    pin_f32_contract()
    out = {"card": chip_smoke.card_line(), "requests": []}
    for request in (("online", 16, 1.0, "float32"), ("online", 16, 2.5, "float32"),
                    ("online", 128, 1.0, "bfloat16"), ("trans_enc", 16, 1.0, "float32"),
                    ("online", 32, 2.5, "float32")):
        out["requests"].append(profile_request(*request, opts.steps))
    text = json.dumps(out, indent=1)
    (REPO / "chiprun_out").mkdir(exist_ok=True)
    (REPO / "chiprun_out" / "profile_torch_sampler.json").write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
