"""Faults planted under the timed path, to show that `correct` catches
them (the CPU tests) and to read each training number's upper limit on
the card (`calibrate.py --fault`). Each `plant(name)` patches the
program in this process and returns a function that undoes it:

    state_unchanged  AdamW steps change nothing (training), or the
                     sampler's step returns its input (sampling)
    half_batch       the loss is the mean over the first half of the
                     batch (training), or the denoiser answers the
                     first half of its rows twice (sampling)
    answer_altered   the denoiser's output is 1% off where it is made
"""

from __future__ import annotations

from typing import Callable

import torch

NAMES = ("state_unchanged", "half_batch", "answer_altered")


def _patch(target, attr: str, value) -> Callable[[], None]:
    original = getattr(target, attr)
    setattr(target, attr, value)
    return lambda: setattr(target, attr, original)


def plant(name: str, training: bool) -> Callable[[], None]:
    from regennet_torch.diffusion import gaussian, losses
    from regennet_torch.models import cmdm

    if name == "state_unchanged" and training:
        return _patch(torch.optim.AdamW, "step", lambda self, closure=None: None)
    if name == "state_unchanged":
        original = gaussian.p_mean_variance

        def frozen(sched, cfg, model_fn, x, t, *args, **kwargs):
            out = original(sched, cfg, model_fn, x, t, *args, **kwargs)
            return dict(out, mean=x, log_variance=torch.full_like(out["log_variance"], -200.0))

        return _patch(gaussian, "p_mean_variance", frozen)
    if name == "half_batch" and training:
        original_losses = losses.training_losses

        def half(*args, **kwargs):
            terms = original_losses(*args, **kwargs)
            keep = terms["loss"][: terms["loss"].shape[0] // 2]
            terms["loss"] = torch.cat([keep, keep])
            return terms

        return _patch(losses, "training_losses", half)
    original_forward = cmdm.CMDM.forward
    if name == "half_batch":
        def halved(self, x, *args, **kwargs):
            out = original_forward(self, x, *args, **kwargs)
            n = out.shape[0] // 2
            return torch.cat([out[:n], out[:n]])

        return _patch(cmdm.CMDM, "forward", halved)
    if name == "answer_altered":
        def altered(self, *args, **kwargs):
            return original_forward(self, *args, **kwargs) * 1.01

        return _patch(cmdm.CMDM, "forward", altered)
    raise ValueError(f"no fault {name!r}: choose one of {NAMES}")
