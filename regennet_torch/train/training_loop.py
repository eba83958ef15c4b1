"""Training runtime (counterpart of regennet_tpu/train/training_loop.py):
one process, or one process per card under torch.distributed
(parallel/mesh.py: --data_parallel, --tensor_parallel, --param_sharding
fsdp).

One optimizer step is: the training forward of the CMDM (dropout and
condition dropout drawn from the loop's torch.Generator; the decoder
self-attention through the training attention kernels on the GPU), the
mse loss terms with the joint decode, backward, AdamW with optax's linear
learning-rate anneal and decoupled weight decay on every parameter, and
the EMA update. Timesteps are drawn on the host by a schedule sampler
from its own numpy Generator, as in the JAX loop. Batches without an
actor (the mdm setting, humanml and kit) carry a zero cmotion; a
text-conditioned model (humanml, kit) gets each batch's captions as CLIP
embeddings (`clip_text.encode_text_or_fallback`, on the loop's device).

`--compute_dtype bfloat16` trains as the JAX package's `CMDM(dtype=bf16)`
does: the parameters, their gradients, the AdamW moments and the EMA stay
float32, and each step runs the model on bfloat16 copies of the
parameters (`torch.func.functional_call`), whose gradients come back to
the float32 leaves through the cast. The model's output is float32, so
the loss terms and the joint decode are too.

`--steps_per_call K` keeps the JAX loop's step boundaries: K single steps
run back to back, their host batches drawn first; saves, logs and the
DIFFUSION_TRAINING_TEST exit fall at the same steps, and `--nan_guard`
rolls back whole K-step blocks.

Under a process group each rank trains on its local batch of
--batch_size rows (the global batch is batch_size times the data size);
t, the noise and every dropout draw are the global batch's, sliced to the
rank's rows, so the step equals one process's step on the concatenated
batch. Rank 0 alone logs and writes files; the metrics, the NaN guard's
decision and the loss-aware sampler's history are the global batch's on
every rank. A checkpoint holds the full state in the one-device layout
whatever the sharding, and loads back into any layout.

`--eval_during_training` runs the debug evaluation of the dataset after
every save (humanml and kit: the T2M evaluation of eval/eval_humanml.py);
`--profile_steps` writes a Chrome trace of a window of steps
(utils.profiling.trace) with the program's spans recorded in it as
`regennet/<span>` ranges (utils.profiling.recording: `train.block`,
`train.host_batch`, `clip.encode`, `train.to_device`, `train.step` with
its `train.loss`, `denoiser`, `train.backward` and `train.optimizer`, the
attention's spans, and a `sync` around each copy that waits for the
device), and logs the window's counter totals (`host_syncs`) when it
closes.
"""

from __future__ import annotations

import contextlib
import copy
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.func import functional_call

from regennet_torch.diffusion import losses
from regennet_torch.diffusion.resample import (
    LossAwareSampler,
    create_named_schedule_sampler,
)
from regennet_torch.models.clip_text import encode_text_or_fallback
from regennet_torch.ops import body_model as bm
from regennet_torch.ops.pose_decode import make_rot2xyz
from regennet_torch.parallel import mesh
from regennet_torch.train import checkpoint
from regennet_torch.utils import kvlogger as logger
from regennet_torch.utils import profiling
from regennet_torch.utils.model_util import model_dtype

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def make_optimizer(params, lr: float, weight_decay: float) -> torch.optim.AdamW:
    """AdamW as optax.adamw builds it: betas (0.9, 0.999), eps 1e-8 added
    to sqrt(nu_hat), weight decay decoupled and applied to every parameter."""
    return torch.optim.AdamW(params, lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS,
                             weight_decay=weight_decay)


def learning_rate(lr: float, lr_anneal_steps: int, step: int) -> float:
    """optax.linear_schedule(lr, 0, lr_anneal_steps) at update `step`
    (the number of updates applied before it); constant without anneal."""
    if not lr_anneal_steps:
        return lr
    return lr * (1.0 - min(step, lr_anneal_steps) / lr_anneal_steps)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every entry (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


def load_train_state(model, optimizer: torch.optim.Optimizer,
                     ema: Dict[str, torch.Tensor], state: Dict) -> None:
    """Put a training state of convert.from_flax.train_state_from_flax
    (state dicts of numpy arrays) into the model, its AdamW and `ema`."""
    def tensor(x, like):
        return torch.tensor(np.asarray(x), device=like.device, dtype=like.dtype)

    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(tensor(state["model"][name], p))
            ema[name].copy_(tensor(state["ema"][name], p))
            optimizer.state[p] = {
                "step": torch.tensor(float(state["adam_step"])),
                "exp_avg": tensor(state["exp_avg"][name], p),
                "exp_avg_sq": tensor(state["exp_avg_sq"][name], p),
            }


def make_train_step(model, sched, cfg, optimizer: torch.optim.Optimizer,
                    rot2xyz_fn, ema: Dict[str, torch.Tensor],
                    ema_rate: float = 0.9999, num_timesteps: int = 1000,
                    lr_schedule: Optional[Callable[[int], float]] = None,
                    dtype: torch.dtype = torch.float32,
                    layout: Optional[mesh.Layout] = None,
                    fsdp: Optional[mesh.FlatShard] = None):
    """Build step(batch, generator, step, noise=None) -> metrics.

    batch: device tensors {"motion", "t", "weights", "cond"}; step: the
    number of updates applied so far (the learning-rate schedule reads
    it); noise: the q_sample draw, else drawn from `generator`. Updates
    the model, the optimizer and `ema` in place; the gradients stay on the
    parameters until the next step. metrics: 0-dim device tensors (the
    weighted term means, loss, grad_norm, param_norm, loss_q0..3) and the
    per-example loss_per_elem [B]. dtype: the compute dtype; below float32
    the model runs on copies of the float32 parameters cast to it.

    layout: this rank's place in a process group (batch: the rank's rows;
    the draws are the global batch's; gradients averaged over "data"; the
    metrics are the global batch's, loss_per_elem the rank's rows); one
    process's (parallel.mesh.one_process) by default. fsdp:
    the flat shard that the optimizer updates (ema then holds {"flat":
    its EMA}); the module's parameters are gathered for the step and
    released after it. The step runs in a `train.step` span (utils/profiling)
    holding `train.loss` (the forward and the loss terms), `train.backward`
    and `train.optimizer` (the rest)."""
    if layout is None:
        layout = mesh.one_process()
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    sharded = mesh.sharded_flags(names, layout)
    if fsdp is None:
        master, ema_list = params, [ema[n] for n in names]
    else:
        master, ema_list, sharded = [fsdp.shard], [ema["flat"]], [fsdp.flags(sharded)]

    def norm(tensors):
        return mesh.global_norm(tensors, sharded, layout, over_data=fsdp is not None)

    def update(terms, loss, t, weights, step: int) -> Dict[str, torch.Tensor]:
        """The gradient exchange, the gradient norm, AdamW, the EMA and the
        step's metrics, once the gradients are on the parameters."""
        if fsdp is not None:
            fsdp.reduce_grads_()
        else:
            mesh.average_grads_(params, layout)
        if lr_schedule is not None:
            for group in optimizer.param_groups:
                group["lr"] = lr_schedule(step)
        grad_norm = norm([p.grad if p.grad is not None else torch.zeros_like(p)
                          for p in master])
        optimizer.step()
        if fsdp is not None:
            fsdp.release_()
        with torch.no_grad():
            torch._foreach_mul_(ema_list, ema_rate)
            torch._foreach_add_(ema_list, master, alpha=1.0 - ema_rate)

            metrics = {k: torch.mean(v.detach() * weights) for k, v in terms.items()}
            metrics["loss"] = loss.detach()
            quartile = (4 * t) // num_timesteps
            weighted = terms["loss"].detach() * weights
            sums = []
            for q in range(4):
                sel = (quartile == q).to(weighted.dtype)
                sums += [torch.sum(weighted * sel), torch.sum(sel)]
            # the global batch's: means of the ranks' means, sums of sums
            keys = list(metrics)
            flat = layout.sum_over_data(torch.stack([metrics[k] for k in keys] + sums))
            metrics = dict(zip(keys, flat[:len(keys)] / layout.data_size))
            sums = flat[len(keys):]
            metrics["loss_per_elem"] = terms["loss"].detach()
            metrics["grad_norm"] = grad_norm
            metrics["param_norm"] = norm(master)
            for q in range(4):
                metrics[f"loss_q{q}"] = sums[2 * q] / torch.clamp(sums[2 * q + 1], min=1.0)
        return metrics

    def train_step(batch, generator: torch.Generator, step: int,
                   noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        with profiling.span("train.step"):
            x, t, weights = batch["motion"], batch["t"], batch["weights"]
            draws = layout.draws(generator, x.shape[0])
            if noise is None:
                noise = draws.randn(x.shape, x.device, x.dtype)
            if fsdp is not None:
                fsdp.gather_()

            def model_fn(x_t, ts, cond):
                kwargs = dict(train=True, generator=draws)
                if dtype == torch.float32:
                    return model(x_t, ts, cond, **kwargs)
                cast = {n: p.to(dtype) for n, p in zip(names, params)}
                return functional_call(model, cast, (x_t, ts, cond), kwargs)

            optimizer.zero_grad(set_to_none=True)
            with profiling.span("train.loss"):
                terms = losses.training_losses(sched, cfg, model_fn, x, t, batch["cond"],
                                               noise, rot2xyz_fn=rot2xyz_fn)
                loss = torch.mean(terms["loss"] * weights)
            with profiling.span("train.backward"):
                loss.backward()
            with profiling.span("train.optimizer"):
                return update(terms, loss, t, weights, step)

    return train_step


class TrainLoop:
    def __init__(self, args, train_platform, model, sched, cfg, data,
                 device: torch.device, layout: Optional[mesh.Layout] = None):
        """layout: this rank's place in the process group; by default
        parallel.mesh.setup's from args (one process's without a launcher)."""
        self.args = args
        self.train_platform = train_platform
        self.device = device
        # the master weights: float32 whatever the compute dtype
        self.model = model.to(device=device, dtype=torch.float32)
        self.dtype = model_dtype(args)
        self.sched = sched
        self.cfg = cfg
        self.data = data
        self.batch_size = args.batch_size
        self.lr = args.lr
        self.log_interval = args.log_interval
        self.save_interval = args.save_interval
        self.resume_checkpoint = args.resume_checkpoint
        self.weight_decay = args.weight_decay
        self.lr_anneal_steps = args.lr_anneal_steps
        self.num_steps = args.num_steps
        self.save_dir = args.save_dir
        self.step = 0
        self.resume_step = 0
        self.layout = layout if layout is not None else mesh.setup(args, device)
        self._is_main = self.layout.is_main
        self.global_batch = self.batch_size * self.layout.data_size
        # the JAX loop's len(data) * process_count: its processes are the
        # port's data ranks (a JAX process owns every device of its replica)
        self.num_epochs = self.num_steps // (len(self.data) * self.layout.data_size + 1)

        self.schedule_sampler = create_named_schedule_sampler(
            os.environ.get("REGENNET_SCHEDULE_SAMPLER", "uniform"),
            sched.num_timesteps,
        )
        self._host_rng = np.random.default_rng(args.seed)
        # every dropout, condition-dropout and noise draw of the run
        self.generator = torch.Generator(device=device).manual_seed(int(args.seed))

        body = bm.get_body_model(args.body_model).to(device)
        self.rot2xyz_fn = make_rot2xyz(
            body, pose_rep=args.pose_rep, jointstype=args.body_model,
            translation=True, glob=True, vertstrans=False,
            num_person=cfg.num_person,
        )
        self.optimizer = make_optimizer(self.model.parameters(), self.lr,
                                        self.weight_decay)
        self.ema = {n: p.detach().clone() for n, p in self.model.named_parameters()}
        n_params = sum(p.numel() for p in self.model.parameters())
        logger.log(f"Model parameters: {n_params / 1e6:.2f}M")
        self._resume()
        self._tp = self._fsdp = None
        self._shard_state()
        self._train_step = make_train_step(
            self.model, sched, cfg, self.optimizer, self.rot2xyz_fn, self.ema,
            ema_rate=float(getattr(args, "ema_rate", 0.9999)),
            num_timesteps=sched.num_timesteps,
            lr_schedule=lambda s: learning_rate(self.lr, self.lr_anneal_steps, s),
            dtype=self.dtype, layout=self.layout, fsdp=self._fsdp,
        )
        self._nan_guard = bool(getattr(args, "nan_guard", False))
        self._nan_skips = 0
        self.steps_per_call = max(1, int(getattr(args, "steps_per_call", 1)))
        if self.steps_per_call > 1 and isinstance(self.schedule_sampler,
                                                  LossAwareSampler):
            logger.log(
                f"WARNING: --steps_per_call {self.steps_per_call} with a "
                "loss-aware schedule sampler: the timesteps of all K steps "
                "of a block are drawn before the block, from an importance "
                "distribution up to K-1 updates stale"
            )
        self._block_buf = []
        self._last_save_at = None  # self.step value (pre-increment) last saved
        self._profiler = None
        self._recording = None  # the profiled window's spans and counters
        self._hml_eval = None  # the text evaluation's (wrapper, split), built once

    # -- state ----------------------------------------------------------

    @property
    def state_step(self) -> int:
        """Updates applied to the parameters, resumed ones included."""
        return self.resume_step + self.step

    def _resume(self):
        resume = self.resume_checkpoint or checkpoint.latest_checkpoint(self.save_dir)
        if not resume:
            return
        logger.log(f"loading model from checkpoint: {resume}...")
        extra = checkpoint.load_checkpoint(resume, self.model, self.optimizer, self.ema)
        self.resume_step = checkpoint.parse_step_from_path(resume)
        if "host_rng" in extra:
            self._host_rng.bit_generator.state = extra["host_rng"]
        if "generator" in extra:
            self.generator.set_state(extra["generator"])

    def _shard_state(self):
        """Put the (full, possibly resumed) parameters, AdamW moments and
        EMA into the layout: tensor-parallel blocks over "model", then one
        flat FSDP shard over "data"."""
        layout = self.layout
        names = [n for n, _ in self.model.named_parameters()]
        full = dict(self.model.named_parameters())
        moments = {n: self.optimizer.state.get(full[n], {}) for n in names}
        if layout.model_size > 1:
            self._tp = mesh.TensorParallel(layout.model_group, layout.model_rank,
                                           layout.model_size)
            mesh.shard_model_(self.model, self._tp)
            moments = {n: {k: (mesh.shard_tensor(n, v, self._tp.rank, self._tp.size)
                               if k != "step" else v) for k, v in st.items()}
                       for n, st in moments.items()}
            self.ema = {n: mesh.shard_tensor(n, e, self._tp.rank, self._tp.size).clone()
                        for n, e in self.ema.items()}
        params = [p for _, p in self.model.named_parameters()]
        if layout.fsdp:
            self._fsdp = mesh.FlatShard(params, layout)
            self.optimizer = make_optimizer([self._fsdp.shard], self.lr, self.weight_decay)
            st = moments[names[0]]
            if st:
                self.optimizer.state[self._fsdp.shard] = {
                    "step": st["step"].clone(),
                    **{k: self._fsdp.shard_of([moments[n][k] for n in names])
                       for k in ("exp_avg", "exp_avg_sq")}}
            self.ema = {"flat": self._fsdp.shard_of([self.ema[n] for n in names])}
            self._fsdp.release_()
        elif self._tp is not None:
            self.optimizer = make_optimizer(params, self.lr, self.weight_decay)
            for n, p in zip(names, params):
                if moments[n]:
                    self.optimizer.state[p] = {k: v.clone() for k, v in moments[n].items()}

    def _master(self) -> List[torch.Tensor]:
        """The tensors AdamW updates: the FSDP shard, or the parameters."""
        if self._fsdp is not None:
            return [self._fsdp.shard]
        return list(self.model.parameters())

    def _snapshot(self):
        return ([p.detach().clone() for p in self._master()],
                copy.deepcopy(self.optimizer.state_dict()),
                {n: e.clone() for n, e in self.ema.items()})

    def _rollback(self, snapshot):
        params, opt_state, ema = snapshot
        with torch.no_grad():
            for p, saved in zip(self._master(), params):
                p.copy_(saved)
            for n, e in self.ema.items():
                e.copy_(ema[n])
        self.optimizer.load_state_dict(opt_state)

    def _full_state(self):
        """(model state dict, AdamW state dict, EMA) of the whole model in
        the one-device layout, on every rank (collectives under a layout)."""
        names = [n for n, _ in self.model.named_parameters()]
        if self._fsdp is not None:
            fs = self._fsdp
            params = fs.full_of(fs.shard)
            ema = fs.full_of(self.ema["flat"])
            st = self.optimizer.state.get(fs.shard, {})
            moments = {k: fs.full_of(st[k]) if st else [None] * len(names)
                       for k in ("exp_avg", "exp_avg_sq")}
            step = st.get("step")
        else:
            params = [p.detach() for p in self.model.parameters()]
            ema = [self.ema[n] for n in names]
            # a parameter that has had no gradient has no AdamW state
            states = [self.optimizer.state.get(p, {}) for p in self.model.parameters()]
            moments = {k: [st.get(k) for st in states] for k in ("exp_avg", "exp_avg_sq")}
            step = next((st["step"] for st in states if st), None)
        if self._tp is not None:
            def unshard(tensors):
                return [t if t is None else mesh.unshard_tensor(n, t, self._tp)
                        for n, t in zip(names, tensors)]

            params, ema = unshard(params), unshard(ema)
            moments = {k: unshard(v) for k, v in moments.items()}
        full = [torch.nn.Parameter(p.clone()) for p in params]
        optimizer = make_optimizer(full, self.lr, self.weight_decay)
        optimizer.param_groups[0]["lr"] = self.optimizer.param_groups[0]["lr"]
        for i, p in enumerate(full):
            if moments["exp_avg"][i] is not None:
                optimizer.state[p] = {"step": step.clone(), "exp_avg": moments["exp_avg"][i],
                                      "exp_avg_sq": moments["exp_avg_sq"][i]}
        model_state = self.model.state_dict()
        model_state.update(zip(names, params))
        return model_state, optimizer.state_dict(), dict(zip(names, ema))

    # -- stepping -------------------------------------------------------

    def _make_host_batch(self, motion, cond) -> Dict:
        with profiling.span("train.host_batch"):
            B = motion.shape[0]
            # the global batch's draw, this rank's rows
            t, weights = self.schedule_sampler.sample(B * self.layout.data_size, self._host_rng)
            rows = slice(self.layout.data_rank * B, (self.layout.data_rank + 1) * B)
            t, weights = t[rows], weights[rows]
            y = cond["y"]
            cond_np = {
                "mask": np.asarray(y["mask"]),
                "cmotion": (np.asarray(y["cmotion"]) if "cmotion" in y
                            else np.zeros_like(np.asarray(motion))),
            }
            if "action" in y:
                cond_np["action"] = np.asarray(y["action"])
            if "text" in self.model.cond_mode:
                cond_np["text_emb"] = encode_text_or_fallback(
                    [str(c) for c in y.get("text", [""] * len(motion))], self.device)
            return {"motion": np.asarray(motion), "t": t, "weights": weights,
                    "cond": cond_np}

    def _to_device(self, host: Dict) -> Dict:
        def put(v):
            with profiling.blocking():  # a pageable copy waits for the stream
                return torch.as_tensor(v, device=self.device)

        with profiling.span("train.to_device"):
            return {
                "motion": put(host["motion"]).float(),
                "t": put(host["t"]).long(),
                "weights": put(host["weights"]).float(),
                "cond": {k: put(v) for k, v in host["cond"].items()},
            }

    def _finish(self, host_batches: List[Dict], per_step: List[Dict], snapshot):
        """NaN guard and loss-aware sampler update of one device call."""
        losses_per_elem = [m.pop("loss_per_elem") for m in per_step]
        if self._nan_guard:
            with profiling.blocking():
                loss = torch.stack([m["loss"] for m in per_step]).cpu().numpy()
            with profiling.blocking():
                gnorm = torch.stack([m["grad_norm"] for m in per_step]).cpu().numpy()
            if not (np.all(np.isfinite(loss)) and np.all(np.isfinite(gnorm))):
                self._nan_skips += 1
                logger.log(
                    f"WARNING: non-finite step in the {len(per_step)}-step "
                    f"block at step {self.state_step} (losses={loss.tolist()}, "
                    f"grad_norms={gnorm.tolist()}); dropping it "
                    f"({self._nan_skips} consecutive)"
                )
                self._rollback(snapshot)
                if self._nan_skips > 50:
                    raise FloatingPointError(
                        "more than 50 consecutive non-finite training steps; "
                        "aborting"
                    )
                return [{"nan_skipped": True}] * len(per_step)
            self._nan_skips = 0
        if isinstance(self.schedule_sampler, LossAwareSampler):
            for host, lpe in zip(host_batches, losses_per_elem):
                with profiling.blocking():
                    lpe = lpe.cpu().numpy()
                self.schedule_sampler.update_with_local_losses(
                    host["t"], lpe, group=self.layout.data_group)
        return per_step

    def _run(self, items) -> List[Dict]:
        with profiling.span("train.block"):
            hosts = [self._make_host_batch(m, c) for m, c in items]
            snapshot = self._snapshot() if self._nan_guard else None
            per_step = [
                self._train_step(self._to_device(h), self.generator, self.state_step + i)
                for i, h in enumerate(hosts)
            ]
            return self._finish(hosts, per_step, snapshot)

    def run_step(self, motion, cond) -> Dict:
        """One optimizer step on one (motion, cond) batch."""
        return self._run([(motion, cond)])[0]

    def run_block(self, items) -> List[Dict]:
        """K buffered (motion, cond) pairs -> K optimizer steps back to
        back; returns the per-step metrics in step order."""
        return self._run(items)

    def _steps_remaining(self) -> int:
        rem = self.num_steps - self.state_step
        if self.lr_anneal_steps:
            rem = min(rem, self.lr_anneal_steps - self.state_step)
        return rem

    def run_loop(self):
        start = time.time()
        K = self.steps_per_call
        for epoch in range(max(self.num_epochs, 1)):
            logger.log(f"Starting epoch {epoch}:{self.num_epochs}")
            for motion, cond in self.data:
                if self._steps_remaining() <= 0:
                    break
                self._maybe_profile()
                if K > 1 and self._steps_remaining() >= K:
                    self._block_buf.append((motion, cond))
                    if len(self._block_buf) < K:
                        continue
                    per_step = self.run_block(self._block_buf)
                    self._block_buf = []
                else:
                    per_step = [self.run_step(motion, cond)]
                if self._bookkeep(per_step, start):
                    self._stop_profile()
                    return  # DIFFUSION_TRAINING_TEST early exit
            # epoch boundary: flush a partial block with single steps
            for motion, cond in self._block_buf:
                if self._steps_remaining() <= 0:
                    break
                if self._bookkeep([self.run_step(motion, cond)], start):
                    self._stop_profile()
                    return
            self._block_buf = []
            if self.state_step >= self.num_steps:
                break
        self._stop_profile()  # the run ended inside the window
        if self._last_save_at != self.step - 1:
            self.save()
            self.evaluate()

    def _bookkeep(self, per_step_metrics, start) -> bool:
        """Logging and boundary saves of one device call (one step or a
        K-step block). True when DIFFUSION_TRAINING_TEST asks to exit."""
        first = self.step
        for metrics in per_step_metrics:
            if metrics.get("nan_skipped"):
                continue  # a dropped update: no logging, no step
            if self.step % self.log_interval == 0 and self._is_main:
                for k, v in metrics.items():
                    with profiling.blocking():
                        v = float(v)
                    logger.logkv_mean(k, v)
                    if k == "loss":
                        logger.log(f"step[{self.state_step}]: loss[{v:0.5f}]")
                    self.train_platform.report_scalar(
                        name=k, value=v, iteration=self.step, group_name="Loss")
                logger.logkv("step", self.state_step)
                logger.logkv("samples", (self.state_step + 1) * self.global_batch)
                logger.logkv("steps_per_sec",
                             (self.step + 1) / max(time.time() - start, 1e-9))
                logger.dumpkvs()
            self.step += 1

        # save when any step of [first, self.step) crossed a save_interval
        # multiple; the checkpoint is stamped with the true step
        crossings = [s for s in range(first, self.step) if s % self.save_interval == 0]
        if crossings:
            self.save()
            self.evaluate()
            self._last_save_at = self.step - 1
            # exit only when a crossing step was > 0, for K = 1 and K > 1 alike
            if os.environ.get("DIFFUSION_TRAINING_TEST", "") and any(
                    s > 0 for s in crossings):
                return True
        return False

    def save(self):
        """model{N}.pt and opt{N}.pt of the whole model, from rank 0."""
        logger.log("saving model...")
        model_state, optimizer_state, ema = self._full_state()
        if self._is_main:
            path = checkpoint.save_state(
                self.save_dir, self.state_step, model_state, optimizer_state, ema,
                extra={"host_rng": self._host_rng.bit_generator.state,
                       "generator": self.generator.get_state()},
            )
            logger.log(f"saved checkpoint: {path}")
        self.layout.barrier()

    # -- profiling and evaluation ----------------------------------------

    def _maybe_profile(self):
        """The JAX loop's window: trace steps [profile_start, profile_start +
        profile_steps) with utils.profiling.trace (the CUDA activity where a
        card is visible), started and stopped at the call boundaries where
        the loop sees those steps."""
        n = int(getattr(self.args, "profile_steps", 0) or 0)
        if n <= 0 or not self._is_main:
            return
        start = int(getattr(self.args, "profile_start", 10) or 0)
        if start <= self.step < start + n and self._profiler is None:
            profile_dir = os.path.join(self.save_dir, "profile")
            os.makedirs(profile_dir, exist_ok=True)
            first = self.state_step

            def write(prof):
                """A Chrome trace (no TensorBoard needed) into <save_dir>/profile."""
                path = os.path.join(profile_dir, f"trace_steps{first:09d}-"
                                                 f"{self.state_step:09d}.json")
                prof.export_chrome_trace(path)
                logger.log(f"profiler trace written to {path}")

            self._profiler = contextlib.ExitStack()
            self._profiler.enter_context(profiling.trace(profile_dir, on_trace_ready=write))
            self._recording = self._profiler.enter_context(profiling.recording())
        elif self.step >= start + n and self._profiler is not None:
            self._stop_profile()

    def _stop_profile(self):
        """Close an open trace, which writes it, and log the window's
        counter totals."""
        if self._profiler is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        window, self._profiler = self._profiler, None
        window.close()
        counters = ", ".join(f"{k} {v}" for k, v in sorted(self._recording.counters.items()))
        logger.log(f"profiled window's counters: {counters or 'none'}")
        self._recording = None

    def _eval_model(self):
        """A copy of the current parameters at the compute dtype, for
        sampling (tensor-parallel under tensor parallelism)."""
        if self._fsdp is not None:
            self._fsdp.gather_()
        model = copy.deepcopy(self.model).to(self.dtype).eval()
        if self._fsdp is not None:
            self._fsdp.release_()
        return model

    def evaluate(self):
        """In-training evaluation after a save, with --eval_during_training
        (regennet_tpu TrainLoop.evaluate), at eval_batch_size on
        min(eval_num_samples, 100) samples, sampling from the current
        parameters (not the EMA) at the run's compute dtype, against the
        classifier of --rec_model_path or REGENNET_REC_MODEL_PATH ('random'
        builds it from --seed): for humanact12 and uestc
        eval_humanact12_uestc.evaluate in debug mode with eval_rep_times
        seeds, else the eval_cmdm protocol in debug mode (one seed,
        accuracy only). Each metric of the first seed goes to the train
        platform under "Eval". humanml and kit take _evaluate_humanml."""
        if not getattr(self.args, "eval_during_training", False):
            return
        if self.args.dataset in ("humanml", "kit"):
            self._evaluate_humanml()
            return
        rec = getattr(self.args, "rec_model_path", "") or os.environ.get(
            "REGENNET_REC_MODEL_PATH", "")
        if not rec:
            logger.log("eval_during_training set but no rec_model_path; skipping")
            return
        from argparse import Namespace

        from regennet_torch.eval import eval_cmdm, eval_humanact12_uestc, stgcn_eval
        from regennet_torch.models.cmdm import make_model_fn

        start = time.time()
        eval_args = Namespace(**vars(self.args))
        eval_args.batch_size = self.args.eval_batch_size
        eval_args.num_samples = min(self.args.eval_num_samples, 100)
        eval_args.num_seeds = 1
        eval_args.eval_mode = "debug"
        dataset = getattr(self.data, "dataset", self.data)
        eval_args.num_actions = getattr(dataset, "num_actions", 1)
        model = self._eval_model()
        if self.args.dataset in ("humanact12", "uestc"):
            eval_args.num_seeds = self.args.eval_rep_times
            eval_dict = eval_humanact12_uestc.evaluate(
                eval_args, lambda: make_model_fn(model), self.sched, self.cfg, dataset,
                rec)
        else:
            evaluator = eval_cmdm.load_stgcn_evaluator(eval_args, rec, self.device)
            # under a process group the "data" ranks share each batch
            eval_dict = stgcn_eval.evaluate(
                eval_args, lambda: make_model_fn(model), self.sched, self.cfg, dataset,
                evaluator, setting=self.args.setting, acc_only=True, layout=self.layout)
        for k, v in eval_dict["feats"].items():
            self.train_platform.report_scalar(
                name=k, value=float(v[0]), iteration=self.state_step, group_name="Eval")
        logger.log(f"Evaluation time: {round(time.time() - start) / 60}min")

    def _evaluate_humanml(self):
        """The text-to-motion evaluation (regennet_tpu TrainLoop._evaluate_humanml):
        eval_humanml.evaluation of samples from the current parameters at the
        run's compute dtype (guidance 1), against the T2M evaluators of
        --rec_model_path (random ones from --seed without it), on the
        --eval_split split: eval_num_samples at eval_batch_size (-1: the
        whole split), eval_rep_times replications, diversity over
        min(300, samples), no multimodality. The wrapper and the split are
        built once. The log goes to eval_humanml_{step:09d}.log in save_dir;
        each metric goes to the train platform under "Eval", R-precision as
        top{k}_<key>."""
        from regennet_torch.data.humanml.dataset import Text2MotionDataset
        from regennet_torch.eval import eval_humanml

        start = time.time()
        if self._hml_eval is None:
            wrapper = eval_humanml.load_t2m_wrapper(
                self.args.dataset, getattr(self.args, "rec_model_path", ""), self.args.seed,
                self.device)
            eval_ds = Text2MotionDataset(self.args.data_path, split=self.args.eval_split,
                                         dataset_name=self.args.dataset)
            self._hml_eval = (wrapper, eval_ds)
        wrapper, eval_ds = self._hml_eval
        model = self._eval_model()
        num_samples = self.args.eval_num_samples
        gt_factory = eval_humanml.make_gt_loader_factory(
            eval_ds, self.args.eval_batch_size, num_samples)
        gen_factory = eval_humanml.make_gen_loader_factory(
            eval_ds, model, self.sched, self.cfg, self.args.eval_batch_size, num_samples,
            seed=self.args.seed)
        step = self.state_step
        log_file = os.path.join(self.save_dir, f"eval_humanml_{step:09d}.log")
        if num_samples is None or num_samples < 0:  # -1: the whole split
            num_samples = len(eval_ds)
        eval_dict = eval_humanml.evaluation(
            wrapper, gt_factory, {"model": gen_factory}, log_file,
            replication_times=self.args.eval_rep_times,
            diversity_times=min(300, num_samples), run_mm=False)
        for k, v in eval_dict.items():
            if k.startswith("R_precision"):
                for i, value in enumerate(v):
                    self.train_platform.report_scalar(
                        name=f"top{i + 1}_{k}", value=float(value), iteration=step,
                        group_name="Eval")
            else:
                self.train_platform.report_scalar(
                    name=k, value=float(np.asarray(v).mean()), iteration=step,
                    group_name="Eval")
        logger.log(f"Evaluation time: {round(time.time() - start) / 60}min")

