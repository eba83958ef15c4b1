"""Training runtime (counterpart of regennet_tpu/train/training_loop.py),
single device.

One optimizer step is: the training forward of the CMDM (dropout and
condition dropout drawn from the loop's torch.Generator; the decoder
self-attention through the training attention kernels on the GPU), the
mse loss terms with the joint decode, backward, AdamW with optax's linear
learning-rate anneal and decoupled weight decay on every parameter, and
the EMA update. Timesteps are drawn on the host by a schedule sampler
from its own numpy Generator, as in the JAX loop.

`--compute_dtype bfloat16` trains as the JAX package's `CMDM(dtype=bf16)`
does: the parameters, their gradients, the AdamW moments and the EMA stay
float32, and each step runs the model on bfloat16 copies of the
parameters (`torch.func.functional_call`), whose gradients come back to
the float32 leaves through the cast. The model's output is float32, so
the loss terms and the joint decode are too.

`--steps_per_call K` keeps the JAX loop's step boundaries: K single steps
run back to back, their host batches drawn first; saves, logs and the
DIFFUSION_TRAINING_TEST exit fall at the same steps, and `--nan_guard`
rolls back whole K-step blocks. `--eval_during_training` runs the debug
evaluation of the dataset after every save; `--profile_steps` writes a
torch.profiler Chrome trace of a window of steps.
"""

from __future__ import annotations

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
from regennet_torch.ops import body_model as bm
from regennet_torch.ops.pose_decode import make_rot2xyz
from regennet_torch.train import checkpoint
from regennet_torch.utils import kvlogger as logger
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
                    dtype: torch.dtype = torch.float32):
    """Build step(batch, generator, step, noise=None) -> metrics.

    batch: device tensors {"motion", "t", "weights", "cond"}; step: the
    number of updates applied so far (the learning-rate schedule reads
    it); noise: the q_sample draw, else drawn from `generator`. Updates
    the model, the optimizer and `ema` in place; the gradients stay on the
    parameters until the next step. metrics: 0-dim device tensors (the
    weighted term means, loss, grad_norm, param_norm, loss_q0..3) and the
    per-example loss_per_elem [B]. dtype: the compute dtype; below float32
    the model runs on copies of the float32 parameters cast to it."""
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    ema_list = [ema[n] for n in names]

    def train_step(batch, generator: torch.Generator, step: int,
                   noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        x, t, weights = batch["motion"], batch["t"], batch["weights"]
        if noise is None:
            noise = torch.randn(x.shape, generator=generator, device=x.device,
                                dtype=x.dtype)

        def model_fn(x_t, ts, cond):
            kwargs = dict(train=True, generator=generator)
            if dtype == torch.float32:
                return model(x_t, ts, cond, **kwargs)
            cast = {n: p.to(dtype) for n, p in zip(names, params)}
            return functional_call(model, cast, (x_t, ts, cond), kwargs)

        optimizer.zero_grad(set_to_none=True)
        terms = losses.training_losses(sched, cfg, model_fn, x, t, batch["cond"],
                                       noise, rot2xyz_fn=rot2xyz_fn)
        loss = torch.mean(terms["loss"] * weights)
        loss.backward()
        if lr_schedule is not None:
            for group in optimizer.param_groups:
                group["lr"] = lr_schedule(step)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        grad_norm = global_norm(grads)
        optimizer.step()
        with torch.no_grad():
            torch._foreach_mul_(ema_list, ema_rate)
            torch._foreach_add_(ema_list, params, alpha=1.0 - ema_rate)

            metrics = {k: torch.mean(v.detach() * weights) for k, v in terms.items()}
            metrics["loss"] = loss.detach()
            metrics["loss_per_elem"] = terms["loss"].detach()
            metrics["grad_norm"] = grad_norm
            metrics["param_norm"] = global_norm(params)
            quartile = (4 * t) // num_timesteps
            weighted = terms["loss"].detach() * weights
            for q in range(4):
                sel = (quartile == q).to(weighted.dtype)
                metrics[f"loss_q{q}"] = torch.sum(weighted * sel) / torch.clamp(
                    torch.sum(sel), min=1.0)
        return metrics

    return train_step


class TrainLoop:
    def __init__(self, args, train_platform, model, sched, cfg, data,
                 device: torch.device):
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
        self.global_batch = self.batch_size
        self.num_epochs = self.num_steps // (len(self.data) + 1)

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
        self._train_step = make_train_step(
            self.model, sched, cfg, self.optimizer, self.rot2xyz_fn, self.ema,
            ema_rate=float(getattr(args, "ema_rate", 0.9999)),
            num_timesteps=sched.num_timesteps,
            lr_schedule=lambda s: learning_rate(self.lr, self.lr_anneal_steps, s),
            dtype=self.dtype,
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

    def _snapshot(self):
        return ([p.detach().clone() for p in self.model.parameters()],
                copy.deepcopy(self.optimizer.state_dict()),
                {n: e.clone() for n, e in self.ema.items()})

    def _rollback(self, snapshot):
        params, opt_state, ema = snapshot
        with torch.no_grad():
            for p, saved in zip(self.model.parameters(), params):
                p.copy_(saved)
            for n, e in self.ema.items():
                e.copy_(ema[n])
        self.optimizer.load_state_dict(opt_state)

    # -- stepping -------------------------------------------------------

    def _make_host_batch(self, motion, cond) -> Dict:
        t, weights = self.schedule_sampler.sample(motion.shape[0], self._host_rng)
        y = cond["y"]
        cond_np = {
            "mask": np.asarray(y["mask"]),
            "cmotion": (np.asarray(y["cmotion"]) if "cmotion" in y
                        else np.zeros_like(np.asarray(motion))),
        }
        if "action" in y:
            cond_np["action"] = np.asarray(y["action"])
        return {"motion": np.asarray(motion), "t": t, "weights": weights,
                "cond": cond_np}

    def _to_device(self, host: Dict) -> Dict:
        def put(v):
            return torch.as_tensor(v, device=self.device)

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
            loss = torch.stack([m["loss"] for m in per_step]).cpu().numpy()
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
                self.schedule_sampler.update_with_local_losses(
                    host["t"], lpe.cpu().numpy())
        return per_step

    def _run(self, items) -> List[Dict]:
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
            if self.step % self.log_interval == 0:
                for k, v in metrics.items():
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
        logger.log("saving model...")
        path = checkpoint.save_checkpoint(
            self.save_dir, self.state_step, self.model, self.optimizer, self.ema,
            extra={"host_rng": self._host_rng.bit_generator.state,
                   "generator": self.generator.get_state()},
        )
        logger.log(f"saved checkpoint: {path}")

    # -- profiling and evaluation ----------------------------------------

    def _maybe_profile(self):
        """The JAX loop's window: trace steps [profile_start, profile_start +
        profile_steps) with torch.profiler (the CUDA activity on the card),
        started and stopped at the call boundaries where the loop sees
        those steps."""
        n = int(getattr(self.args, "profile_steps", 0) or 0)
        if n <= 0:
            return
        start = int(getattr(self.args, "profile_start", 10) or 0)
        if start <= self.step < start + n and self._profiler is None:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._profile_dir = os.path.join(self.save_dir, "profile")
            os.makedirs(self._profile_dir, exist_ok=True)
            self._profile_first = self.state_step
            self._profiler = profile(activities=activities)
            self._profiler.start()
        elif self.step >= start + n and self._profiler is not None:
            self._stop_profile()

    def _stop_profile(self):
        """Close an open trace and write it as a Chrome trace (no
        TensorBoard needed) into <save_dir>/profile."""
        if self._profiler is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof, self._profiler = self._profiler, None
        prof.stop()
        path = os.path.join(self._profile_dir, f"trace_steps{self._profile_first:09d}-"
                                               f"{self.state_step:09d}.json")
        prof.export_chrome_trace(path)
        logger.log(f"profiler trace written to {path}")

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
        platform under "Eval"."""
        if not getattr(self.args, "eval_during_training", False):
            return
        if self.args.dataset in ("humanml", "kit"):
            raise NotImplementedError(
                "in-training evaluation of humanml/kit needs the t2m evaluation "
                "stack (eval/eval_humanml.py), which is not ported")
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
        model = copy.deepcopy(self.model).to(self.dtype).eval()
        if self.args.dataset in ("humanact12", "uestc"):
            eval_args.num_seeds = self.args.eval_rep_times
            eval_dict = eval_humanact12_uestc.evaluate(
                eval_args, lambda: make_model_fn(model), self.sched, self.cfg, dataset,
                rec)
        else:
            evaluator = eval_cmdm.load_stgcn_evaluator(eval_args, rec, self.device)
            eval_dict = stgcn_eval.evaluate(
                eval_args, lambda: make_model_fn(model), self.sched, self.cfg, dataset,
                evaluator, setting=self.args.setting, acc_only=True)
        for k, v in eval_dict["feats"].items():
            self.train_platform.report_scalar(
                name=k, value=float(v[0]), iteration=self.state_step, group_name="Eval")
        logger.log(f"Evaluation time: {round(time.time() - start) / 60}min")
