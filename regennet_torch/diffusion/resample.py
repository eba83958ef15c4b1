"""Timestep schedule samplers, uniform and loss-aware importance sampling
(the port's copy of regennet_tpu/diffusion/resample.py).

Host-side numpy state machines. Under a torch.distributed process group
of more than one rank, a loss-aware sampler learns from every rank's
losses: each update all-gathers the ranks' (t, loss) pairs first.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np
import torch.distributed as dist


def create_named_schedule_sampler(name: str, num_timesteps: int):
    if name == "uniform":
        return UniformSampler(num_timesteps)
    if name == "loss-second-moment":
        return LossSecondMomentResampler(num_timesteps)
    raise NotImplementedError(f"unknown schedule sampler: {name}")


class ScheduleSampler(ABC):
    """A distribution over diffusion timesteps, for variance reduction."""

    @abstractmethod
    def weights(self) -> np.ndarray:
        ...

    def sample(self, batch_size: int, rng: np.random.Generator):
        """Importance-sample timesteps: returns (indices [B], weights [B])."""
        w = self.weights()
        p = w / np.sum(w)
        indices = rng.choice(len(p), size=(batch_size,), p=p)
        weights = 1 / (len(p) * p[indices])
        return indices.astype(np.int32), weights.astype(np.float32)


class UniformSampler(ScheduleSampler):
    def __init__(self, num_timesteps: int):
        self.num_timesteps = num_timesteps
        self._weights = np.ones([num_timesteps])

    def weights(self) -> np.ndarray:
        return self._weights


class LossAwareSampler(ScheduleSampler):
    def update_with_local_losses(self, local_ts, local_losses, group=None):
        """Update the reweighting with every rank's per-example losses,
        gathered in rank order over `group` (default: every rank; a
        training run passes its "data" group); this rank's alone without a
        process group."""
        local_ts = np.asarray(local_ts)
        local_losses = np.asarray(local_losses)
        if dist.is_available() and dist.is_initialized() and dist.get_world_size(group) > 1:
            gathered = [None] * dist.get_world_size(group)
            dist.all_gather_object(gathered, (local_ts, local_losses), group=group)
            local_ts = np.concatenate([g[0].reshape(-1) for g in gathered])
            local_losses = np.concatenate([g[1].reshape(-1) for g in gathered])
        self.update_with_all_losses(local_ts.tolist(), local_losses.tolist())

    @abstractmethod
    def update_with_all_losses(self, ts, losses):
        ...


class LossSecondMomentResampler(LossAwareSampler):
    def __init__(self, num_timesteps, history_per_term=10, uniform_prob=0.001):
        self.num_timesteps = num_timesteps
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob
        self._loss_history = np.zeros(
            [num_timesteps, history_per_term], dtype=np.float64
        )
        self._loss_counts = np.zeros([num_timesteps], dtype=np.int64)

    def weights(self):
        if not self._warmed_up():
            return np.ones([self.num_timesteps], dtype=np.float64)
        weights = np.sqrt(np.mean(self._loss_history**2, axis=-1))
        weights /= np.sum(weights)
        weights *= 1 - self.uniform_prob
        weights += self.uniform_prob / len(weights)
        return weights

    def update_with_all_losses(self, ts, losses):
        for t, loss in zip(ts, losses):
            if self._loss_counts[t] == self.history_per_term:
                self._loss_history[t, :-1] = self._loss_history[t, 1:]
                self._loss_history[t, -1] = loss
            else:
                self._loss_history[t, self._loss_counts[t]] = loss
                self._loss_counts[t] += 1

    def _warmed_up(self):
        return (self._loss_counts == self.history_per_term).all()
