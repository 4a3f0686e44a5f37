"""Timestep schedule samplers (host-side numpy).

A copy of ``motiondiffusion_moe_tpu/diffusion/samplers.py`` (importing it
would pull in JAX through the package ``__init__``): uniform,
loss-second-moment resampling and the EMA-based adaptive sampler. The
sampled ``t`` goes to the device as a tensor; the loss history stays on the
host. Over several processes (``parallel/``), ``update_with_local_losses``
gathers every process's (t, loss) pairs in rank order before it updates, as
the JAX package's ``process_allgather`` does, so every rank's sampler holds
the same history.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional, Tuple

import numpy as np


class ScheduleSampler(ABC):
    """Distribution over diffusion timesteps (importance sampling)."""

    def __init__(self, num_timesteps: int):
        self.num_timesteps = num_timesteps

    @abstractmethod
    def weights(self) -> np.ndarray:
        """Positive, not-necessarily-normalized weights, one per step."""

    def sample(self, batch_size: int,
               rng: Optional[np.random.Generator] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Importance-sample (timesteps, loss weights) for a batch."""
        rng = rng or np.random.default_rng()
        w = self.weights()
        p = w / np.sum(w)
        indices = rng.choice(len(p), size=(batch_size,), p=p)
        weights = 1.0 / (len(p) * p[indices])
        return indices.astype(np.int32), weights.astype(np.float32)


class UniformSampler(ScheduleSampler):
    def __init__(self, num_timesteps: int):
        super().__init__(num_timesteps)
        self._weights = np.ones([num_timesteps], dtype=np.float64)

    def weights(self) -> np.ndarray:
        return self._weights


class LossAwareSampler(ScheduleSampler):
    """Base for the loss-adaptive samplers."""

    def update_with_local_losses(self, local_ts: np.ndarray,
                                 local_losses: np.ndarray) -> None:
        """Gather the processes' (t, loss) pairs in rank order (in one
        process, the local pairs are all of them), then update."""
        from motiondiffusion_moe_tpu_torch.parallel.distributed import (
            allgather_numpy, world_size)

        ts, losses = np.asarray(local_ts), np.asarray(local_losses)
        if world_size() > 1:
            ts, losses = allgather_numpy(ts), allgather_numpy(losses)
        self.update_with_all_losses(ts, losses)

    @abstractmethod
    def update_with_all_losses(self, ts: np.ndarray,
                               losses: np.ndarray) -> None:
        ...


class LossSecondMomentResampler(LossAwareSampler):
    """p(t) ~ sqrt(E[loss^2]) with a 10-deep history per term."""

    def __init__(self, num_timesteps: int, history_per_term: int = 10,
                 uniform_prob: float = 0.001):
        super().__init__(num_timesteps)
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob
        self._loss_history = np.zeros([num_timesteps, history_per_term],
                                      dtype=np.float64)
        self._loss_counts = np.zeros([num_timesteps], dtype=np.int64)

    def weights(self) -> np.ndarray:
        if not self._warmed_up():
            return np.ones([self.num_timesteps], dtype=np.float64)
        weights = np.sqrt(np.mean(self._loss_history ** 2, axis=-1))
        weights /= np.sum(weights)
        weights *= 1 - self.uniform_prob
        weights += self.uniform_prob / len(weights)
        return weights

    def update_with_all_losses(self, ts, losses) -> None:
        for t, loss in zip(np.asarray(ts).tolist(),
                           np.asarray(losses).tolist()):
            if self._loss_counts[t] == self.history_per_term:
                self._loss_history[t, :-1] = self._loss_history[t, 1:]
                self._loss_history[t, -1] = loss
            else:
                self._loss_history[t, self._loss_counts[t]] = loss
                self._loss_counts[t] += 1

    def _warmed_up(self) -> bool:
        return bool((self._loss_counts == self.history_per_term).all())


class AdaptiveLossSampler(LossAwareSampler):
    """EMA-of-squared-losses sampler with warmup."""

    def __init__(self, num_timesteps: int, alpha: float = 0.9,
                 uniform_prob: float = 0.001, warmup_ratio: float = 0.2):
        super().__init__(num_timesteps)
        self.alpha = alpha
        self.uniform_prob = uniform_prob
        self.warmup_cutoff = int(num_timesteps * warmup_ratio)
        self.ema_losses = np.zeros([num_timesteps], dtype=np.float64)
        self.ema_counts = np.zeros([num_timesteps], dtype=np.float64)
        self._step_count = 0

    def weights(self) -> np.ndarray:
        if self._step_count < self.warmup_cutoff:
            return np.ones([self.num_timesteps], dtype=np.float64)
        w = np.sqrt(self.ema_losses / np.maximum(self.ema_counts, 1e-8))
        w = w / (w.sum() + 1e-8)
        w = w * (1 - self.uniform_prob) + self.uniform_prob / self.num_timesteps
        return w

    def update_with_all_losses(self, ts, losses) -> None:
        self._step_count += 1
        for t, loss in zip(np.asarray(ts).tolist(),
                           np.asarray(losses).tolist()):
            sq = loss ** 2
            self.ema_counts[t] = (self.alpha * self.ema_counts[t]
                                  + (1 - self.alpha))
            self.ema_losses[t] = (self.alpha * self.ema_losses[t]
                                  + (1 - self.alpha) * sq)


def create_named_schedule_sampler(name: str,
                                  num_timesteps: int) -> ScheduleSampler:
    if name == "uniform":
        return UniformSampler(num_timesteps)
    if name == "loss-second-moment":
        return LossSecondMomentResampler(num_timesteps)
    if name in ("adaptive-loss", "adaptive"):
        return AdaptiveLossSampler(num_timesteps)
    raise NotImplementedError(f"unknown schedule sampler: {name}")
