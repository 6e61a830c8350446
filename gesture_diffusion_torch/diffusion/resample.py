"""Timestep schedule samplers, drawn on the host with numpy.

Port of ``gesture_diffusion_tpu/diffusion/resample.py`` for one process:
``UniformSampler`` and the loss-aware ``LossSecondMomentResampler``, which
importance-samples t by the RMS of each timestep's recent losses.  The
trainer draws t with ``sample_np`` and feeds the per-example losses back
through ``update_with_local_losses``.  ``allgather`` (one host-local array
-> the list of every process's array) is injectable; the default is the
identity of a single process.  The multi-process gather comes with
multi-GPU training.
"""

from __future__ import annotations

import numpy as np


def _single_process_gather(x: np.ndarray):
    return [x]


class UniformSampler:
    def __init__(self, num_timesteps: int):
        self.num_timesteps = num_timesteps

    def sample_np(self, rng: np.random.Generator, batch: int):
        """:return: (t indices (batch,) int32, importance weights (batch,))."""
        t = rng.integers(0, self.num_timesteps, size=batch)
        return t.astype(np.int32), np.ones((batch,), np.float32)


class LossSecondMomentResampler:
    """Importance-sample timesteps proportional to the RMS of recent losses."""

    def __init__(self, num_timesteps: int, history_per_term: int = 10,
                 uniform_prob: float = 0.001):
        self.num_timesteps = num_timesteps
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob
        self._loss_history = np.zeros((num_timesteps, history_per_term), np.float64)
        self._loss_counts = np.zeros((num_timesteps,), np.int64)

    def _warmed_up(self) -> bool:
        return (self._loss_counts == self.history_per_term).all()

    def weights(self) -> np.ndarray:
        if not self._warmed_up():
            return np.ones((self.num_timesteps,), np.float64)
        w = np.sqrt(np.mean(self._loss_history**2, axis=-1))
        w /= w.sum()
        w *= 1.0 - self.uniform_prob
        w += self.uniform_prob / len(w)
        return w

    def sample_np(self, rng: np.random.Generator, batch: int):
        w = self.weights()
        p = w / w.sum()
        t = rng.choice(self.num_timesteps, size=batch, p=p)
        wt = 1.0 / (self.num_timesteps * p)
        return t.astype(np.int32), wt[t].astype(np.float32)

    def update_with_local_losses(self, local_ts, local_losses,
                                 allgather=None) -> None:
        """Gather every process's (t, loss) pairs as one (n, 2) float64
        array and apply the same update everywhere, so the histories of all
        processes stay equal."""
        gather = allgather if allgather is not None else _single_process_gather
        pairs = np.stack([np.asarray(local_ts, np.float64),
                          np.asarray(local_losses, np.float64)], axis=1)
        gathered = np.concatenate([np.asarray(a).reshape(-1, 2)
                                   for a in gather(pairs)])
        self.update_with_all_losses(gathered[:, 0].astype(np.int64),
                                    gathered[:, 1])

    def update_with_all_losses(self, ts, losses) -> None:
        for t, loss in zip(np.asarray(ts).tolist(), np.asarray(losses).tolist()):
            if self._loss_counts[t] == self.history_per_term:
                self._loss_history[t, :-1] = self._loss_history[t, 1:]
                self._loss_history[t, -1] = loss
            else:
                self._loss_history[t, self._loss_counts[t]] = loss
                self._loss_counts[t] += 1


def create_named_schedule_sampler(name: str, num_timesteps: int):
    if name == "uniform":
        return UniformSampler(num_timesteps)
    if name == "loss-second-moment":
        return LossSecondMomentResampler(num_timesteps)
    raise NotImplementedError(f"unknown schedule sampler: {name}")
