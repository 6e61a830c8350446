"""Timestep schedule samplers, drawn on the host with numpy.

Port of ``gesture_diffusion_tpu/diffusion/resample.py``: ``UniformSampler``
and the loss-aware ``LossSecondMomentResampler``, which importance-samples
t by the RMS of each timestep's recent losses.  The trainer draws t with
``sample_np`` and feeds the per-example losses back through
``update_with_local_losses``, which gathers every process's (t, loss)
pairs and applies the same update on each, so the histories, the weights
and the next draw stay equal across processes.  ``allgather`` (one
process-local array -> the list of every process's array, in rank order)
is injectable; the default is ``torch.distributed``'s over the data
axis (``parallel.mesh.data_group``: under tensor parallelism a model
group's ranks hold the same rows, so each example enters once), and the
identity without a group.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.mesh import active_group, collective_device, data_group


def _default_allgather(x: np.ndarray):
    """Every process's array, in rank order (the identity for one
    process).  The lengths may differ: they are gathered first, each
    array is padded to the longest for the gather, and the padding is
    stripped after it, as the JAX package's gather does."""
    group = active_group()
    if group is None or group[1] == 1:
        return [x]
    world = group[1]
    dev = collective_device()
    x = np.asarray(x)
    length = torch.tensor([len(x)], dtype=torch.int64, device=dev)
    lengths = [torch.empty_like(length) for _ in range(world)]
    dist.all_gather(lengths, length, group=data_group())
    lengths = [int(v) for v in lengths]
    longest = max(lengths)
    if longest == 0:
        return [x for _ in range(world)]
    padded = np.zeros((longest,) + x.shape[1:], x.dtype)
    padded[:len(x)] = x
    local = torch.from_numpy(padded).to(dev)
    parts = [torch.empty_like(local) for _ in range(world)]
    dist.all_gather(parts, local, group=data_group())
    return [p[:n].cpu().numpy() for p, n in zip(parts, lengths)]


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
        gather = allgather if allgather is not None else _default_allgather
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
