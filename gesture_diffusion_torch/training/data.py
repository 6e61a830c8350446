"""Array-backed dataset and its batch iterator, for one process.

Port of ``gesture_diffusion_tpu/training/data.py`` without the mesh: the
windowed dataset is a dict of float32 numpy arrays; an epoch is a seeded
permutation cut into drop-last batches.  With the same numpy generator
(``RngStream.numpy("shuffle", epoch)``) the order is the JAX trainer's.
Batches stay numpy; the trainer moves them to its device.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


class ArrayDataset:
    """data: {"wav": (N, T_wav), "pose": (N, T, C)} float32 arrays."""

    def __init__(self, data: Dict[str, np.ndarray]):
        sizes = {k: len(v) for k, v in data.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"ragged dataset: {sizes}")
        self.data = {k: np.asarray(v, np.float32) for k, v in data.items()}

    def __len__(self) -> int:
        return len(next(iter(self.data.values())))

    @property
    def d_pose(self) -> int:
        return self.data["pose"].shape[-1]


def host_slice(indices: np.ndarray, process_index: int,
               process_count: int) -> np.ndarray:
    """This process's contiguous share of a globally identical index batch
    (DistributedSampler semantics); the batch must divide."""
    if len(indices) % process_count:
        raise ValueError(
            f"global batch {len(indices)} not divisible by "
            f"{process_count} hosts")
    per_host = len(indices) // process_count
    return indices[process_index * per_host:(process_index + 1) * per_host]


def iter_batches(
    dataset: ArrayDataset,
    batch_size: int,
    rng: Optional[np.random.Generator] = None,
    shuffle: bool = True,
    drop_last: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield batches of ``batch_size`` rows (the last one short when
    ``drop_last`` is False)."""
    n = len(dataset)
    idx = np.arange(n)
    if shuffle:
        if rng is None:
            raise ValueError("shuffling requires a generator")
        rng.shuffle(idx)
    for b in range(steps_per_epoch(n, batch_size, drop_last)):
        sel = idx[b * batch_size:(b + 1) * batch_size]
        yield {k: v[sel] for k, v in dataset.data.items()}


def steps_per_epoch(dataset_len: int, batch_size: int,
                    drop_last: bool = True) -> int:
    """Number of batches :func:`iter_batches` yields for these settings."""
    return (dataset_len // batch_size if drop_last
            else -(-dataset_len // batch_size))
