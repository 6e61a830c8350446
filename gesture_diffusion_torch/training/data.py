"""Array-backed dataset and its batch iterator.

Port of ``gesture_diffusion_tpu/training/data.py``: the windowed dataset
is a dict of float32 numpy arrays; an epoch is a seeded permutation cut
into drop-last batches.  With the same numpy generator
(``RngStream.numpy("shuffle", epoch)``) the order is the JAX trainer's.
Under data parallelism every process draws the same permutation and takes
its contiguous share of each global batch (``host_slice``), the rows the
JAX package gives process r of N.  Batches stay numpy; the trainer moves
them to its device.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from ..parallel.mesh import active_group


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
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield this process's rows of each global batch of ``batch_size``:
    the whole batch for one process, its ``host_slice`` for one of
    several.  Every full batch must divide over the processes (one per
    device, so the JAX package's least common multiple of hosts and data
    axis is the process count); a ragged final batch (``drop_last``
    False) is cut to the largest size that divides, and dropped if
    nothing is left, as the JAX package cuts it.

    ``process_index``/``process_count`` default to this process's group
    (``torch.distributed``; 0 of 1 without one); pass them to lay out
    another process's rows."""
    group = active_group() or (0, 1)
    process_index = group[0] if process_index is None else process_index
    process_count = group[1] if process_count is None else process_count
    n = len(dataset)
    idx = np.arange(n)
    if shuffle:
        if rng is None:
            raise ValueError("shuffling requires a generator")
        rng.shuffle(idx)
    divisor = process_count
    if batch_size % divisor:
        raise ValueError(
            f"batch_size {batch_size} not divisible by {divisor} "
            f"({process_count} hosts x data axis 1)")
    for b in range(steps_per_epoch(n, batch_size, drop_last)):
        sel = idx[b * batch_size:(b + 1) * batch_size]
        if len(sel) % divisor:
            sel = sel[: len(sel) - len(sel) % divisor]
            if len(sel) == 0:
                continue
        if process_count > 1:
            sel = host_slice(sel, process_index, process_count)
        yield {k: v[sel] for k, v in dataset.data.items()}


def steps_per_epoch(dataset_len: int, batch_size: int,
                    drop_last: bool = True) -> int:
    """Number of batches :func:`iter_batches` yields for these settings
    (before a ragged final batch is cut to divide, which can drop it)."""
    return (dataset_len // batch_size if drop_last
            else -(-dataset_len // batch_size))
