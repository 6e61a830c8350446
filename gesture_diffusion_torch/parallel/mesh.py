"""Process groups and the ("data", "model") device mesh.

Port of ``gesture_diffusion_tpu/parallel/mesh.py``.  The JAX package spans
devices with one ``jax.sharding.Mesh`` and lets XLA insert the collectives;
the port runs one process per GPU (``torch.distributed``, NCCL on the card
and gloo on the CPU), as the reference's DDP did, and keeps the mesh as a
small object that names the devices of the data axis:

  * ``init_distributed`` joins this process to its group (env:// under
    torchrun, or an explicit ``tcp://`` address) and returns its rank;
  * ``make_mesh`` lays the devices out as JAX's ``reshape(n_data,
    n_model)`` does: rank r is data index ``r // n_model`` and model index
    ``r % n_model``.  A training run puts rank r on ``mesh.devices[r]``; a
    ``Generator`` over a data-only mesh runs one kernel instance per
    device on its share of the batch.  Inside a process group of
    ``n_data * n_model`` ranks with ``n_model > 1`` it also builds the
    data and the model subgroups and makes them this process's axes;
  * ``split_batch`` and ``replicate`` stand where ``shard_batch`` and
    ``replicate`` stand: a batch cut into one piece per device, and a copy
    per device;
  * ``active_group`` is what the training path asks to decide between the
    single-process step and the distributed one (global BatchNorm, the
    batch-global speed losses, DDP): this process's place on the data
    axis.  ``data_group`` is the group their collectives run over (the
    world without a model axis), ``model_group`` the one the tensor-
    parallel layers of ``parallel/tp.py`` run over.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices of the mesh, rank order: (data, model) row-major.  A
    device may repeat: two shards on one card is how a machine with one
    GPU runs the sharded paths (two kernel launches, or two ranks over
    gloo)."""

    devices: Tuple[torch.device, ...]
    n_model: int = 1

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices) // self.n_model, "model": self.n_model}

    @property
    def data_devices(self) -> Tuple[torch.device, ...]:
        """The first device of each data row."""
        return self.devices[::self.n_model]


@dataclasses.dataclass(frozen=True)
class _Axes:
    data: Any            # this process's data group (the ranks of its model index)
    model: Any           # this process's model group (the ranks of its data row)
    data_rank: int
    n_data: int
    model_rank: int
    n_model: int


_AXES: Optional[_Axes] = None     # set by make_mesh under a model axis


def _visible_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass devices=['cpu', ...] for a mesh of "
            "CPU processes")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence[Any]] = None) -> Mesh:
    """An ``n_data x n_model`` mesh over ``devices`` (every visible GPU
    by default).  The implicit size uses every device; an explicit
    ``n_data`` may use fewer, never more.  Raises as the JAX
    ``make_mesh`` does.  Called by every rank of a process group of
    ``n_data * n_model`` ranks with ``n_model > 1``, it builds the groups
    of both axes (every rank creates every group, in one order) and makes
    them this process's axes (``active_group``, ``data_group``,
    ``model_group``)."""
    devices = [torch.device(d) for d in (
        _visible_devices() if devices is None else devices)]
    if n_data is None:
        if len(devices) % n_model:
            raise ValueError(
                f"{len(devices)} devices not divisible by n_model="
                f"{n_model}; pass n_data explicitly to use a subset")
        n_data = len(devices) // n_model
    if n_data < 1:
        raise ValueError(f"mesh {n_data}x{n_model}: the data axis needs at "
                         "least one device")
    if n_data * n_model > len(devices):
        raise ValueError(
            f"mesh {n_data}x{n_model} needs {n_data * n_model} devices, "
            f"have {len(devices)}")
    devices = tuple(devices[:n_data * n_model])
    if n_model == 1 or not (dist.is_available() and dist.is_initialized()):
        return Mesh(devices, n_model)
    global _AXES
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n_data * n_model:
        raise ValueError(f"mesh {n_data}x{n_model} needs a process group of "
                         f"{n_data * n_model} ranks, this one has {world}")
    data_index, model_index = divmod(rank, n_model)
    model = data = None
    for d in range(n_data):
        group = dist.new_group([d * n_model + m for m in range(n_model)])
        if d == data_index:
            model = group
    for m in range(n_model):
        group = dist.new_group([d * n_model + m for d in range(n_data)])
        if m == model_index:
            data = group
    _AXES = _Axes(data, model, data_index, n_data, model_index, n_model)
    return Mesh(devices, n_model)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        leaves = [_map(fn, v) for v in tree]
        # a NamedTuple takes its fields one by one
        return type(tree)(*leaves) if hasattr(tree, "_fields") else type(tree)(leaves)
    return None if tree is None else fn(tree)


def split_batch(batch, mesh: Mesh) -> list:
    """One piece of ``batch`` (a tensor or a dict/list/tuple of (N, ...)
    tensors, None kept) per device of the data axis: rows [s*N/n,
    (s+1)*N/n) on ``mesh.devices[s]``.  N must divide."""
    n = mesh.shape["data"]
    sizes = set()
    _map(lambda x: sizes.add(x.shape[0]), batch)
    if len(sizes) != 1:
        raise ValueError(f"batch leaves disagree on the batch size: {sorted(sizes)}")
    size = sizes.pop()
    if size % n:
        raise ValueError(f"batch {size} not divisible by the data axis {n}")
    per = size // n
    return [_map(lambda x, s=s, d=d: x[s * per:(s + 1) * per].to(d), batch)
            for s, d in enumerate(mesh.data_devices)]


def replicate(tree, mesh: Mesh) -> list:
    """A copy of ``tree`` per device of the data axis (the tensors
    themselves where they already are there); a device that repeats
    shares one copy."""
    copies = {}
    for d in mesh.data_devices:
        if d not in copies:
            copies[d] = _map(lambda x, d=d: x.to(d), tree)
    return [copies[d] for d in mesh.data_devices]


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device=None) -> int:
    """Join this process to its group and return its rank; a no-op (rank
    0) for one process.

    Without arguments the group comes from torchrun's variables
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``; env://),
    and one process (no ``WORLD_SIZE``) is no group.  With
    ``coordinator_address`` (``host:port``) the group is
    ``tcp://coordinator_address`` with ``num_processes`` ranks, this one
    ``process_id``; an address with one process makes a group of one, the
    distributed path at world size 1.  ``device`` is this rank's device
    (``cuda:<LOCAL_RANK>`` under torchrun when CUDA is present, else the
    CPU): it picks the backend, NCCL or gloo, unless ``backend`` is given
    (gloo also serves CUDA tensors, which lets two ranks share one card),
    and a CUDA device becomes the current one."""
    global _AXES
    if dist.is_initialized():
        return dist.get_rank()
    _AXES = None
    if coordinator_address is None:
        if num_processes is not None and num_processes > 1:
            raise ValueError(f"{num_processes} processes need a "
                             "coordinator_address")
        if "WORLD_SIZE" not in os.environ:
            return 0
        init_method = "env://"
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
        if device is None:
            local = int(os.environ.get("LOCAL_RANK", process_id))
            device = (torch.device("cuda", local) if torch.cuda.is_available()
                      else torch.device("cpu"))
    else:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and "
                             "process_id")
        init_method = f"tcp://{coordinator_address}"
    device = torch.device("cpu" if device is None else device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"),
                            init_method=init_method,
                            world_size=int(num_processes),
                            rank=int(process_id))
    return dist.get_rank()


def active_group() -> Optional[Tuple[int, int]]:
    """(index, size) of this process on the data axis, None without a
    process group: its (rank, world size), or under a model axis its
    data row and the number of rows.  A group of one counts: it takes the
    distributed path."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    if _AXES is not None:
        return _AXES.data_rank, _AXES.n_data
    return dist.get_rank(), dist.get_world_size()


def data_group():
    """The group of the data axis' collectives: the world (None) without
    a model axis."""
    return None if _AXES is None else _AXES.data


def model_group():
    """This process's model group, None without a model axis."""
    return None if _AXES is None else _AXES.model


def model_axis() -> Tuple[int, int]:
    """(index, size) of this process on the model axis; (0, 1) without
    one."""
    return (0, 1) if _AXES is None else (_AXES.model_rank, _AXES.n_model)


def is_main_process() -> bool:
    """Rank 0, or no group: the process that writes files."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def collective_device() -> torch.device:
    """Where this group's collectives take their tensors: the current CUDA
    device under NCCL, else the CPU (gloo)."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data axis, with its gradient: the backward
    sums the ranks' gradients (``torch.distributed.nn.functional.all_reduce``,
    which recent torch marks deprecated in favour of a private module)."""
    from torch.distributed.nn.functional import all_reduce

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return all_reduce(x, group=data_group() or dist.group.WORLD)
