"""Tensor parallelism over the mesh's "model" axis.

Port of ``gesture_diffusion_tpu/parallel/tp.py``.  The JAX package gives
the decoder's kernels ``NamedSharding``s and lets XLA's partitioner insert
the collectives; the port runs one process per device, so the sharding is
explicit, in Megatron's form:

  * ``_spec_for`` is JAX's rule on the port's names: the 2-D kernel of a
    Q/K/V projection or of an FF's first layer is column-parallel (its
    output features split over the model ranks) when they divide, that of
    an attention output or an FF's second layer row-parallel (its input
    features split); everything else, biases, depthwise convs and
    LayerNorms included, is replicated;
  * ``apply_tensor_parallel`` swaps each such ``Linear`` for a
    ``ColumnParallelLinear`` or ``RowParallelLinear`` holding its slice.
    A column-parallel layer also slices its bias; a row-parallel one adds
    its bias once, after the all-reduce.  Attention whose heads divide
    keeps ``heads / n_model`` heads a rank; where only ``d_model`` divides,
    a head straddles two ranks, so Q/K/V are gathered and the attention
    runs whole on every rank, as JAX computes it.  The depthwise conv on
    Q/K/V stays whole (its taps are shared by every head); with heads
    split its gradient is summed over the model group.  Dropout on the
    attention probabilities and the FF hidden layer draws the whole
    unsharded mask from the step's seed and keeps this rank's slice, so a
    tensor-parallel step equals the unsharded one, dropout included;
  * ``full_state_dict`` gathers the slices: checkpoints hold whole tensors
    under the reference's names and load into an unsharded model, and a
    parallel layer slices a whole tensor when it loads one.

The four collectives are ``autograd.Function``s: copy (identity forward,
all-reduce backward), reduce (all-reduce forward, identity backward),
gather (all-gather forward, slice backward) and scatter (slice forward,
all-gather backward).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..models.compute_dtype import Linear
from .mesh import Mesh, model_axis, model_group

# name tails (module path + parameter) of the port's modules: JAX
# "query/kernel" is "query.0.linear.weight", "ff/layer1" "feed_forward.layer1"
_COLUMN_PARALLEL = ("query.0.linear.weight", "key.0.linear.weight",
                    "value.0.linear.weight", "layer1.weight")
_ROW_PARALLEL = ("output.weight", "layer2.weight")


def _ends_with(name: str, tails) -> bool:
    parts = name.split(".")
    return any(parts[-len(t.split(".")):] == t.split(".") for t in tails)


def _spec_for(name: str, shape, n_model: int) -> str:
    """"column", "row" or "replicated" for a parameter; torch's (out, in)
    weight is JAX's (in, out) kernel transposed."""
    if len(shape) == 2:
        if _ends_with(name, _COLUMN_PARALLEL) and shape[0] % n_model == 0:
            return "column"
        if _ends_with(name, _ROW_PARALLEL) and shape[1] % n_model == 0:
            return "row"
    return "replicated"


def tensor_parallel_plan(model: nn.Module, mesh: Mesh) -> Dict[str, str]:
    """Parameter name -> "column", "row" or "replicated" over the mesh's
    model axis (all replicated without one).  A column-parallel layer's
    bias is "column": the port slices it with its weight."""
    n_model = mesh.shape["model"]
    params = dict(model.named_parameters())
    plan = {k: _spec_for(k, tuple(p.shape), n_model) if n_model > 1
            else "replicated" for k, p in params.items()}
    for k, spec in list(plan.items()):
        bias = k[:-len("weight")] + "bias"
        if spec == "column" and bias in plan:
            plan[bias] = "column"
    return plan


# -- collectives with their gradients -------------------------------------------

def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    size = x.shape[dim] // n
    return x.narrow(dim, r * size, size).contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, group, -1)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.group, -1), None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _slice(x, group, -1)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, -1), None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; the backward sums the gradient over ``group``."""
    return _Copy.apply(x, group)


# -- the parallel layers -------------------------------------------------------------

class _ParallelLinear(Linear):
    """A ``Linear`` holding this rank's slice of a whole one.  ``dims``:
    parameter name -> the dimension it is split along."""

    dims: Dict[str, int] = {}

    def __init__(self, full: nn.Linear, group, n_model: int, rank: int):
        out_f, in_f = full.weight.shape
        if "weight" in self.dims and self.dims["weight"] == 0:
            out_f //= n_model
        else:
            in_f //= n_model
        super().__init__(in_f, out_f, full.bias is not None,
                         getattr(full, "compute_dtype", None))
        self.group, self.n_model, self.rank = group, n_model, rank
        self.to(full.weight.device, full.weight.dtype)
        with torch.no_grad():
            for name, p in self.named_parameters(recurse=False):
                src = getattr(full, name)
                p.copy_(self._local(name, src))
                p.tp_dim = self.dims.get(name)

    def _local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        dim = self.dims.get(name)
        if dim is None or t.shape[dim] == getattr(self, name).shape[dim]:
            return t
        size = t.shape[dim] // self.n_model
        return t.narrow(dim, self.rank * size, size)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # a whole tensor (a checkpoint) is sliced; this rank's slice is kept
        for name in self.dims:
            key = prefix + name
            if key in state_dict:
                state_dict[key] = self._local(name, state_dict[key])
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class ColumnParallelLinear(_ParallelLinear):
    """This rank's output features; the input's gradient is summed over
    the model group.  ``gather_output`` gathers the whole output."""

    dims = {"weight": 0, "bias": 0}

    def __init__(self, full: nn.Linear, group, n_model: int, rank: int,
                 gather_output: bool = False):
        super().__init__(full, group, n_model, rank)
        self.gather_output = gather_output

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(_Copy.apply(x, self.group))
        return _Gather.apply(y, self.group) if self.gather_output else y


class RowParallelLinear(_ParallelLinear):
    """This rank's input features; the partial products are summed over
    the model group, then the bias is added.  Without
    ``input_is_parallel`` it takes the whole input and keeps its slice."""

    dims = {"weight": 1}

    def __init__(self, full: nn.Linear, group, n_model: int, rank: int,
                 input_is_parallel: bool = True):
        super().__init__(full, group, n_model, rank)
        self.input_is_parallel = input_is_parallel

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.input_is_parallel:
            x = _Scatter.apply(x, self.group)
        dt = self.compute_dtype or x.dtype
        y = _Reduce.apply(F.linear(x.to(dt), self.weight.to(dt)), self.group)
        return y if self.bias is None else y + self.bias.to(dt)


class ShardedDropout(nn.Module):
    """Dropout on this rank's slice (along the last dimension) of a
    tensor split over ``n_model`` ranks: the whole tensor's mask is drawn,
    as ``nn.Dropout`` on the unsharded tensor draws it, and sliced."""

    def __init__(self, p: float, n_model: int, rank: int):
        super().__init__()
        self.p, self.n_model, self.rank = p, n_model, rank

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0:
            return x
        size = x.shape[-1]
        mask = F.dropout(x.new_ones(x.shape[:-1] + (size * self.n_model,)),
                         self.p, True)
        return x * mask.narrow(-1, self.rank * size, size)


def apply_tensor_parallel(model: nn.Module, mesh: Mesh) -> Dict[str, str]:
    """Shard ``model`` in place over ``mesh``'s model axis, this process
    holding the slices of its model index; ``mesh`` must come from
    ``make_mesh`` inside the process group (which makes its axes this
    process's).  Every rank starts from the same whole weights.
    :return: the plan (``tensor_parallel_plan``)."""
    from ..models.attention import FeedForward, MultiHeadAttention

    plan = tensor_parallel_plan(model, mesh)
    n_model = mesh.shape["model"]
    if n_model == 1:
        return plan
    rank, axis = model_axis()
    if axis != n_model:
        raise ValueError(
            f"this process has no {mesh.shape} axes: call make_mesh in every "
            f"rank of a process group of {len(mesh.devices)} ranks")
    group = model_group()

    def spec(prefix: str) -> str:
        return plan.get(f"{prefix}.weight", "replicated")

    done = set()
    for prefix, module in list(model.named_modules()):
        if isinstance(module, MultiHeadAttention):
            projs = [getattr(module, n)[0] for n in ("query", "key", "value")]
            specs = {spec(f"{prefix}.{n}.0.linear")
                     for n in ("query", "key", "value")}
            out = spec(f"{prefix}.output")
            if specs == {"replicated"} and out == "replicated":
                continue
            if specs != {"column"} or out != "row":
                raise ValueError(f"{prefix}: Q/K/V {sorted(specs)} and output "
                                 f"{out} must be sharded together")
            by_heads = module.heads % n_model == 0
            for name, p in zip(("query", "key", "value"), projs):
                p.linear = ColumnParallelLinear(p.linear, group, n_model, rank,
                                                gather_output=not by_heads)
                done.add(f"{prefix}.{name}.0.linear")
                if by_heads:
                    p.heads //= n_model
                    getattr(module, name)[1].model_group = group
            module.output = RowParallelLinear(module.output, group, n_model, rank,
                                              input_is_parallel=by_heads)
            done.add(f"{prefix}.output")
            if by_heads:
                module.dropout = ShardedDropout(module.dropout.p, n_model, rank)
        elif isinstance(module, FeedForward):
            first, second = spec(f"{prefix}.layer1"), spec(f"{prefix}.layer2")
            if first == second == "replicated":
                continue
            if first != "column" or second != "row":
                raise ValueError(f"{prefix}: layer1 {first} and layer2 {second} "
                                 "must be sharded together")
            module.layer1 = ColumnParallelLinear(module.layer1, group, n_model, rank)
            module.layer2 = RowParallelLinear(module.layer2, group, n_model, rank)
            module.dropout = ShardedDropout(module.dropout.p, n_model, rank)
            done |= {f"{prefix}.layer1", f"{prefix}.layer2"}
    stray = sorted(k for k, s in plan.items() if s != "replicated"
                   and k.rsplit(".", 1)[0] not in done)
    if stray:
        raise ValueError(f"sharded by the rule but in no attention or FF "
                         f"block: {stray[:4]}")
    return plan


def is_tensor_parallel(model: nn.Module) -> bool:
    return any(isinstance(m, _ParallelLinear) for m in model.modules())


def _parallel_tensors(model: nn.Module):
    """(state-dict key, module, parameter name) of every split tensor."""
    for prefix, module in model.named_modules():
        if isinstance(module, _ParallelLinear):
            for name in module.dims:
                if getattr(module, name, None) is not None:
                    yield f"{prefix}.{name}", module, name


def gather_full(model: nn.Module, tensors: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """``tensors`` (keyed by ``model``'s state-dict names, e.g. its
    parameters' gradients) with every split one gathered whole (a
    collective: every rank of the model group calls it)."""
    tensors = dict(tensors)
    for key, module, name in _parallel_tensors(model):
        if key in tensors:
            tensors[key] = _all_gather(tensors[key].detach(), module.group,
                                       module.dims[name])
    return tensors


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every split tensor gathered whole (a
    collective, as ``gather_full``); the state dict itself for an
    unsharded model."""
    state = model.state_dict()
    return state if not is_tensor_parallel(model) else type(state)(
        gather_full(model, state))


def full_optimizer_state(optimizer: torch.optim.Optimizer,
                         model: nn.Module) -> dict:
    """``optimizer.state_dict()`` with the moments of split parameters
    gathered whole (a collective, as ``full_state_dict``)."""
    state = optimizer.state_dict()
    index = {id(p): i for i, p in enumerate(
        p for g in optimizer.param_groups for p in g["params"])}
    for _, module, name in _parallel_tensors(model):
        i = index[id(getattr(module, name))]
        if i in state["state"]:
            # a new dict: the state dict shares the live ones
            state["state"][i] = {
                k: _all_gather(v, module.group, module.dims[name])
                if torch.is_tensor(v) and v.dim() else v
                for k, v in state["state"][i].items()}
    return state


def shard_optimizer_state(optimizer: torch.optim.Optimizer,
                          model: nn.Module) -> None:
    """After loading whole moments (``full_optimizer_state``), keep this
    rank's slices."""
    for _, module, name in _parallel_tensors(model):
        param = getattr(module, name)
        for k, v in optimizer.state.get(param, {}).items():
            if torch.is_tensor(v) and v.dim() and v.shape != param.shape:
                optimizer.state[param][k] = module._local(name, v).clone()


def sharded_parameters(model: nn.Module):
    """The parameters that hold a slice (their ``tp_dim`` is set)."""
    return [p for p in model.parameters() if getattr(p, "tp_dim", None) is not None]
