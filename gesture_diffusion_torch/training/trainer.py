"""The training loop: train and validation steps as functions over the
model and its optimizer, and the ``Trainer`` around them.

Port of ``gesture_diffusion_tpu/training/trainer.py``:

  * a train step draws t and noise (from generators of the run's seed and
    the step, unless the caller injects them), runs the model in train mode
    (dropout, BatchNorm batch statistics), takes the loss and its
    gradients, the global gradient norm (logged before clipping), clips,
    sets the learning rate to ``lr_schedule(step)`` and steps AdamW;
  * the ``Trainer`` keeps the JAX trainer's semantics and artifacts:
    init or resume, ``start_chkpt``, epochs, the validation loss, best
    params, early stopping, one checkpoint per epoch and the loss-aware
    ``schedule_sampler``.

Data parallelism, one process per device (``parallel/mesh.py``): under a
process group, a group of one included, the step runs the model through
``DistributedDataParallel`` on this rank's rows of the global batch.  It
keeps the JAX package's global-batch semantics: t and noise are drawn for
the whole global batch on every rank and each takes its rows, BatchNorm
and the speed losses see the global batch (``models/speech_encoder.py``,
``training/train_state.py``), and the gradient is DDP's mean before the
norm and the clipping; so N ranks compute what one process computes on
the same global batch.  Validation, early stopping and the best state
read all-reduced losses, so every rank decides the same; rank 0 writes
the checkpoints and metrics.  Without a group the trainer is the
single-process one.

Tensor parallelism (``parallel/tp.py``): a model sharded with
``apply_tensor_parallel`` over a ``make_mesh(n_data, n_model)`` mesh
trains the same way, with the data axis in place of the world: the ranks
of one model group hold the same rows, so the batch split, the global
BatchNorm, the speed losses, DDP's gradient all-reduce and the sampler's
gather run over the data group.  The gradient norm counts each element
of a split parameter once, and checkpoints and best params hold whole
tensors (``full_state_dict``), which load into an unsharded model.

PyTorch runs eagerly, so there is no compiled multi-step call (the JAX
trainer's ``steps_per_call``).  The step reads nothing back to the host
unless it logs or feeds the loss-aware sampler.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import warnings
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from ..diffusion.gaussian import Schedule
from ..diffusion.resample import create_named_schedule_sampler
from ..interop import flax_msgpack
from ..interop.jax_import import jax_params_state_dict
from ..models.denoiser import GestureDenoiser
from ..parallel.mesh import (active_group, collective_device, data_group,
                             is_main_process, model_group)
from ..parallel.tp import (full_optimizer_state, full_state_dict,
                           is_tensor_parallel, shard_optimizer_state,
                           sharded_parameters)
from ..utils.device import resolve_device
from ..utils.profiling import span
from ..utils.rng import RngStream
from .checkpoint import checkpoint_path, load_checkpoint, save_checkpoint
from .data import ArrayDataset, iter_batches
from .metrics import MetricsLogger, generate_run_id
from .train_state import assemble_losses, clip_gradients, global_norm

Batch = Mapping[str, torch.Tensor]


def inpaint_kwargs(model: GestureDenoiser, poses: torch.Tensor) -> dict:
    """The inpaint type's conditioning in training: the clean poses, with
    the first ``pose_seed_len`` frames marked as the visible seed."""
    if model.cfg.model_type != "inpaint":
        return {}
    mask = torch.zeros(poses.shape[:2] + (1,), dtype=poses.dtype,
                       device=poses.device)
    mask[:, :model.cfg.pose_seed_len] = 1.0
    return {"inpaint_pose": poses, "inpaint_mask": mask}


def load_start_params(model: nn.Module, start_chkpt: str) -> int:
    """Fine-tuning start: copy every entry of a checkpoint's
    ``best_params`` (or of a plain state dict) whose name and shape match
    the model's; the rest keep their fresh values and are reported.  A
    ``.msgpack`` is the JAX package's checkpoint (or params tree): its
    ``best_params`` are read as the JAX trainer reads them, parameters
    only, so the BatchNorm statistics keep their fresh values.
    :return: the number of tensors copied."""
    kept = set()
    if start_chkpt.endswith(".msgpack"):
        raw = flax_msgpack.load(start_chkpt)
        source = jax_params_state_dict(raw.get("best_params", raw), model.cfg)
        kept = {k for k, _ in model.named_buffers()}
    else:
        raw = torch.load(start_chkpt, map_location="cpu", weights_only=True)
        source = raw.get("best_params", raw)
    # whole tensors (a collective under tensor parallelism); loading
    # slices them again
    state = full_state_dict(model)
    loaded, new = 0, []
    for key, value in state.items():
        src = source.get(key)
        if torch.is_tensor(src) and tuple(src.shape) == tuple(value.shape):
            state[key] = src.to(value.dtype)
            loaded += 1
        elif key not in kept:
            new.append(key)
    model.load_state_dict(state)
    for name in new:
        print(f"[Warning] New param (fresh init): {name}")
    print(f"[Info] Loaded {loaded} tensors from {start_chkpt}")
    return loaded


@contextlib.contextmanager
def _dropout_seeded(seed: int, device: torch.device, active: bool):
    """Dropout masks drawn from ``seed`` alone; the global RNG state is
    restored afterwards."""
    if not active:
        yield
        return
    with torch.random.fork_rng(
            devices=[device] if device.type == "cuda" else [],
            device_type=device.type):
        torch.manual_seed(seed)
        yield


def _rows(n: int):
    """(global batch, this rank's rows of it) for a local batch of n."""
    rank, world = active_group() or (0, 1)
    return n * world, slice(rank * n, (rank + 1) * n)


def _wrap_ddp(model: nn.Module) -> nn.Module:
    """``model`` in ``DistributedDataParallel`` on its device, over the
    data group.

    ``find_unused_parameters`` stays False: every parameter of every
    decoder and model type gets a gradient in each step
    (``test_every_parameter_gets_a_gradient``), and the search would cost
    a graph walk a step.  ``broadcast_buffers`` is False: the global
    BatchNorm moves every rank's running statistics by the same numbers,
    so there is nothing to broadcast."""
    dev = next(model.parameters()).device
    with warnings.catch_warnings():
        # recent torch renames broadcast_buffers, older has no new name
        warnings.simplefilter("ignore", FutureWarning)
        return nn.parallel.DistributedDataParallel(
            model, device_ids=[dev] if dev.type == "cuda" else None,
            broadcast_buffers=False, find_unused_parameters=False,
            process_group=data_group())


def _mean_over_ranks(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each scalar metric averaged over the data axis (one all-reduce):
    the global batch's loss terms."""
    import torch.distributed as dist

    world = active_group()[1]
    keys = [k for k, v in metrics.items() if v.ndim == 0]
    stacked = torch.stack([metrics[k] for k in keys])
    dist.all_reduce(stacked, group=data_group())
    return {**metrics, **dict(zip(keys, (stacked / world).unbind(0)))}


def make_train_step(
    model: GestureDenoiser,
    sched: Schedule,
    optimizer: torch.optim.Optimizer,
    lr_schedule: Callable[[int], float],
    loss_params: Optional[Dict[str, float]] = None,
    grad_norm_clip_value: Optional[float] = None,
    grad_clip_value: Optional[float] = None,
    seed: int = 0,
):
    """:return: ``train_step(batch, step, t=None, noise=None, weights=None,
    with_per_example=False) -> metrics``, device tensors under the JAX
    step's keys (the loss terms and ``grad_norm``).  ``batch`` holds
    device tensors ``pose`` (N, T, C) and ``wav`` (N, T_wav); t, noise and
    the dropout masks come from ``RngStream(seed)`` at ``step`` unless t
    and noise are given.  The parameters' ``.grad`` keep the step's
    (clipped) gradients until the next step.  Its three phases are spans
    (``utils/profiling.py::span``): ``train_step/forward`` (draws, forward and
    losses), ``train_step/backward`` and ``train_step/optimizer`` (norm,
    clipping and AdamW).

    Under a process group ``batch`` is this rank's rows of the global
    batch; t, noise and ``weights``, drawn or given, are the global
    batch's (N x world rows), of which the step takes its rows; the
    dropout masks come from a stream per (step, rank), rank 0's being the
    single process's; the loss terms are averaged over the ranks, and
    ``mse_per_example`` is this rank's.  Under tensor parallelism "rank"
    is the index on the data axis: a model group's ranks draw alike."""
    rngs = RngStream(seed)
    params = [p for p in model.parameters() if p.requires_grad]
    split = {id(p) for p in sharded_parameters(model)}
    dropout = any(isinstance(m, nn.Dropout) and m.p > 0
                  for m in model.modules())
    group = active_group()
    net = model if group is None else _wrap_ddp(model)
    rank = 0 if group is None else group[0]
    dropout_stream = "train/dropout" if rank == 0 else f"train/dropout/{rank}"

    def train_step(batch: Batch, step: int, t=None, noise=None, weights=None,
                   with_per_example: bool = False) -> Dict[str, torch.Tensor]:
        poses, wav = batch["pose"], batch["wav"]
        dev = poses.device
        n_global, rows = _rows(poses.shape[0])
        with span("train_step/forward"):
            if t is None:
                t = torch.randint(0, sched.num_timesteps, (n_global,),
                                  generator=rngs.torch("train/t", step, dev),
                                  device=dev)
            if noise is None:
                noise = torch.randn((n_global,) + poses.shape[1:],
                                    dtype=poses.dtype, device=dev,
                                    generator=rngs.torch("train/noise", step, dev))
            t, noise = t[rows], noise[rows]
            if weights is not None:
                weights = weights[rows]
            extra = inpaint_kwargs(model, poses)
            model.train()
            optimizer.zero_grad(set_to_none=True)
            with _dropout_seeded(rngs.seed_of(dropout_stream, step), dev, dropout):
                losses = assemble_losses(
                    sched, lambda x_t, tt: net(x_t, tt, wav, **extra), poses,
                    t, noise, loss_params, weights=weights,
                    with_per_example=with_per_example)
        with span("train_step/backward"):
            # under DDP the gradients arrive averaged over the ranks
            losses["loss"].backward()
        with span("train_step/optimizer"):
            grads = [p.grad for p in params if p.grad is not None]
            grad_norm = global_norm(
                [p.grad for p in params if p.grad is not None and id(p) not in split],
                [p.grad for p in params if p.grad is not None and id(p) in split],
                model_group())
            clip_gradients(grads, grad_norm, grad_norm_clip_value, grad_clip_value)
            lr = lr_schedule(step)
            for param_group in optimizer.param_groups:
                param_group["lr"] = lr
            optimizer.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        if group is not None:
            metrics = _mean_over_ranks(metrics)
        metrics["grad_norm"] = grad_norm
        return metrics

    return train_step


def make_val_step(model: GestureDenoiser, sched: Schedule,
                  loss_params: Optional[Dict[str, float]] = None):
    """:return: ``val_step(batch, generator) -> losses``: eval mode, no
    gradients, t and noise drawn from ``generator`` (for the global batch
    under a process group, of which this rank takes its rows)."""

    @torch.no_grad()
    def val_step(batch: Batch, generator: torch.Generator):
        poses, wav = batch["pose"], batch["wav"]
        n_global, rows = _rows(poses.shape[0])
        t = torch.randint(0, sched.num_timesteps, (n_global,),
                          generator=generator, device=poses.device)[rows]
        noise = torch.randn((n_global,) + poses.shape[1:], dtype=poses.dtype,
                            device=poses.device, generator=generator)[rows]
        extra = inpaint_kwargs(model, poses)
        model.eval()
        return assemble_losses(sched, lambda x_t, tt: model(x_t, tt, wav, **extra),
                               poses, t, noise, loss_params)

    return val_step


def _snapshot(model: nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in full_state_dict(model).items()}


class Trainer:
    def __init__(
        self,
        model: GestureDenoiser,
        sched: Schedule,
        optimizer: torch.optim.Optimizer,
        lr_schedule: Callable[[int], float],
        train_dataset: ArrayDataset,
        val_dataset: ArrayDataset,
        batch_size: int,
        log_dir: str,
        seed: int = 0,
        metric: str = "val_loss",
        goal: str = "minimize",
        loss_params: Optional[Dict[str, float]] = None,
        grad_norm_clip_value: Optional[float] = None,
        grad_clip_value: Optional[float] = None,
        log_step_gap: int = 100,
        config: Optional[dict] = None,
        start_chkpt: Optional[str] = None,
        schedule_sampler: Optional[str] = None,
        device=None,
    ):
        """:param optimizer: built over ``model.parameters()`` (e.g. by
        ``make_optimizer``); its learning rate is set from ``lr_schedule``
        before every step.
        :param start_chkpt: fine-tuning: start from another run's best
        weights where names and shapes match (only when this run has no
        checkpoint of its own).
        :param schedule_sampler: ``None``/``"uniform"`` (t drawn on the
        device) or ``"loss-second-moment"`` (t drawn on the host by the
        RMS of recent per-t losses, one device round trip per step).  Its
        history is not checkpointed.
        :param device: the card unless ``"cpu"`` is asked for; under a
        process group (``parallel.init_distributed``) this rank's device,
        and ``batch_size`` is the global batch."""
        if goal not in ("minimize", "maximize"):
            raise ValueError(f"Unsupported goal: {goal}")
        self.group = active_group()
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.sched = sched.to(self.device)
        self.optimizer = optimizer
        self.lr_schedule = lr_schedule
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.batch_size = batch_size
        self.log_dir = log_dir
        self.seed = seed
        self.metric = metric
        self.goal = goal
        self.loss_params = dict(loss_params) if loss_params else None
        self.log_step_gap = log_step_gap
        self.rngs = RngStream(seed)

        self.sampler = None
        if schedule_sampler not in (None, "uniform"):
            # the gather enters each example once only over the data group:
            # over every rank it would enter it n_model times (the layout
            # the JAX trainer refuses, its dedup_local_pairs)
            if is_tensor_parallel(model) and data_group() is None:
                raise ValueError(
                    "schedule_sampler with a tensor-parallel model needs the "
                    "mesh's data group (make_mesh in every rank): per-example "
                    "losses gathered over every rank would enter each example "
                    "once per model rank")
            self.sampler = create_named_schedule_sampler(
                schedule_sampler, sched.num_timesteps)
            self._sampler_rng = self.rngs.numpy("schedule_sampler")

        self._train_step = make_train_step(
            self.model, self.sched, optimizer, lr_schedule, self.loss_params,
            grad_norm_clip_value, grad_clip_value, seed=seed)
        self._val_step = make_val_step(self.model, self.sched, self.loss_params)

        # ---- init or resume --------------------------------------------
        self.chkpt_path = checkpoint_path(log_dir, seed)
        resume = os.path.exists(self.chkpt_path)
        if start_chkpt is not None and not resume:
            load_start_params(self.model, start_chkpt)
        self.best_params = _snapshot(self.model)
        self.epochs_run = 0
        self.best_metric_value = np.inf if goal == "minimize" else -np.inf
        self.run_id = generate_run_id()
        self._step = 0
        if resume:
            tree, meta = load_checkpoint(
                self.chkpt_path, {"model": self.model, "optimizer": optimizer,
                                  "best_params": self.best_params},
                map_location=self.device)
            self.best_params = tree["best_params"]
            shard_optimizer_state(optimizer, self.model)
            self._step = int(tree.get("step", meta.get("train_step", 0)))
            self.epochs_run = meta.get("epochs_run", 0)
            self.best_metric_value = meta.get("best_metric_value",
                                              self.best_metric_value)
            self.run_id = meta.get("run_id", self.run_id)
            self._print(f"[Info] Resuming from {self.chkpt_path} at epoch "
                        f"{self.epochs_run}")

        self.logger = MetricsLogger(log_dir, run_id=self.run_id, config=config)
        if config is not None and is_main_process():
            with open(os.path.join(log_dir, "config.json"), "w") as f:
                json.dump(config, f, indent=2, default=str)
        self.early_stop_counter = 0
        self.early_stop = False

    # ------------------------------------------------------------------
    @property
    def train_step_count(self) -> int:
        return self._step

    def _print(self, text: str) -> None:
        if is_main_process():
            print(text)

    def save(self) -> None:
        save_checkpoint(
            self.chkpt_path,
            {"model": full_state_dict(self.model),
             "optimizer": full_optimizer_state(self.optimizer, self.model),
             "best_params": self.best_params,
             "step": self._step},
            {"train_step": self._step,
             "epochs_run": self.epochs_run,
             "best_metric_value": float(self.best_metric_value),
             "run_id": self.run_id})

    def _to_device(self, batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def _dispatch_step(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """One train step at the current step count; with the loss-aware
        sampler, t and its weights come from the host (drawn for the
        global batch, the same on every rank) and the per-example losses go
        back to it, gathered over the ranks."""
        if self.sampler is None:
            return self._train_step(batch, self._step)
        n_global, rows = _rows(int(batch["pose"].shape[0]))
        t_np, w_np = self.sampler.sample_np(self._sampler_rng, n_global)
        metrics = self._train_step(
            batch, self._step, t=torch.from_numpy(t_np).to(self.device),
            weights=torch.from_numpy(w_np).to(self.device),
            with_per_example=True)
        self.sampler.update_with_local_losses(
            t_np[rows], metrics.pop("mse_per_example").cpu().numpy())
        return metrics

    def train_steps(self, batches: List[Mapping[str, np.ndarray]]
                    ) -> List[Dict[str, torch.Tensor]]:
        """Successive steps on host batches, logged after the last one.
        :return: each step's metrics (device tensors)."""
        first, out = self._step, []
        for batch in batches:
            out.append(self._dispatch_step(self._to_device(batch)))
            self._step += 1
        for i, metrics in enumerate(out):
            self._log_train(first + i, metrics)
        return out

    def _log_train(self, step: int, metrics: Mapping[str, torch.Tensor]) -> None:
        if step % self.log_step_gap:
            return
        record = {f"train/{k}": float(v) for k, v in metrics.items()}
        record["train/step"] = step
        record["train/lr"] = float(self.lr_schedule(step))
        self.logger.log(record, step=step)

    def _run_train_epoch(self) -> None:
        for batch in iter_batches(self.train_dataset, self.batch_size,
                                  rng=self.rngs.numpy("shuffle", self.epochs_run)):
            self.train_steps([batch])

    def _run_val_epoch(self) -> float:
        gen = self.rngs.torch("val", self.epochs_run, self.device)
        sums: Dict[str, float] = {}
        n_batches = 0
        for batch in iter_batches(self.val_dataset, self.batch_size,
                                  shuffle=False):
            # fresh t and noise per batch: the generator moves on
            losses = self._val_step(self._to_device(batch), gen)
            for k, v in losses.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n_batches += 1
        if self.group is not None and sums:
            sums = {k: float(v) for k, v in _mean_over_ranks({
                k: torch.tensor(v, dtype=torch.float64,
                                device=collective_device())
                for k, v in sums.items()}).items()}
        record = {f"val/{k}": v / max(1, n_batches) for k, v in sums.items()}
        record["val/epochs_run"] = self.epochs_run
        metric_value = record[self.metric.replace("_", "/", 1)]
        record[self.metric] = metric_value
        self.logger.log(record, step=self._step)
        return metric_value

    def _update_best(self, metric_value: float, early_stop_threshold: int) -> None:
        improved = (metric_value < self.best_metric_value
                    if self.goal == "minimize"
                    else metric_value > self.best_metric_value)
        if improved:
            self.best_params = _snapshot(self.model)
            self.best_metric_value = metric_value
            self.early_stop_counter = 0
        else:
            self.early_stop_counter += 1
            if self.early_stop_counter >= early_stop_threshold:
                self.early_stop = True
                self._print("[Info] Early stop threshold reached. Stop training.")

    def train(self, max_epochs: int, early_stop_threshold: int = 10**9) -> None:
        for _ in range(self.epochs_run, max_epochs):
            st = time.time()
            self._run_train_epoch()
            metric_value = self._run_val_epoch()
            self.epochs_run += 1
            self._update_best(metric_value, early_stop_threshold)
            self.save()
            self._print(
                f"[Info] Epoch {self.epochs_run}/{max_epochs}"
                f" | step {self._step}"
                f" | {self.metric} {metric_value:.6f}"
                f" | best {self.best_metric_value:.6f}"
                f" | early-stop {self.early_stop_counter}/{early_stop_threshold}"
                f" | {time.time() - st:.2f}s"
            )
            if self.early_stop:
                break
