from .checkpoint import (checkpoint_path, load_checkpoint, read_checkpoint,
                         save_checkpoint)
from .data import ArrayDataset, host_slice, iter_batches, steps_per_epoch
from .lr_schedule import build_lr_schedule, noam_decay_schedule, noam_xf_schedule
from .metrics import MetricsLogger
from .train_state import (assemble_losses, clip_gradients, global_norm,
                          make_adamw, make_optimizer, smooth_l1,
                          wasserstein_distance_1d)
from .trainer import (Trainer, inpaint_kwargs, load_start_params,
                      make_train_step, make_val_step)

__all__ = [
    "checkpoint_path", "load_checkpoint", "read_checkpoint", "save_checkpoint",
    "ArrayDataset", "host_slice", "iter_batches", "steps_per_epoch",
    "build_lr_schedule", "noam_decay_schedule", "noam_xf_schedule",
    "MetricsLogger",
    "assemble_losses", "clip_gradients", "global_norm", "make_adamw",
    "make_optimizer", "smooth_l1", "wasserstein_distance_1d",
    "Trainer", "inpaint_kwargs", "load_start_params", "make_train_step",
    "make_val_step",
]
