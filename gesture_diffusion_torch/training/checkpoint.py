"""Checkpoints: one file per run and seed, plus a JSON sidecar.

The torch counterpart of ``gesture_diffusion_tpu/training/checkpoint.py``:
``chkpts/chkpt_seed{seed}.pt`` holds a dict of state dicts (``torch.save``)
and ``.meta.json`` beside it the scalar metadata (step, epochs_run,
best_metric_value, run_id), readable without loading the weights.  Both are
written to a temporary file and moved into place with ``os.replace``, so a
crash never leaves a torn file.  Errors name the file and tell a corrupt
file (move it aside) from one that is intact but saved under another model
or optimizer structure (fix the config, keep the file).  Under a process
group rank 0 writes, and every rank waits for it at a barrier, so that
all of them resume from the same whole file.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Tuple

import torch
import torch.distributed as dist

from ..parallel.mesh import active_group, is_main_process


def checkpoint_path(log_dir: str, seed: int) -> str:
    return os.path.join(log_dir, "chkpts", f"chkpt_seed{seed}.pt")


def save_checkpoint(path: str, tree: Dict[str, Any],
                    metadata: Dict[str, Any]) -> None:
    """``tree``: name -> state dict (or any object ``torch.save`` takes
    and ``torch.load(weights_only=True)`` reads back).  Every rank of a
    process group calls it; rank 0 writes."""
    if is_main_process():
        _write(path, tree, metadata)
    if active_group() is not None:
        dist.barrier()


def _write(path: str, tree: Dict[str, Any], metadata: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)
    # a crash between the two replaces pairs new weights with the previous
    # metadata (resume re-runs at most one epoch), never with a torn JSON
    meta_tmp = path + ".meta.json.tmp"
    with open(meta_tmp, "w") as f:
        json.dump(metadata, f, indent=2)
    os.replace(meta_tmp, path + ".meta.json")


def _brief(e: Exception) -> str:
    """The exception's type and its first two lines (torch's load errors
    run to pages)."""
    lines = [line.strip() for line in str(e).splitlines() if line.strip()]
    return f"{type(e).__name__}: {' '.join(lines[:2])[:300]}"


def read_checkpoint(path: str, map_location=None
                    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(tree, metadata) of a checkpoint; a file that does not unpickle, or
    whose metadata is not JSON, raises ``ValueError`` naming it."""
    try:
        tree = torch.load(path, map_location=map_location, weights_only=True)
    except Exception as e:  # any unreadable file: torn, truncated, not ours
        raise ValueError(
            f"{path}: corrupt or unreadable checkpoint ({_brief(e)}); move it "
            "aside to start fresh") from e
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: corrupt or unreadable checkpoint (a "
                         f"{type(tree).__name__}, not a dict); move it aside "
                         "to start fresh")
    metadata = {}
    meta_path = path + ".meta.json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            try:
                metadata = json.load(f)
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"{meta_path}: corrupt checkpoint metadata ({e}); "
                    "move it aside to start fresh") from e
    return tree, metadata


def _check_like(name: str, saved: Mapping[str, torch.Tensor],
                like: Mapping[str, torch.Tensor]) -> None:
    """KeyError/ValueError unless ``saved`` has ``like``'s names and shapes."""
    if set(saved) != set(like):
        missing, extra = set(like) - set(saved), set(saved) - set(like)
        raise KeyError(f"{name}: missing {sorted(missing)[:5]}, unexpected "
                       f"{sorted(extra)[:5]}")
    for k, v in like.items():
        if tuple(saved[k].shape) != tuple(v.shape):
            raise ValueError(f"{name}.{k}: shape {tuple(saved[k].shape)}, "
                             f"expected {tuple(v.shape)}")


def load_checkpoint(path: str, targets: Mapping[str, Any],
                    map_location=None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Read ``path`` and restore it into ``targets``: name -> an object
    with ``load_state_dict`` (a module, an optimizer; loaded in place) or a
    state dict whose names and shapes the saved one must have (returned in
    the tree).  :return: (tree, metadata)."""
    tree, metadata = read_checkpoint(path, map_location)
    try:
        for name, target in targets.items():
            if hasattr(target, "load_state_dict"):
                target.load_state_dict(tree[name])
            else:
                _check_like(name, tree[name], target)
    except (KeyError, RuntimeError, ValueError) as e:
        raise ValueError(
            f"{path}: checkpoint does not match the current model/"
            f"optimizer structure ({_brief(e)}); it was likely "
            "saved under a different config - the file itself is intact, so "
            "fix the config (or load with the matching one) rather than "
            "deleting it") from e
    return tree, metadata
