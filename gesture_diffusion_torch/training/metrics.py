"""Run metrics as an append-only JSONL file.

Port of ``gesture_diffusion_tpu/training/metrics.py`` with the same keys:
``train/*`` every ``log_step_gap`` steps, ``val/*`` per epoch, each record
stamped with ``_time`` and ``_step``; one file per run id, so a resumed
run appends to its own.  Under a process group only rank 0 writes.  (The JAX logger's optional wandb mirror is not
carried over.)
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Any, Dict, Optional

import numpy as np

from ..parallel.mesh import is_main_process


def generate_run_id() -> str:
    return uuid.uuid4().hex[:8]


class MetricsLogger:
    def __init__(self, log_dir: str, run_id: Optional[str] = None,
                 config: Optional[dict] = None):
        self.run_id = run_id or generate_run_id()
        self.path = os.path.join(log_dir, f"metrics_{self.run_id}.jsonl")
        #: False on the ranks other than 0 of a process group
        self.writes = is_main_process()
        if not self.writes:
            return
        os.makedirs(log_dir, exist_ok=True)
        if config is not None:
            with open(os.path.join(log_dir, f"run_{self.run_id}.config.json"), "w") as f:
                json.dump(config, f, indent=2, default=str)

    def log(self, record: Dict[str, Any], step: Optional[int] = None) -> None:
        if not self.writes:
            return
        def scalarize(v):
            # float() only on scalars; vectors are written as lists
            if hasattr(v, "numel") and v.numel() != 1:
                return v.detach().cpu().tolist()
            if hasattr(v, "size") and not callable(v.size) and v.size != 1:
                return np.asarray(v).tolist()
            return float(v) if hasattr(v, "__float__") else v

        rec = {k: scalarize(v) for k, v in record.items()}
        rec["_time"] = time.time()
        if step is not None:
            rec["_step"] = int(step)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def read_all(self):
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]
