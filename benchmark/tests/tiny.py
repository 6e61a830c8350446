"""A cell cut to a size the CPU runs in seconds: the harness and the
port's CPU path (the fused sampler's plain version, the scan sampler)
at d_model 64, 4 heads, 1 layer, 12 pose channels, ddim10."""

from __future__ import annotations

import json
import time
from pathlib import Path

import torch

from benchmark.common import harness
from benchmark.run import metrics_of

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(cell: str) -> dict:
    w = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
    t = w["traffic"]
    if t["kind"] == "sequence":
        t.update(clips=4, clip_s=4, batch_size=4, sample=2)
    else:
        t.update(utterance_s=20)
    return w


def config(name: str) -> dict:
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg["Model"]["d_model"] = 64
    cfg["Model"]["Decoder"].update(heads=4, n_layers=1)
    cfg["Model"]["Diffusion"]["timestep_respacing"] = "ddim10"
    cfg["d_pose"] = 12
    return cfg


def cell(name: str, seed: int = 2 ** 31 + 7, seconds: float = 1.0,
         trace: bool = False) -> harness.Cell:
    w = workload(name)
    return harness.Cell(name, w, config(w["config"]), seed, seconds, trace,
                        torch.device("cpu"))


def run(name: str, **kw) -> dict:
    """A whole run of the tiny cell on the CPU (the look for a card
    skipped), its result line."""
    c = cell(name, **kw)
    e2e, layers, units = metrics_of(SPEC, name)
    return harness.run(c, e2e, layers, units, time.perf_counter())
