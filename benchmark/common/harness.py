"""One run of one cell: set-up, the measured window as a closed loop,
the per-layer reading of a traced window, and the comparison with the
plain reference that decides ``correct``.

The cell's traffic driver (``benchmark/traffic/<kind>.py``, found by the
workload's ``traffic.kind``) owns the program and the inputs:

  * ``Traffic(cell)``; ``setup()`` builds the program, makes the weights
    and inputs from the seed and warms up every shape it will use;
  * ``request(r)`` runs request r to its end (synchronised) and returns a
    record with ``start`` and ``end`` (host seconds) and whatever its
    metrics read;
  * ``end_to_end(done)`` -> {metric: value} over the window's requests;
  * ``work(done)`` -> what the per-layer readers need of the traced
    requests (operations, bytes, windows, steps, launches);
  * ``release()`` frees the program's state; ``check(done)`` ->
    [(name, value, limit)] against the reference.

The loop sends request r + 1 when request r has ended, until ``seconds``
have passed since the first one started; the request in flight then
finishes and counts.  A traced run profiles its first
``trace_requests`` requests and stops there.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import math
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List

import torch

from . import timeline
from .trace import WINDOW, top_ops, traced

from torch.profiler import record_function

BENCH = Path(__file__).resolve().parent.parent
#: the benchmark's host range around each request of a traced window
REQUEST = "bench/request"


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict          # benchmark/workloads/<name>.json
    config: dict            # benchmark/configs/<config>.json
    seed: int
    seconds: float
    trace: bool
    device: torch.device


def traffic_class(kind: str):
    return importlib.import_module(f"benchmark.traffic.{kind}").Traffic


def metric_reader(name: str):
    """``read(records)`` of ``metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run(cell: Cell, end_to_end: List[str], per_layer: List[str],
        units: Dict[str, str], t_process: float) -> dict:
    """The result line of one run (without the JAX check, which the entry
    point makes last)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    traffic = traffic_class(cell.workload["traffic"]["kind"])(cell)
    traffic.setup()
    if cell.device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_process

    limit = cell.workload["traffic"].get("trace_requests", math.inf)
    done: List[dict] = []
    holder: Dict = {}
    with traced(cell.trace, holder):
        t0 = time.perf_counter()
        r = 0
        while time.perf_counter() - t0 < cell.seconds and (
                not cell.trace or r < limit):
            with record_function(REQUEST):
                done.append(traffic.request(r))
            r += 1
    result = {"correct": False, "attempted": len(done), "failed": 0,
              "metrics": {}, "device": device_block(cell.device)}

    if cell.trace:
        values = layer_values(traffic, done, holder["records"], per_layer)
        lo, hi = holder["records"][2]
        busy = timeline.busy([(a, b) for _, a, b, _ in holder["records"][0]],
                             lo, hi)
        result["device"].update(busy_s=busy, window_s=hi - lo)
        result["breakdown"] = breakdown(holder["records"])
    else:
        values = traffic.end_to_end(done)
        values["setup_s"] = setup_s
        missing = [m for m in end_to_end if m not in values]
        if missing:
            raise RuntimeError(f"cell {cell.name} does not produce {missing}")
        values = {m: values[m] for m in end_to_end}
    result["metrics"] = {k: {"value": float(v), "unit": units[k]}
                         for k, v in values.items()}

    lat = sorted(d["end"] - d["start"] for d in done)
    print(f"request seconds: min {lat[0]!r}, median {statistics.median(lat)!r}, "
          f"max {lat[-1]!r}", file=sys.stderr)
    traffic.release()
    t_check = time.perf_counter()
    compared = traffic.check(done)
    print(f"reference check: {time.perf_counter() - t_check:.1f} s, "
          f"{len(done)} requests in the window", file=sys.stderr)
    result["correct"] = bool(compared) and all(
        math.isfinite(v) and v <= lim for _, v, lim in compared)
    result["compared"] = {name: {"value": v, "limit": lim}
                          for name, v, lim in compared}
    for name, v, lim in compared:
        print(f"{name} {v!r} limit {lim!r}", file=sys.stderr)
    return result


def device_block(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def layer_values(traffic, done, records, names) -> Dict[str, float]:
    """Each per-layer metric whose reader finds something to read."""
    device, host, (lo, hi) = records
    rec = {"device": device, "host": host, "window": (lo, hi),
           "requests": done, "work": traffic.work(done)}
    out = {}
    for name in names:
        v = metric_reader(name)(rec)
        if v is not None:
            out[name] = v
    return out


def breakdown(records) -> dict:
    device, host, (lo, hi) = records
    idle = timeline.gaps([(a, b) for _, a, b, _ in device], lo, hi)
    return {"device_ops": top_ops(device, lo, hi),
            "idle_gaps": timeline.label_gaps(
                idle, [h for h in host if h[0] != WINDOW])[:10]}


def jax_modules() -> List[str]:
    """Modules of JAX or of the JAX package loaded in this process,
    compared by whole top-level name."""
    banned = {"jax", "jaxlib", "flax", "gesture_diffusion_tpu"}
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in banned)


def release_memory() -> None:
    """Return the memory of objects the caller has dropped."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reading(out: torch.Tensor, ref: torch.Tensor) -> float:
    """Worst row of max|out - ref| / max|ref| (each clip or window judged
    against its own scale)."""
    out, ref = out.double(), ref.double().to(out.device)
    d = (out - ref).abs().flatten(1).amax(dim=1)
    s = ref.abs().flatten(1).amax(dim=1)
    return float((d / s).max())
