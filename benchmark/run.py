"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the port (``gesture_diffusion_torch``)
and ``BENCHMARK.json``.  The cell is ``benchmark/workloads/<cell>.json``;
its configuration ``benchmark/configs/<config>.json``; its traffic driver
``benchmark/traffic/<kind>.py``; each per-layer metric's reader
``benchmark/metrics/<metric>.py``.  Which metrics the cell reports is read
from ``BENCHMARK.json``: with ``--trace 0`` its end-to-end metrics, with
``--trace 1`` its per-layer ones.

The last line of standard output is the result's JSON; the numbers that
decided ``correct`` end standard error.  Without CUDA, with fewer cards
than the cell asks for, or with JAX or the JAX package loaded once the
run is over, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout, so a cell's
    second run finds everything built (the port builds its own library
    under ``build/torch_kernels`` beside the package)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        path = ROOT / "build" / "bench_cache" / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def metrics_of(spec: dict, cell: str):
    """(end-to-end names, per-layer names, units) that ``cell`` reports."""
    def applies(m):
        return cell in m.get("workloads", [cell])

    e2e = [m["name"] for m in spec["end_to_end"] if applies(m)]
    layers = [m["name"] for m in spec["per_layer"]
              if applies(m) and m["moves"] in e2e]
    units = {m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]}
    return e2e, layers, units


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    workload = json.loads((BENCH / "workloads" / f"{args.workload}.json")
                          .read_text())
    config = json.loads((BENCH / "configs" / f"{workload['config']}.json")
                        .read_text())
    cache_dirs()
    sys.path.insert(0, str(ROOT))
    import torch

    need = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    from benchmark.common import harness
    from benchmark.common.peaks import power_limit

    e2e, layers, units = metrics_of(spec, args.workload)
    cell = harness.Cell(args.workload, workload, config, args.seed,
                        args.seconds, bool(args.trace), torch.device("cuda", 0))
    print(f"card: {power_limit()}", file=sys.stderr)
    result = harness.run(cell, e2e, layers, units, T_PROCESS)
    found = harness.jax_modules()
    if found:
        print(f"JAX loaded in the benchmark's process: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
