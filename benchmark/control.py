"""The control of a cell's comparison: the readings that a limit is set
between.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 --seconds 8

For each seed, in one process: the cell's set-up and a short window at
its own load (the run's own traffic), then two readings against the
plain reference on the same weights and inputs, once the program's state
is freed: the program's (the lower reading) and the control's.  The
control is the cell's ``traffic.control``:

  * ``{"program_dtype": "bfloat16"}``: the program's own lower-precision
    path switched on (``Generator(fused_dtype=...)``) on the sampled
    requests' inputs;
  * ``{"operand": "float8_e4m3fn"}``: the reference with every operand of
    its decoder's products rounded to that type (per-tensor scale to the
    type's largest value);
  * ``{"tf32": true}``: the reference with TF32 on for matmuls and cuDNN.

One JSON line per seed; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def operand_rounding(dtype_name: str):
    """Round to an 8-bit float type, each tensor scaled so that its
    largest magnitude is the type's largest value."""
    import torch

    dtype = getattr(torch, dtype_name)
    top = float(torch.finfo(dtype).max)

    def rnd(x):
        s = x.detach().abs().amax().clamp(min=1e-30) / top
        return (x / s).to(dtype).float() * s

    return rnd


def control_reading(traffic, done, control: dict) -> float:
    """The control's reading of a finished window (program released)."""
    import torch

    from benchmark.common import program

    if "program_dtype" in control:
        traffic.fused_dtype = getattr(torch, control["program_dtype"])
        outs = replay(traffic, done, program.build_generator(
            traffic.cfg, traffic.sd, traffic.dev, traffic.fused_dtype))
        return traffic.gap(done, traffic.reference(), outs)
    ref = traffic.reference()
    if "operand" in control:
        ctrl = traffic.reference(operand_rounding(control["operand"]))
        return traffic.gap(done, ref, ref_outputs(traffic, done, ctrl))
    if control.get("tf32"):
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            outs = ref_outputs(traffic, done, ref)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        return traffic.gap(done, ref, outs)
    raise ValueError(f"unknown control {control}")


def replay(traffic, done, gen):
    """The sampled requests of an interactive window run again by
    ``gen`` on their own inputs: {request: host poses}."""
    outs = {}
    for r in traffic.sample(len(done)):
        ip = traffic.seeds[r].new_zeros((traffic.n, traffic.t, traffic.c))
        ip[:, :traffic.k] = traffic.seeds[r]
        outs[r] = gen.generate_sample(
            traffic.window(r), traffic.c, traffic.t, noise=traffic.draws(r)[0],
            inpaint_poses=ip, inpaint_masks=traffic.mask,
            trans_factor=traffic.trans, pose_seed_len=traffic.k).cpu()
    return outs


def ref_outputs(traffic, done, model):
    """A sequence window's sampled clips computed by ``model`` in place
    of the program: {request: (clips, frames, C) array}."""
    import numpy as np
    import torch

    from benchmark.reference import diffusion as rd

    rs, clips = traffic.sample(len(done))
    sel = torch.tensor(clips, device=traffic.dev)
    outs = {}
    for r in rs:
        noise, init = traffic.draws(r)
        full = np.zeros((traffic.n, traffic.frames, traffic.c), np.float32)
        full[clips] = rd.sequence(model, traffic.schedule(), traffic.audio[sel],
                                  noise[:, sel], init[sel],
                                  traffic.cfg).cpu().numpy()
        outs[r] = full
    return outs


def readings(cell) -> dict:
    """One seed: the run's window, then the program's and the control's
    readings."""
    import torch

    from benchmark.common import harness

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    traffic = harness.traffic_class(cell.workload["traffic"]["kind"])(cell)
    traffic.setup()
    done, t0 = [], time.perf_counter()
    while time.perf_counter() - t0 < cell.seconds:
        done.append(traffic.request(len(done)))
    traffic.release()
    lower = traffic.gap(done, traffic.reference())
    upper = control_reading(traffic, done, cell.workload["traffic"]["control"])
    traffic.release()
    return {"seed": cell.seed, "requests": len(done), "program": lower,
            "control": upper}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.common import harness

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    bench = ROOT / "benchmark"
    workload = json.loads((bench / "workloads" / f"{args.workload}.json")
                          .read_text())
    config = json.loads((bench / "configs" / f"{workload['config']}.json")
                        .read_text())
    for seed in args.seeds:
        cell = harness.Cell(args.workload, workload, config, seed,
                            args.seconds, False, torch.device("cuda", 0))
        print(json.dumps(readings(cell)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
