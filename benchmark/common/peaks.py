"""The card's published peaks (NVIDIA H100 SXM data sheet, dense, at the
full 700 W power limit).  One peak serves every cell whatever dtype it
computes in: no implementation beats the bf16 tensor-core rate, so a
share of it reads the same work the same way whatever implements it."""

from __future__ import annotations

import subprocess

PEAK_FLOPS = 989e12     # bf16 / fp16 tensor cores, FLOP/s
PEAK_BYTES = 3.35e12    # HBM3, B/s


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    "unknown" where it cannot."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
