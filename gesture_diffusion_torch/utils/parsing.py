"""Human-readable step counts ("4k", "200k", "1m").

A copy of ``gesture_diffusion_tpu/utils/parsing.py``, kept here so the port
never imports the JAX package: ``value * 1000 ** count('k')`` (and 1e6 per
``m``), not the reference's ``count('k') * 1000``, under which "100kk"
would mean 2e5.
"""

from __future__ import annotations


def parse_steps(steps: "str | int | float") -> int:
    if isinstance(steps, (int, float)):
        return int(steps)
    s = str(steps).strip().lower()
    mult = 1
    while s and s[-1] in "km":
        mult *= 1000 if s[-1] == "k" else 1_000_000
        s = s[:-1]
    if not s:
        raise ValueError(f"Cannot parse step count: {steps!r}")
    return int(float(s) * mult)
