"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """``None`` means the card.  Asking for CUDA where there is none raises:
    entry points never drop to the CPU unless the caller asked for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
