"""Small helpers shared across the port."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The port's entry points run on the card unless the caller asks for
    the CPU: ``device="cuda"`` is every default, and a CUDA device on a
    machine without one raises here instead of quietly running elsewhere."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            f"device='cpu' to run on the CPU"
        )
    return dev
