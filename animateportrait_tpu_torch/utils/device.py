"""Where the port's entry points run: on the card unless the caller asks
for the CPU."""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: torch.device | str) -> torch.device:
    """``device`` as a ``torch.device``. A CUDA device on a machine without
    one is an error, never a silent fall back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev}: no CUDA device "
                           "(torch.cuda.is_available() is False); pass "
                           "device='cpu' to run on the CPU")
    return dev
