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


_CONSTANTS: dict = {}


def device_constant(name: str, make, device: torch.device | str
                    ) -> torch.Tensor:
    """``torch.as_tensor(make(), device=device)``, made on the first call
    with this ``name`` and device and kept: later calls copy nothing from
    the host, so code that takes it can run inside a CUDA graph's capture.
    The tensor is shared; treat it as read-only."""
    key = (name, torch.device(device))
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.as_tensor(make(), device=device)
    return t
