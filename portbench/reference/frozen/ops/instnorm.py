"""InstanceNorm (+ fused ReLU) of the reference: torch's own
``F.instance_norm`` in place of the port's kernel K2, with autograd in
place of its backward K2b."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def instance_norm(x: torch.Tensor, eps: float = 1e-5,
                  relu: bool = False) -> torch.Tensor:
    """InstanceNorm over H, W of an NCHW tensor, no affine, then ReLU
    when ``relu``."""
    y = F.instance_norm(x, eps=eps)
    return torch.relu(y) if relu else y
