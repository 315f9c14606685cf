"""Shared layers, NCHW. Port of ``animateportrait_tpu/nn.py``.

The JAX module's lowering selectors are not carried over: the port has one
path for each layer, the JAX defaults.

- InstanceNorm goes through kernel K2 (``ops/instnorm.py``) with an
  optional fused ReLU.
- Reflect-pad convs materialize the pad (``nn.ReflectionPad2d`` + a VALID
  ``nn.Conv2d``), as the JAX default ``AP_REFLECT_CONV=pad`` does.
- Transposed convs are ``nn.ConvTranspose2d``: the JAX package stores its
  kernel so that torch weights apply unchanged (``io/from_jax.py`` maps it
  back).
- LSTMs are ``nn.LSTM(batch_first=True)``, whose gate layout the JAX
  package already keeps.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from animateportrait_tpu_torch.ops.instnorm import instance_norm


class InstanceNorm2d(nn.Module):
    """torch ``InstanceNorm2d(affine=False, eps=1e-5)`` through kernel K2;
    ``relu=True`` fuses the ReLU that follows it into the same kernel.
    Parameter-free, so it occupies a slot of a reference ``Sequential``
    without changing any state-dict key."""

    def __init__(self, relu: bool = False):
        super().__init__()
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x, relu=self.relu)

    def extra_repr(self) -> str:
        return f"relu={self.relu}"


def conv_in_relu(cin: int, cout: int, stride: int = 1,
                 relu: bool = True) -> list[nn.Module]:
    """Conv3x3(zero pad 1) -> IN(+ReLU), as the reference's three
    Sequential slots [Conv2d, InstanceNorm2d, ReLU]; the ReLU slot is an
    ``Identity`` because the ReLU is fused into the norm."""
    return [nn.Conv2d(cin, cout, 3, stride, 1),
            InstanceNorm2d(relu=relu), nn.Identity()]
