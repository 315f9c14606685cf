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
- BatchNorm in training mode takes flax's statistics: the biased batch
  variance E[x^2] - E[x]^2, which also updates the running variance.
- BatchNorm in eval mode on a bf16 input computes flax's
  ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` op by op in the
  promoted dtype of the input and whatever the parameters and statistics
  hold, and rounds the output to the input's dtype, as flax does: in fp32
  when the statistics are fp32 (the renderer's cast), in bf16 when every
  leaf is (the training step's). torch's ``batch_norm`` computes in fp32
  and refuses some of these mixes.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from portbench.reference.frozen.ops.instnorm import instance_norm


def _stat_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype BatchNorm's statistics take: fp32 for a bf16 or fp32
    tensor, float64 for a float64 one."""
    return torch.promote_types(x.dtype, torch.float32)


class _FlaxBatchNorm:
    """BatchNorm with ``flax.linen.BatchNorm``'s steps: in training mode
    the batch statistics are E[x] and the biased E[x^2] - E[x]^2 (clipped
    at 0), and the running variance takes that biased variance (torch
    takes the unbiased one); in eval mode a non-fp32 input runs flax's
    steps in the promoted dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return self._train_forward(x)
        if x.dtype == torch.float32:
            return super().forward(x)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mean, var, scale, bias = (t.reshape(shape) for t in (
            self.running_mean, self.running_var, self.weight, self.bias))
        # XLA fuses var + eps into the rsqrt: one rounding, of the rsqrt
        inv = torch.rsqrt(var.to(_stat_dtype(var)) + self.eps).to(var.dtype)
        return ((x - mean) * (inv * scale) + bias).to(x.dtype)

    def _train_forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = [0] + list(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.to(_stat_dtype(x))
        mean = xf.mean(dims)
        var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
        # new tensors, not in-place updates: an eval-mode pass of the same
        # net whose graph holds the old statistics may still be
        # differentiated (the pose-transfer discriminator's fake pair)
        with torch.no_grad():
            m = self.momentum
            self.running_mean = self.running_mean * (1.0 - m) \
                + mean.to(self.running_mean.dtype) * m
            self.running_var = self.running_var * (1.0 - m) \
                + var.to(self.running_var.dtype) * m
            self.num_batches_tracked = self.num_batches_tracked + 1
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.reshape(shape)) * mul.reshape(shape) \
            + self.bias.reshape(shape)
        return y.to(x.dtype)


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's training statistics, that also runs
    a bf16 input in eval mode."""


class BatchNorm1d(_FlaxBatchNorm, nn.BatchNorm1d):
    """``nn.BatchNorm1d`` (over (N, C)) with flax's training statistics,
    that also runs a bf16 input in eval mode."""


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
