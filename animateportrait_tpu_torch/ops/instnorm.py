"""InstanceNorm (+ fused ReLU): kernel K2 and its plain PyTorch version.

Port of ``animateportrait_tpu/ops/pallas_instnorm.py``. The TPU kernel
(``_kernel`` under ``_pallas_forward``) was opt-in there and limited to
H*W <= 4096 by VMEM; on the card every InstanceNorm of the slice goes
through ``csrc/instnorm.cu`` — NCHW fp32 planes from (8, 8, 256, 256) and
(1, 64, 512, 512) down to (1, 8, 16, 16). The kernel reads each plane once
into shared memory; a plane over ``SLICE_BYTES`` is split over a thread
block cluster of 2, 4 or 8 CTAs (``cluster_size``). See that source for the
design and what bounds it.

Statistics are the JAX package's default one-pass form with its clamp,
``var = max(E[d^2] - E[d]^2, 0)`` (``_xla_instance_norm``), eps 1e-5,
taken over ``d = x - k``, where ``k`` is the plane's mean from a first
sweep. The shift changes nothing in exact arithmetic. Without it the form
cancels when |mean| is many standard deviations: the landmark encoder's
mostly flat planes reach mean/std ~12, and two summation orders then
disagree by ~1e-4. With it, E[d] is nearly 0 and nothing cancels. The
Pallas kernel that K2 replaces also takes the mean first. Kernel and plain
version compute the same steps. The kernel is forward only: its backward
comes with the training slice.
"""
from __future__ import annotations

import torch

from animateportrait_tpu_torch import kernels

# The per-CTA shared-memory budget: a plane of more bytes is split over a
# cluster. At 64 KB three CTAs share an SM, so one CTA's loads overlap
# another's stores; it was the fastest budget at (8, 64, 256, 256), the
# costliest shape of the path (PERF.md).
SLICE_BYTES = 64 * 1024
# the kernel's limits (csrc/instnorm.cu): portable clusters of up to 8 CTAs,
# 227 KB of shared memory a CTA less its static arrays
MAX_CLUSTER = 8
MAX_SLICE_BYTES = 232448 - 1024


def slice_elems(hw: int, cluster: int) -> int:
    """Elements of a plane that each of ``cluster`` CTAs holds (a multiple
    of 4, so that every slice starts 16-byte aligned)."""
    return (-(-hw // cluster) + 3) // 4 * 4


def cluster_size(hw: int, slice_bytes: int = SLICE_BYTES) -> int:
    """CTAs per plane of ``hw`` fp32 elements: the smallest of 1, 2, 4 and
    8 whose slices fit ``slice_bytes`` (8 where none does, if its slices
    fit the hardware), or 0 for the streaming branch."""
    budget = min(slice_bytes, MAX_SLICE_BYTES)
    k = 1
    while k < MAX_CLUSTER and 4 * slice_elems(hw, k) > budget:
        k *= 2
    return k if 4 * slice_elems(hw, k) <= MAX_SLICE_BYTES else 0


def instance_norm_plain(x: torch.Tensor, eps: float = 1e-5,
                        relu: bool = False) -> torch.Tensor:
    """The plain version: fp32 statistics over H, W of NCHW, one-pass over
    each plane shifted by its mean."""
    xs = x.float()
    cnt = x.shape[2] * x.shape[3]
    d = xs - xs.sum(dim=(2, 3), keepdim=True) / cnt
    mean = d.sum(dim=(2, 3), keepdim=True) / cnt
    var = torch.clamp((d * d).sum(dim=(2, 3), keepdim=True) / cnt
                      - mean * mean, min=0.0)
    y = (d - mean) * torch.rsqrt(var + eps)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def instance_norm(x: torch.Tensor, eps: float = 1e-5,
                  relu: bool = False) -> torch.Tensor:
    """InstanceNorm(+ReLU) of an NCHW tensor: kernel K2 on a CUDA tensor,
    the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return instance_norm_plain(x, eps, relu)
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"instance_norm: kernel takes float32, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"instance_norm: expected NCHW, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("instance_norm: input must be contiguous NCHW")
    if x.requires_grad:
        raise RuntimeError("instance_norm: the kernel has no backward yet; "
                           "run under torch.inference_mode()")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"instance_norm: {x.device} is not the current "
                         "CUDA device")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    h, w = x.shape[2:]
    _launch(x, y, eps, relu, cluster_size(h * w))
    return y


def _launch(x: torch.Tensor, y: torch.Tensor, eps: float, relu: bool,
            cluster: int) -> None:
    """Launch K2 on checked contiguous fp32 NCHW CUDA tensors with
    ``cluster`` CTAs per plane (0: the streaming branch); the kernel
    refuses a cluster whose slices do not fit its shared memory."""
    n, c, h, w = x.shape
    err = kernels.library().ap_instance_norm(
        x.data_ptr(), y.data_ptr(), n * c, h * w, float(eps), int(relu),
        int(cluster), torch.cuda.current_stream().cuda_stream)
    kernels.check(err, "ap_instance_norm")
    instance_norm.launches += 1


instance_norm.launches = 0
