"""InstanceNorm (+ fused ReLU): kernel K2, its backward K2b, and their plain
PyTorch versions.

Port of ``animateportrait_tpu/ops/pallas_instnorm.py``. The TPU kernel
(``_kernel`` under ``_pallas_forward``) was opt-in there and limited to
H*W <= 4096 by VMEM; on the card every InstanceNorm of the slice goes
through ``csrc/instnorm.cu`` — NCHW fp32 planes from (8, 8, 256, 256) and
(1, 64, 512, 512) down to (1, 8, 16, 16), and bf16 planes on the bf16 paths
(``--render_bf16``, ``compute_dtype="bfloat16"``). The kernel reads each
plane once into shared memory; a plane over ``SLICE_BYTES`` is split over a
thread block cluster of 2, 4 or 8 CTAs (``cluster_size``). See that source
for the design and what bounds it.

bf16: as the TPU kernel, which takes any dtype, K2 widens a bf16 input to
fp32, takes the statistics and the output in fp32 and rounds the output to
bf16 once; K2b widens x and the upstream gradient, computes dx in fp32 and
rounds it once, as ``jax.vjp`` of the XLA formulation does (it upcasts the
cotangent). The saved statistics are fp32 in both. Each kernel counts its
fp32 and its bf16 launches apart (``launches``, ``launches_bf16``).

Statistics are the JAX package's default one-pass form with its clamp,
``var = max(E[d^2] - E[d]^2, 0)`` (``_xla_instance_norm``), eps 1e-5,
taken over ``d = x - k``, where ``k`` is the plane's mean from a first
sweep. The shift changes nothing in exact arithmetic. Without it the form
cancels when |mean| is many standard deviations: the landmark encoder's
mostly flat planes reach mean/std ~12, and two summation orders then
disagree by ~1e-4. With it, E[d] is nearly 0 and nothing cancels. The
Pallas kernel that K2 replaces also takes the mean first. Kernel and plain
version compute the same steps.

Training: on a CUDA tensor that requires grad, with grad enabled,
``instance_norm`` goes through ``InstanceNormK2``, an autograd function
whose forward launches K2 with a stats buffer (each plane's k = E[x],
m = E[x - k] and rstd, from which K2b recomputes the forward's pre-ReLU
output bit for bit) and whose backward launches K2b (``csrc/instnorm_bwd.cu``, wrapper
``instance_norm_backward``). The JAX package takes that gradient as
``jax.vjp`` of its XLA formulation (``pallas_instnorm.py:_bwd``); on the
CPU the port takes it as autograd through ``instance_norm_plain``. The
inference path (no grad, or ``inference_mode``) launches K2 alone, as
before.
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


def slice_elems(hw: int, cluster: int, align: int = 4) -> int:
    """Elements of a plane that each of ``cluster`` CTAs holds: a multiple
    of ``align`` (K2: 16 bytes of elements, 4 in fp32 and 8 in bf16, so
    that every slice starts 16-byte aligned; K2b: 4)."""
    return (-(-hw // cluster) + align - 1) // align * align


def cluster_size(hw: int, slice_bytes: int = SLICE_BYTES,
                 elem_bytes: int = 4, align: int = 4) -> int:
    """CTAs per plane of ``hw`` elements that take ``elem_bytes`` of shared
    memory each (K2: the element size, 4 in fp32 and 2 in bf16; K2b:
    twice that, for x and g), in slices of a multiple of ``align``
    elements: the smallest of 1, 2, 4 and 8 whose slices fit
    ``slice_bytes`` (8 where none does, if its slices fit the hardware), or
    0 for the streaming branch."""
    budget = min(slice_bytes, MAX_SLICE_BYTES)
    k = 1
    while k < MAX_CLUSTER and elem_bytes * slice_elems(hw, k, align) > budget:
        k *= 2
    return k if elem_bytes * slice_elems(hw, k, align) <= MAX_SLICE_BYTES \
        else 0


def k2_cluster(x: torch.Tensor, slice_bytes: int = SLICE_BYTES) -> int:
    """K2's CTAs per plane of ``x`` (fp32 or bf16)."""
    e = x.element_size()
    return cluster_size(x.shape[2] * x.shape[3], slice_bytes, e, 16 // e)


def k2b_cluster(x: torch.Tensor, slice_bytes: int = SLICE_BYTES) -> int:
    """K2b's CTAs per plane of ``x`` (fp32 or bf16)."""
    return cluster_size(x.shape[2] * x.shape[3], slice_bytes,
                        2 * x.element_size())


def instance_norm_plain(x: torch.Tensor, eps: float = 1e-5,
                        relu: bool = False) -> torch.Tensor:
    """The plain version: fp32 statistics over H, W of NCHW (float64 for a
    float64 input, an exact-arithmetic stand-in), one-pass over each plane
    shifted by its mean."""
    xs = x.to(torch.promote_types(x.dtype, torch.float32))
    cnt = x.shape[2] * x.shape[3]
    d = xs - xs.sum(dim=(2, 3), keepdim=True) / cnt
    mean = d.sum(dim=(2, 3), keepdim=True) / cnt
    var = torch.clamp((d * d).sum(dim=(2, 3), keepdim=True) / cnt
                      - mean * mean, min=0.0)
    y = (d - mean) * torch.rsqrt(var + eps)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _check(x: torch.Tensor, name: str) -> None:
    """Raise on what the kernels do not take: a contiguous fp32 or bf16
    NCHW tensor on the current CUDA device."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"{name}: expected NCHW, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous NCHW")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: {x.device} is not the current CUDA "
                         "device")


def instance_norm(x: torch.Tensor, eps: float = 1e-5,
                  relu: bool = False) -> torch.Tensor:
    """InstanceNorm(+ReLU) of an NCHW tensor: kernel K2 on a CUDA tensor
    (with K2b as its backward when autograd records it), the plain version
    on a CPU tensor."""
    if x.device.type == "cpu":
        return instance_norm_plain(x, eps, relu)
    _check(x, "instance_norm")
    if x.requires_grad and torch.is_grad_enabled():
        return InstanceNormK2.apply(x, eps, relu)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    _launch(x, y, eps, relu, k2_cluster(x))
    return y


def _launch(x: torch.Tensor, y: torch.Tensor, eps: float, relu: bool,
            cluster: int, stats: torch.Tensor | None = None) -> None:
    """Launch K2 on checked contiguous NCHW CUDA tensors of one dtype,
    fp32 or bf16, with ``cluster`` CTAs per plane (0: the streaming
    branch); the kernel refuses a cluster whose slices do not fit its
    shared memory. ``stats``: None, or ``empty_stats(x)`` for each plane's
    k, m and rstd."""
    n, c, h, w = x.shape
    bf16 = x.dtype == torch.bfloat16
    name = "ap_instance_norm_bf16" if bf16 else "ap_instance_norm"
    err = getattr(kernels.library(), name)(
        x.data_ptr(), y.data_ptr(), 0 if stats is None else stats.data_ptr(),
        n * c, h * w, float(eps), int(relu), int(cluster),
        torch.cuda.current_stream().cuda_stream)
    kernels.check(err, name)
    if bf16:
        instance_norm.launches_bf16 += 1
    else:
        instance_norm.launches += 1


instance_norm.launches = 0
instance_norm.launches_bf16 = 0


class InstanceNormK2(torch.autograd.Function):
    """InstanceNorm(+ReLU) with K2 forward and K2b backward, for CUDA
    tensors that ``instance_norm`` has checked."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, eps: float, relu: bool) -> torch.Tensor:
        y = torch.empty_like(x)
        stats = empty_stats(x)
        if x.numel():
            _launch(x, y, eps, relu, k2_cluster(x), stats)
        ctx.save_for_backward(x, stats)
        ctx.relu = relu
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, stats = ctx.saved_tensors
        return (instance_norm_backward(x, g.contiguous(), stats, ctx.relu),
                None, None)


def empty_stats(x: torch.Tensor) -> torch.Tensor:
    """A buffer for the statistics K2 saves for K2b: (N*C, 3) fp32, each
    plane's k = E[x], m = E[x - k] and rstd = rsqrt(var + eps)."""
    return torch.empty((x.shape[0] * x.shape[1], 3), dtype=torch.float32,
                       device=x.device)


def instance_norm_stats_plain(x: torch.Tensor, eps: float = 1e-5
                              ) -> torch.Tensor:
    """The (N*C, 3) k, m and rstd that K2 saves, by the plain version's
    steps."""
    xs = x.float()
    cnt = x.shape[2] * x.shape[3]
    k = xs.sum(dim=(2, 3), keepdim=True) / cnt
    d = xs - k
    mean = d.sum(dim=(2, 3), keepdim=True) / cnt
    var = torch.clamp((d * d).sum(dim=(2, 3), keepdim=True) / cnt
                      - mean * mean, min=0.0)
    return torch.stack([k.reshape(-1), mean.reshape(-1),
                        torch.rsqrt(var + eps).reshape(-1)], dim=1)


def instance_norm_backward_plain(x: torch.Tensor, g: torch.Tensor,
                                 stats: torch.Tensor,
                                 relu: bool = False) -> torch.Tensor:
    """The plain version of K2b: dx of InstanceNorm(+ReLU) from x, the
    upstream gradient g and the saved (N*C, 3) k, m and rstd. A bf16 x and
    g are widened and dx is computed in fp32 and rounded to x's dtype once,
    as ``jax.vjp`` of the XLA formulation does."""
    n, c = x.shape[:2]
    k, mean, rstd = (stats[:, i].reshape(n, c, 1, 1) for i in range(3))
    xhat = ((x.float() - k) - mean) * rstd
    g = g.float()
    gy = torch.where(xhat > 0, g, torch.zeros_like(g)) if relu else g
    m1 = gy.mean(dim=(2, 3), keepdim=True)
    m2 = (gy * xhat).mean(dim=(2, 3), keepdim=True)
    return (rstd * ((gy - m1) - xhat * m2)).to(x.dtype)


def instance_norm_backward(x: torch.Tensor, g: torch.Tensor,
                           stats: torch.Tensor,
                           relu: bool = False) -> torch.Tensor:
    """dx of InstanceNorm(+ReLU): kernel K2b on CUDA tensors, the plain
    version on CPU tensors. ``stats`` is the (N*C, 3) k, m and rstd of
    each plane of ``x``, as K2 saves them."""
    if x.device.type == "cpu":
        return instance_norm_backward_plain(x, g, stats, relu)
    for t, name in ((x, "x"), (g, "g")):
        _check(t, f"instance_norm_backward ({name})")
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError(f"instance_norm_backward: g {tuple(g.shape)} "
                         f"{g.dtype} is not x's {tuple(x.shape)} {x.dtype}")
    n, c, h, w = x.shape
    if (stats.device != x.device or stats.dtype != torch.float32
            or stats.shape != (n * c, 3) or not stats.is_contiguous()):
        raise ValueError("instance_norm_backward: stats must be contiguous "
                         f"({n * c}, 3) float32 on {x.device}")
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    _launch_backward(x, g, stats, dx, relu, k2b_cluster(x))
    return dx


def _launch_backward(x: torch.Tensor, g: torch.Tensor, stats: torch.Tensor,
                     dx: torch.Tensor, relu: bool, cluster: int) -> None:
    """Launch K2b on checked tensors of one dtype, fp32 or bf16, with
    ``cluster`` CTAs per plane (0: the streaming branch)."""
    n, c, h, w = x.shape
    bf16 = x.dtype == torch.bfloat16
    name = "ap_instance_norm_bwd_bf16" if bf16 else "ap_instance_norm_bwd"
    err = getattr(kernels.library(), name)(
        x.data_ptr(), g.data_ptr(), stats.data_ptr(), dx.data_ptr(), n * c,
        h * w, int(relu), int(cluster),
        torch.cuda.current_stream().cuda_stream)
    kernels.check(err, name)
    if bf16:
        instance_norm_backward.launches_bf16 += 1
    else:
        instance_norm_backward.launches += 1


instance_norm_backward.launches = 0
instance_norm_backward.launches_bf16 = 0
