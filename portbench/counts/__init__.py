"""The work the benchmark counts: published peaks of one H100 SXM, the
bytes and operations of the port's kernels (frozen copies of
``utils/kernel_bench.py``'s ``k1_work``, ``k2_work``, ``k2b_work`` and
``bound``), and the FLOPs of the configurations' nets, counted over the
reference's frozen nets (``counts/flops.py``), never over the port's."""
from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12            # H100 SXM, fp32 outside the tensor cores

N_FFT = 1024
HOP = 256


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(least time in s, "bytes" or "operations") for the given work."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_work(n: int) -> tuple[int, int]:
    """(bytes, fp32 operations) of |STFT| of n samples by a real FFT: the
    signal read once, the magnitudes written once; per frame 2.5 N log2 N
    for the 1024-point real FFT, the window and the magnitude."""
    frames = n // HOP + 1
    bins = N_FFT // 2 + 1
    flops = frames * (2.5 * N_FFT * math.log2(N_FFT) + N_FFT + 3 * bins)
    return 4 * n + 4 * frames * bins, int(flops)


def k2_work(shape, elem_bytes: int = 4, stats: bool = False
            ) -> tuple[int, int]:
    """(bytes, fp32 operations) of an InstanceNorm(+ReLU) of an NCHW tensor
    of ``elem_bytes`` an element: read once, written once, and with
    ``stats`` each plane's 12 bytes of statistics written; ~8 operations an
    element."""
    numel = math.prod(shape)
    planes = shape[0] * shape[1]
    return 2 * elem_bytes * numel + (12 * planes if stats else 0), 8 * numel


def k2b_work(shape, elem_bytes: int = 4) -> tuple[int, int]:
    """(bytes, fp32 operations) of InstanceNorm's backward from saved
    statistics: x and the upstream gradient read once, dx written once,
    each plane's 12 bytes of statistics read; ~10 operations an
    element."""
    numel = math.prod(shape)
    return 3 * elem_bytes * numel + 12 * shape[0] * shape[1], 10 * numel
