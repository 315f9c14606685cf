"""Fused STFT magnitude: kernel K1.

Port of ``animateportrait_tpu/ops/pallas_stft.py`` (TPU kernel
``_stft_kernel`` under ``stft_magnitude_pallas``). On a CUDA tensor the
wrapper launches ``csrc/stft.cu``: a real 1024-point FFT per frame in
shared memory, over the unpadded signal read through reflected indices; no
frame matrix and no DFT basis reach device memory. See that source for the
design and what bounds it. On a CPU tensor it takes the plain version,
``ops.spectral.stft_magnitude`` (framing + matmul with the DFT basis).
"""
from __future__ import annotations

import torch

from animateportrait_tpu_torch import kernels
from animateportrait_tpu_torch.ops.spectral import (
    stft_magnitude as stft_magnitude_plain)

N_FFT = 1024
HOP = 256


def stft_magnitude(x: torch.Tensor, n_fft: int = N_FFT,
                   hop: int = HOP) -> torch.Tensor:
    """|STFT| of a mono fp32 signal (n,) -> (n//hop + 1, n_fft//2 + 1):
    kernel K1 on a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return stft_magnitude_plain(x, n_fft, hop)
    if x.device.type != "cuda":
        raise ValueError(f"stft_magnitude: unsupported device {x.device}")
    if n_fft != N_FFT or hop != HOP:
        raise ValueError(f"stft_magnitude: the kernel takes n_fft={N_FFT}, "
                         f"hop={HOP}; got {n_fft}, {hop}")
    if x.dtype != torch.float32:
        raise TypeError(f"stft_magnitude: kernel takes float32, got {x.dtype}")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError("stft_magnitude: expected a contiguous 1-D signal, "
                         f"got shape {tuple(x.shape)}")
    n = x.shape[0]
    if n <= N_FFT // 2:
        raise ValueError(f"stft_magnitude: reflect padding needs more than "
                         f"{N_FFT // 2} samples, got {n}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"stft_magnitude: {x.device} is not the current "
                         "CUDA device")
    n_frames = n // HOP + 1
    out = torch.empty((n_frames, N_FFT // 2 + 1), dtype=torch.float32,
                      device=x.device)
    lib = kernels.library()
    err = lib.ap_stft_magnitude(
        x.data_ptr(), n, out.data_ptr(), n_frames,
        torch.cuda.current_stream().cuda_stream)
    kernels.check(err, "ap_stft_magnitude")
    stft_magnitude.launches += 1
    return out


stft_magnitude.launches = 0
