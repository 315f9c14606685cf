"""Spectral audio features: windows, mel filterbank, STFT magnitude, f0 coding.

Port of ``animateportrait_tpu/ops/spectral.py``. The window and filterbank
stay numpy; the STFT here is the plain framing + windowed-DFT matmul, the
reference that kernel K1 (``ops/stft.py``) is held against.

Semantics (reference file:line, as in the JAX module):
- framing/window/magnitudes: pySTFT (extract_f0_func.py:14-26): reflect
  pad n_fft//2, periodic Hann, |rfft|;
- mel: librosa slaney mel (fmin 90, fmax 7600, 80 bins); ``mel_spectrogram``
  takes its magnitudes from the plain STFT here on every device;
- f0 normalization / one-hot: Module1/src/autovc/utils.py:95-146.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(n: int) -> np.ndarray:
    """Periodic (fftbins=True) Hann window, matching scipy get_window('hann')."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        f >= min_log_hz,
        min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
        f / f_sp)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    m * f_sp)


def mel_filterbank(sr: int = 16000, n_fft: int = 1024, n_mels: int = 80,
                   fmin: float = 90.0, fmax: float = 7600.0) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, (n_mels, n_fft//2+1)."""
    n_bins = n_fft // 2 + 1
    fftfreqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax),
                          n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


def windowed_dft_basis(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Window-folded real-DFT basis (n_fft, n_fft//2+1): cos and -sin,
    fp32 (the formula of ``pallas_stft.py:_dft_mats`` without the lane
    padding)."""
    n_bins = n_fft // 2 + 1
    t = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * t * k / n_fft
    win = hann_window(n_fft)[:, None]
    return ((np.cos(ang) * win).astype(np.float32),
            (-np.sin(ang) * win).astype(np.float32))


@functools.lru_cache(maxsize=None)
def dft_basis(n_fft: int, device: torch.device
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """``windowed_dft_basis`` as tensors, built once per device."""
    return tuple(torch.from_numpy(m).to(device)
                 for m in windowed_dft_basis(n_fft))


def stft_magnitude(x: torch.Tensor, n_fft: int = 1024,
                   hop: int = 256) -> torch.Tensor:
    """|STFT| of a mono signal (n,), pySTFT-compatible: (n//hop + 1,
    n_fft//2 + 1). The plain version of kernel K1: reflect pad, frame
    gather, two matmuls against the windowed DFT basis."""
    pad = n_fft // 2
    xp = F.pad(x[None, None], (pad, pad), mode="reflect")[0, 0]
    frames = xp.unfold(0, n_fft, hop)          # (n_frames, n_fft) view
    cos_m, sin_m = dft_basis(n_fft, x.device)
    re = frames @ cos_m
    im = frames @ sin_m
    return torch.sqrt(re * re + im * im)


@functools.lru_cache(maxsize=None)
def mel_basis(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float,
              device: torch.device) -> torch.Tensor:
    """``mel_filterbank(...).T`` (n_fft//2+1, n_mels) as a tensor, built
    once per device."""
    return torch.from_numpy(np.ascontiguousarray(
        mel_filterbank(sr, n_fft, n_mels, fmin, fmax).T)).to(device)


def mel_scale(mags: torch.Tensor, sr: int = 16000, n_fft: int = 1024,
              n_mels: int = 80, fmin: float = 90.0, fmax: float = 7600.0
              ) -> torch.Tensor:
    """|STFT| magnitudes (..., n_frames, n_fft//2+1) -> the reference's
    scaled log-mel: S = (20 log10(max(min_level, mag @ mel)) - 16 + 100)
    / 100, min_level = 1e-5."""
    d_mel = mags @ mel_basis(sr, n_fft, n_mels, fmin, fmax, mags.device)
    min_level = float(np.exp(-100.0 / 20.0 * np.log(10.0)))
    d_db = 20.0 * torch.log10(torch.clamp(d_mel, min=min_level)) - 16.0
    return (d_db + 100.0) / 100.0


def mel_spectrogram(x: torch.Tensor, sr: int = 16000, n_fft: int = 1024,
                    hop: int = 256, n_mels: int = 80, fmin: float = 90.0,
                    fmax: float = 7600.0) -> torch.Tensor:
    """Reference-scaled log-mel of fp32 signal(s) (..., n) -> (...,
    n//hop + 1, n_mels). The magnitudes come from ``stft_magnitude``
    above, one row of the leading dims at a time, on every device."""
    rows = x.reshape(-1, x.shape[-1])
    mags = torch.stack([stft_magnitude(r.contiguous(), n_fft, hop)
                        for r in rows])
    mags = mags.reshape(*x.shape[:-1], *mags.shape[1:])
    return mel_scale(mags, sr, n_fft, n_mels, fmin, fmax)


def speaker_normalize_f0(logf0: torch.Tensor,
                         voiced: torch.Tensor) -> torch.Tensor:
    """Normalize voiced log-f0 to [0, 1] by the speaker's mean/std over
    voiced frames (utils.py:95-102); unvoiced frames get -1e10."""
    v = voiced.float()
    cnt = torch.clamp(v.sum(), min=1.0)
    mean = (logf0 * v).sum() / cnt
    var = (torch.square(logf0 - mean) * v).sum() / cnt
    std = torch.sqrt(torch.clamp(var, min=1e-12))
    norm = torch.clamp((logf0 - mean) / std / 4.0, -1.0, 1.0)
    norm = (norm + 1.0) / 2.0
    return torch.where(voiced, norm, torch.full_like(norm, -1e10))


def quantize_f0_onehot(x: torch.Tensor, num_bins: int = 256) -> torch.Tensor:
    """One-hot quantize normalized f0 to num_bins+1 channels
    (utils.py:130-146): unvoiced (x < 0) -> bin 0, voiced ->
    1 + round(x * (num_bins-1)), rounding half to even as jnp.round."""
    uv = x < 0
    xq = torch.where(uv, torch.zeros_like(x), x)
    idx = torch.round(xq * (num_bins - 1)).to(torch.int64) + 1
    idx = torch.where(uv, torch.zeros_like(idx), idx)
    return F.one_hot(idx, num_bins + 1).float()
