"""Smoothing filters on tensors. Port of
``animateportrait_tpu/ops/filters.py``: ``savgol_filter``, a (T, window)
gather contracted with the least-squares coefficients, plus scipy's
``interp`` edge fit, so the landmark post chain stays on the device; and
``hann_smooth``, the reference's Hanning-window smoothing."""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _savgol_coeffs(window_length: int, polyorder: int) -> np.ndarray:
    half = window_length // 2
    pos = np.arange(-half, half + 1, dtype=np.float64)
    A = pos[:, None] ** np.arange(polyorder + 1)[None, :]
    return np.linalg.pinv(A)[0].astype(np.float32)


@functools.lru_cache(maxsize=None)
def _savgol_edge_matrices(window_length: int, polyorder: int
                          ) -> tuple[np.ndarray, np.ndarray]:
    half = window_length // 2
    t = np.arange(window_length, dtype=np.float64)
    A = t[:, None] ** np.arange(polyorder + 1)[None, :]
    proj = A @ np.linalg.pinv(A)
    return (proj[:half].astype(np.float32),
            proj[window_length - half:].astype(np.float32))


def savgol_filter(x: torch.Tensor, window_length: int, polyorder: int
                  ) -> torch.Tensor:
    """Savitzky-Golay smoothing along dim 0, matching scipy's defaults
    (mode='interp')."""
    if window_length % 2 != 1:
        raise ValueError("window_length must be odd")
    T = x.shape[0]
    xf = x.reshape(T, -1)
    half = window_length // 2
    dev = x.device
    coeffs = torch.from_numpy(_savgol_coeffs(window_length, polyorder)).to(dev)
    idx = (torch.arange(T, device=dev)[:, None]
           + torch.arange(-half, half + 1, device=dev)[None, :])
    idx = torch.clamp(idx, 0, T - 1)
    y = torch.einsum("twd,w->td", xf[idx], coeffs)
    left_m, right_m = _savgol_edge_matrices(window_length, polyorder)
    y = y.clone()
    y[:half] = torch.from_numpy(left_m).to(dev) @ xf[:window_length]
    y[T - half:] = torch.from_numpy(right_m).to(dev) @ xf[T - window_length:]
    return y.reshape(x.shape)


def hann_smooth(x: torch.Tensor, window_len: int = 11) -> torch.Tensor:
    """Hanning-window smoothing of a 1-D series (n,), as
    Module1/util/utils.py:213-265 ``smooth(window='hanning')``: reflect-
    extend by window_len - 1 on both sides and convolve with the
    normalized fp32 Hann window. Like the reference it returns the whole
    'valid' convolution, of length n + window_len - 1; callers slice."""
    w = torch.from_numpy(np.hanning(window_len).astype(np.float32)).to(
        device=x.device, dtype=x.dtype)
    w = w / w.sum()
    ext = torch.cat([x[1:window_len].flip(0), x,
                     x[-window_len:-1].flip(0)])
    # a convolution flips its kernel, conv1d (a correlation) does not
    return F.conv1d(ext[None, None], w.flip(0)[None, None])[0, 0]
