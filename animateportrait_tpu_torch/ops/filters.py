"""Savitzky-Golay smoothing on tensors. Port of
``animateportrait_tpu/ops/filters.py:savgol_filter``: a (T, window) gather
contracted with the least-squares coefficients, plus scipy's ``interp``
edge fit, so the landmark post chain stays on the device."""
from __future__ import annotations

import functools

import numpy as np
import torch


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
