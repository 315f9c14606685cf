"""68-point face-landmark geometry. Port of
``animateportrait_tpu/ops/geometry.py``: ``norm_input_face``,
``close_input_face_mouth`` and ``add_naive_eye`` on the host (numpy, as
there); ``area_of_signed_polygon``, ``best_fit_transform`` and ``icp`` on
tensors.

Reference: Module1/util/utils.py:329-393, Module1/util/geo_math.py:34 and
Module1/util/icp.py.
"""
from __future__ import annotations

import numpy as np
import torch

EYE_PAIRS = ((37, 41), (38, 40), (43, 47), (44, 46))


def norm_input_face(shape_3d: np.ndarray, std_face: np.ndarray
                    ) -> tuple[np.ndarray, float, np.ndarray]:
    """Normalize a 68x3 face: jaw-width scale 1.6, jaw-midpoint shift,
    z from the standard face. Returns (shape, scale, shift)."""
    shape_3d = np.array(shape_3d, dtype=np.float64)
    scale = 1.6 / (shape_3d[0, 0] - shape_3d[16, 0])
    shift = -0.5 * (shape_3d[0, 0:2] + shape_3d[16, 0:2])
    shape_3d[:, 0:2] = (shape_3d[:, 0:2] + shift) * scale
    shape_3d[:, -1] = std_face[:, -1] * 0.1
    shape_3d[:, 0:2] = -shape_3d[:, 0:2]
    return shape_3d, scale, shift


def close_input_face_mouth(shape_3d: np.ndarray, p1: float = 0.7,
                           p2: float = 0.5) -> np.ndarray:
    """Pull the outer and inner lip landmarks of a 68x3 face toward their
    closed-mouth midline (Module1/util/utils.py:329-346)."""
    s = np.array(shape_3d, dtype=np.float64).reshape(1, 68, 3)
    outer_low = [58, 57, 56]
    inner_low = [67, 66, 65]
    mean_in = 0.5 * (s[:, 61:64] + s[:, inner_low])
    s[:, 50:53] -= (s[:, 61:64] - mean_in) * p1
    s[:, outer_low] -= (s[:, inner_low] - mean_in) * p1
    s[:, 49] -= (s[:, 61] - mean_in[:, 0]) * p2
    s[:, 53] -= (s[:, 63] - mean_in[:, -1]) * p2
    s[:, 59] -= (s[:, 67] - mean_in[:, 0]) * p2
    s[:, 55] -= (s[:, 65] - mean_in[:, -1]) * p2
    s[:, 61:64] -= (s[:, 61:64] - mean_in) * p1
    s[:, inner_low] -= (s[:, inner_low] - mean_in) * p1
    return s.reshape(68, 3)


def blink_timestamps(length: int, rng: np.random.Generator,
                     k2: int = 15) -> list[int]:
    """Blink schedule: first at t=30, then every 60 + U[30, 90) frames."""
    stamps = [30] if 30 < length - 1 - k2 else []
    t = 30
    while t < length - 1 - k2:
        t += 60 + int(rng.integers(30, 90))
        if t < length - 1 - k2:
            stamps.append(t)
    return stamps


def add_naive_eye(fl: np.ndarray, rng: np.random.Generator | None = None
                  ) -> np.ndarray:
    """Tighten the eyelids slightly and insert interpolated blinks."""
    fl = np.array(fl, dtype=np.float64)
    if rng is None:
        rng = np.random.default_rng(0)
    r = 0.95
    for up, down in EYE_PAIRS:
        a, b = fl[:, up].copy(), fl[:, down].copy()
        fl[:, up] = r * a + (1 - r) * b
        fl[:, down] = (1 - r) * a + r * b
    K1, K2 = 10, 15
    T = fl.shape[0]
    eye_idx = [37, 38, 40, 41, 43, 44, 46, 47]
    for t in blink_timestamps(T, rng, K2):
        for up, down in EYE_PAIRS:
            closed = 0.25 * fl[t, up] + 0.75 * fl[t, down]
            fl[t, up] = closed
            fl[t, down] = closed
        open_l = fl[t - K1, eye_idx].copy()
        open_r = (fl[t + K2, eye_idx].copy() if t + K2 < T
                  else fl[t, eye_idx].copy())
        closed_v = fl[t, eye_idx]
        for t0 in range(t - K1 + 1, t):
            w = (t - t0) / K1
            fl[t0, eye_idx] = w * open_l + (1 - w) * closed_v
        for t0 in range(t + 1, min(t + K2, T)):
            w = (t + K2 - 1 - t0) / K2
            fl[t0, eye_idx] = w * closed_v + (1 - w) * open_r
    return fl


def area_of_signed_polygon(pts: torch.Tensor) -> torch.Tensor:
    """Shoelace signed area of polygons (..., n, 2)."""
    x, y = pts[..., 0], pts[..., 1]
    xn = torch.roll(x, -1, dims=-1)
    yn = torch.roll(y, -1, dims=-1)
    return 0.5 * torch.sum(x * yn - xn * y, dim=-1)


def best_fit_transform(A: torch.Tensor, B: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Least-squares rigid transform (R, t) taking the point set A (n, m)
    onto B by SVD (Module1/util/icp.py:5-50). Returns (the (m + 1) x
    (m + 1) homogeneous T, R, t)."""
    m = A.shape[1]
    ca, cb = A.mean(0), B.mean(0)
    H = (A - ca).T @ (B - cb)
    U, _, Vt = torch.linalg.svd(H)
    d = torch.sign(torch.linalg.det(Vt.T @ U.T))
    D = torch.diag(torch.cat([torch.ones(m - 1, dtype=A.dtype,
                                         device=A.device), d[None]]))
    R = Vt.T @ D @ U.T
    t = cb - R @ ca
    T = torch.eye(m + 1, dtype=A.dtype, device=A.device)
    T[:m, :m] = R
    T[:m, m] = t
    return T, R, t


def icp(A: torch.Tensor, B: torch.Tensor, max_iterations: int = 50,
        tolerance: float = 1e-4) -> tuple[torch.Tensor, torch.Tensor]:
    """Iterative closest point registration of A onto B
    (Module1/util/icp.py:77-113): each step moves A's current copy by the
    rigid fit to its nearest points of B, until the mean distance changes
    by less than ``tolerance``. Returns (the homogeneous transform from A
    to where it ended, the last mean distance)."""
    src = A
    prev = torch.zeros((), dtype=A.dtype, device=A.device)
    err = prev
    for _ in range(max_iterations):
        d2 = torch.sum((src[:, None, :] - B[None, :, :]) ** 2, dim=-1)
        dist, idx = torch.min(d2, dim=1)
        _, R, t = best_fit_transform(src, B[idx])
        src = src @ R.T + t
        err = torch.sqrt(dist).mean()
        if torch.abs(prev - err) < tolerance:
            break
        prev = err
    T, _, _ = best_fit_transform(A, src)
    return T, err
