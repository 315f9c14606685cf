"""Face detection and alignment: the reference's crop and the 5-point
landmark fallback.
Port of ``animateportrait_tpu/pipeline/align.py`` without OpenCV: the
bicubic resize is ``utils.image.resize_bicubic``.

``align_face`` reproduces ``align_mtcnn`` (main_end2end_module2.py:12-45):
largest face -> 1.2x square -> /0.7 expansion with the 11/20 vertical
offset -> white-padded crop -> bicubic resize to 512.
"""
from __future__ import annotations

import numpy as np

from animateportrait_tpu_torch.utils import assets
from animateportrait_tpu_torch.utils.image import resize_bicubic

# canonical 5-point positions inside the 68-point face: eye centres,
# nose tip, mouth corners
_FIVE_FROM_68 = ((36, 39), (42, 45), (30, 30), (48, 48), (54, 54))


def align_face(img_bgr: np.ndarray, boxes: np.ndarray, out_size: int = 512):
    """Crop + resize as ``align_mtcnn``. Returns (aligned BGR uint8,
    [scale, x_offset, y_offset] mapping image -> aligned coords, index of
    the chosen box)."""
    height, width = img_bgr.shape[:2]
    maxs = 0
    best = None
    best_idx = -1
    for k, face in enumerate(boxes):
        x1, y1, x2, y2 = (float(v) for v in face[:4])
        w = x2 - x1 + 1
        h = y2 - y1 + 1
        size = int(min(w, h) * 1.2)
        cx = x1 + w // 2
        cy = y1 + h // 2
        if size > maxs:
            maxs = size
            size1 = int(round(size / 0.7))
            best = (int(cx - size1 // 2), int(cy - (size1 * 11) // 20), size1)
            best_idx = k
    if best is None:
        raise ValueError("no face detected")
    x11, y11, size1 = best
    x21, y21 = x11 + size1, y11 + size1
    crop = np.full((size1, size1, 3), 255, np.uint8)
    crop[max(0, y11) - y11: min(y21, height) - y11,
         max(0, x11) - x11: min(width, x21) - x11] = img_bgr[
        max(0, y11): min(y21, height), max(0, x11): min(width, x21)]
    aligned = resize_bicubic(crop, (out_size, out_size))
    return aligned, np.array([out_size / size1, x11, y11], np.float64), best_idx


def _similarity_fit(src: np.ndarray, dst: np.ndarray):
    """Least-squares similarity (s, R, t) with dst ~ s R src + t (Umeyama)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    U, S, Vt = np.linalg.svd(dc.T @ sc / len(src))
    D = np.diag([1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / ((sc ** 2).sum() / len(src))
    return s, R, mu_d - s * R @ mu_s


def estimate_landmarks_from_5pt(five_pts: np.ndarray,
                                image_size: int = 512) -> np.ndarray:
    """68x3 landmarks from 5 detected points (weights-free FAN stand-in):
    similarity-fit the canonical face's 5 points and transform all 68."""
    std = assets.std_face_landmarks().copy()
    std2d = std[:, :2].copy()
    std2d[:, 1] *= -1  # canonical y is up; image y is down
    src = np.stack([0.5 * (std2d[a] + std2d[b]) for a, b in _FIVE_FROM_68])
    s, R, t = _similarity_fit(src, np.asarray(five_pts, np.float64))
    out2d = (s * (R @ std2d.T)).T + t
    z = std[:, 2] * s * (image_size / 512.0)
    return np.concatenate([out2d, z[:, None]], axis=1)


def detect(img_bgr: np.ndarray, detector):
    """Run ``detector`` (an ``MTCNNDetector`` or anything with its call
    signature) on the RGB float image: (boxes (k, 5), landmarks (k, 10))."""
    return detector(img_bgr[:, :, ::-1].astype(np.float32))


def align_detections(img_bgr: np.ndarray, boxes: np.ndarray,
                     lms: np.ndarray, out_size: int = 512):
    """Align on the largest detected face and map its 5 points into the
    aligned crop. Returns (aligned BGR, five_pts (5, 2))."""
    if len(boxes) == 0:
        raise ValueError("no face detected")
    aligned, (scale, ox, oy), k = align_face(img_bgr, boxes, out_size)
    lm = np.asarray(lms[k], np.float64)
    five = np.stack([lm[:5], lm[5:]], axis=1)
    five[:, 0] = (five[:, 0] - ox) * scale
    five[:, 1] = (five[:, 1] - oy) * scale
    return aligned, five


def detect_and_align(img_bgr: np.ndarray, detector, out_size: int = 512):
    """``detect`` then ``align_detections``."""
    return align_detections(img_bgr, *detect(img_bgr, detector), out_size)
