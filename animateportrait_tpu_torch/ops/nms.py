"""Masked, fixed-capacity non-maximum suppression. Port of
``animateportrait_tpu/ops/nms.py``.

Boxes live in a buffer of fixed capacity K with a validity mask, as in the
JAX package, so the kept set is the JAX one given the same candidates. The
(K, K) overlap matrix is computed on the boxes' device; the greedy loop
(K <= 256) runs on the host over that matrix, as the reference's numpy NMS
does (MTCNN/box_utils.py:5-68), and the keep mask goes back to the device.

Conventions: inclusive pixel boxes (``w = x2 - x1 + 1``); mode ``union``
is IoU, mode ``min`` is the overlap over the smaller area (ONet's final
NMS, MTCNN/detector.py:124). Ties in score keep the lower index first, as
``jnp.argsort`` and ``lax.top_k`` do: the sorts here are stable.
"""
from __future__ import annotations

import numpy as np
import torch


def iou_matrix(boxes: torch.Tensor, mode: str = "union") -> torch.Tensor:
    """Pairwise overlap of (K, 4) boxes (x1, y1, x2, y2), inclusive coords."""
    x1, y1, x2, y2 = boxes.unbind(1)
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    ix1 = torch.maximum(x1[:, None], x1[None, :])
    iy1 = torch.maximum(y1[:, None], y1[None, :])
    ix2 = torch.minimum(x2[:, None], x2[None, :])
    iy2 = torch.minimum(y2[:, None], y2[None, :])
    w = torch.clamp(ix2 - ix1 + 1.0, min=0.0)
    h = torch.clamp(iy2 - iy1 + 1.0, min=0.0)
    inter = w * h
    if mode == "min":
        denom = torch.minimum(area[:, None], area[None, :])
    elif mode == "union":
        denom = area[:, None] + area[None, :] - inter
    else:
        raise ValueError(f"iou_matrix: unknown mode {mode!r}")
    return inter / torch.clamp(denom, min=1e-10)


def _descending(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Indices by descending score, invalid rows last, ties by index."""
    masked = torch.where(valid, scores, torch.full_like(scores, -np.inf))
    return torch.argsort(-masked, stable=True)


def masked_nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
               iou_threshold: float, mode: str = "union") -> torch.Tensor:
    """Greedy NMS over a fixed-size masked buffer: (K, 4) boxes, (K,)
    scores, (K,) bool ``valid`` -> (K,) bool keep mask (a subset of
    ``valid``), on the boxes' device."""
    order = _descending(scores, valid).cpu().numpy()
    # the threshold as the fp32 value JAX compares against
    over = (iou_matrix(boxes, mode) > float(np.float32(iou_threshold))
            ).cpu().numpy()
    ok = valid.cpu().numpy()
    keep = np.zeros(ok.shape, bool)
    suppressed = ~ok
    for idx in order:
        if not suppressed[idx]:
            keep[idx] = True
            suppressed |= over[idx]
    return torch.from_numpy(keep).to(boxes.device)


def topk_mask(scores: torch.Tensor, valid: torch.Tensor, k: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Indices of the top-k valid scores (ties by index) and a validity
    mask for them."""
    idx = _descending(scores, valid)[:k]
    return idx, valid[idx]
