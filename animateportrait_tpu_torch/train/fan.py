"""The FAN landmark-detector trainer (AdaptiveWingLoss). Port of
``animateportrait_tpu/train/fan.py`` (the reference's
Module1/thirdparty/AdaptiveWingLoss/core/{dataloader,evaler}.py):

- ``boundary_heatmap``: the AddBoundary transform, B-splines through each
  facial curve (scipy ``splprep`` k = min(4, n) - 1, s = 0) rasterized on
  the heatmap grid and turned into a line map by a distance transform,
  ``exp(-d^2 / 2)`` cut at 3 sigma; host numpy, as in the JAX package;
- ``weight_map``: AddWeightMap, 1 where the 3x3 grey dilation of a map
  exceeds 0.2;
- ``make_fan_targets``: the gaussian maps at landmarks / 4 + 1 (sigma 1),
  the boundary channel and the weight maps, (P + 1, hm, hm) each;
- ``FANTrainer``: one step is the weighted Adaptive Wing loss ``loss *
  (weights * W + 1)``, W = 10, summed over every stack, in training mode
  (BatchNorm updates its running statistics as flax's does), and an
  ``optax.adam`` update (``train/optim.py:adam``);
- ``evaluate_fan``: the mean NME of evaler.py, the boundary channel
  dropped before decoding.

Spans (``utils/observe.py``, recorded only under a profiler): ``fan.step``
(request id: the steps taken before it) with ``fan.forward`` (the FAN's
stacks), ``fan.loss`` (the weighted AWing loss), ``fan.grad`` and
``fan.adam`` inside it.

No kernel of the port lies on this path.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from animateportrait_tpu_torch.models.fan import (
    FAN, adaptive_wing_map, fan_nme, gaussian_heatmaps)
from animateportrait_tpu_torch.train.optim import AdamTrainer
from animateportrait_tpu_torch.utils import observe
from animateportrait_tpu_torch.utils.device import (
    DEFAULT_DEVICE, resolve_device)

BOUNDARY_GROUPS_68 = {
    "cheek": list(range(0, 17)),
    "left_eyebrow": list(range(17, 22)),
    "right_eyebrow": list(range(22, 27)),
    "upper_left_eyelid": list(range(36, 40)),
    "lower_left_eyelid": [36, 41, 40, 39],
    "upper_right_eyelid": list(range(42, 46)),
    "lower_right_eyelid": [42, 47, 46, 45],
    "nose": list(range(27, 31)),
    "nose_bot": list(range(31, 36)),
    "upper_outer_lip": list(range(48, 55)),
    "upper_inner_lip": [60, 61, 62, 63, 64],
    "lower_outer_lip": [48, 59, 58, 57, 56, 55, 54],
    "lower_inner_lip": [60, 67, 66, 65, 64],
}

BOUNDARY_GROUPS_98 = {
    "cheek": list(range(0, 33)),
    "left_eyebrow": list(range(33, 38)),
    "right_eyebrow": list(range(42, 47)),
    "upper_left_eyelid": list(range(60, 65)),
    "lower_left_eyelid": [60, 67, 66, 65, 64],
    "upper_right_eyelid": list(range(68, 73)),
    "lower_right_eyelid": [68, 75, 74, 73, 72],
    "nose": list(range(51, 55)),
    "nose_bot": list(range(55, 60)),
    "upper_outer_lip": list(range(76, 83)),
    "upper_inner_lip": [88, 89, 90, 91, 92],
    "lower_outer_lip": [76, 87, 86, 85, 84, 83, 82],
    "lower_inner_lip": [88, 95, 94, 93, 92],
}


def boundary_heatmap(landmarks: np.ndarray, size: int = 64,
                     sigma: float = 1.0) -> np.ndarray:
    """AddBoundary (dataloader.py:25-191): landmarks (P, 2) in image pixels
    (256-space) -> (size, size) boundary-line map, float32."""
    from scipy import interpolate, ndimage

    groups = (BOUNDARY_GROUPS_98 if landmarks.shape[0] >= 98
              else BOUNDARY_GROUPS_68)
    lm64 = np.floor(landmarks[:, :2] / 4.0)
    mask = np.ones((size, size), np.float32)  # 1 = background
    for inds in groups.values():
        pts = lm64[inds]
        keep = [0]                      # drop consecutive duplicates
        for i in range(1, len(pts)):
            if not np.all(pts[i] == pts[keep[-1]]):
                keep.append(i)
        pts = pts[keep]
        if pts.shape[0] == 1:
            pts = np.concatenate([pts, pts + 0.001], axis=0)
        k = min(4, pts.shape[0]) - 1
        tck, _ = interpolate.splprep([pts[:, 0], pts[:, 1]], k=k, s=0)
        out = interpolate.splev(np.arange(0, 1, 0.01), tck, der=0)
        xs = np.clip(np.round(out[0]).astype(int), 0, size - 1)
        ys = np.clip(np.round(out[1]).astype(int), 0, size - 1)
        mask[ys, xs] = 0.0
    dist = ndimage.distance_transform_edt(mask)
    return np.where(dist < 3 * sigma,
                    np.exp(-dist * dist / (2 * sigma * sigma)),
                    0.0).astype(np.float32)


def weight_map(heatmaps: np.ndarray) -> np.ndarray:
    """AddWeightMap (:193-204): (C, H, W) maps -> the same shape, 1 where
    the 3x3 grey dilation exceeds 0.2."""
    from scipy import ndimage

    w = np.zeros_like(heatmaps)
    for c in range(heatmaps.shape[0]):
        d = ndimage.grey_dilation(heatmaps[c], size=(3, 3))
        w[c] = (d > 0.2).astype(heatmaps.dtype)
    return w


def make_fan_targets(landmarks: np.ndarray, hm_size: int = 64
                     ) -> tuple[np.ndarray, np.ndarray]:
    """landmarks (P, 2) (x, y) in 256-space -> (maps (P + 1, hm, hm),
    weights (P + 1, hm, hm)): gaussians at landmarks / 4 + 1, sigma 1
    (:336), and the boundary channel; fp32 on the host."""
    p = landmarks.shape[0]
    hm = np.zeros((p + 1, hm_size, hm_size), np.float32)
    hm[:p] = gaussian_heatmaps(torch.from_numpy(
        (landmarks[:, :2] / 4.0 + 1.0).astype(np.float32)),
        (hm_size, hm_size), 1).numpy()
    hm[p] = boundary_heatmap(landmarks, size=hm_size)
    return hm, weight_map(hm)


@dataclasses.dataclass(frozen=True)
class FANTrainConfig:
    lr: float = 1e-4
    loss_w: float = 10.0
    num_modules: int = 4
    num_landmarks: int = 98


def build_fan(cfg: FANTrainConfig) -> FAN:
    return FAN(num_modules=cfg.num_modules, num_landmarks=cfg.num_landmarks)


class FANTrainer(AdamTrainer):
    """step(images (N, 3, S, S), gt (N, P + 1, S/4, S/4), weights (same))
    -> {"loss"}: the weighted AWing loss over every stack, one Adam
    update."""

    span_prefix = "fan"

    def __init__(self, cfg: FANTrainConfig, model: FAN | None = None,
                 device: torch.device | str = DEFAULT_DEVICE):
        super().__init__(model if model is not None else build_fan(cfg),
                         resolve_device(device), cfg.lr)
        self.cfg = cfg

    def losses(self, images, gt, weights) -> dict[str, torch.Tensor]:
        with observe.span("fan.forward"):
            outputs, _ = self.model(images)
        with observe.span("fan.loss"):
            scale = weights * self.cfg.loss_w + 1.0
            loss = sum(torch.mean(adaptive_wing_map(pred, gt) * scale)
                       for pred in outputs)
        return {"loss": loss}


@torch.no_grad()
def evaluate_fan(model: FAN, images: np.ndarray, gt_landmarks: np.ndarray,
                 cfg: FANTrainConfig, batch_size: int = 8) -> float:
    """The mean NME over a dataset (evaler.py:21-128): images (N, S, S, 3)
    in [0, 1], landmarks (N, P, 2) (x, y) in image pixels; the model runs
    in eval mode on its own device and dtype and is left in the mode it
    was in."""
    p = next(model.parameters())
    was = model.training
    model.eval()
    total, n = 0.0, 0
    try:
        for i in range(0, len(images), batch_size):
            xb = torch.from_numpy(np.ascontiguousarray(
                images[i:i + batch_size], np.float32)).to(
                    p.device, p.dtype).permute(0, 3, 1, 2)
            outputs, _ = model(xb)
            hm = outputs[-1][:, :cfg.num_landmarks]
            gt = torch.from_numpy(np.asarray(
                gt_landmarks[i:i + len(xb)], np.float32)).to(p.device,
                                                             p.dtype)
            total += float(fan_nme(hm, gt, cfg.num_landmarks))
            n += len(xb)
    finally:
        model.train(was)
    return total / max(n, 1)
