"""MTCNN face detection, NCHW. Port of ``animateportrait_tpu/models/mtcnn.py``
(reference: MTCNN/{get_nets,first_stage,box_utils,detector}.py).

The nets keep the reference's ``Sequential`` layout, so the reference
``pnet/rnet/onet.npy`` dicts load by their own keys
(``features.conv1.weight``, ...), including the ``Flatten`` that reads
(C, W, H) order (get_nets.py:22). The cascade keeps the JAX package's fixed
capacities: the top ``k_scale`` PNet cells of each pyramid level, the top
``k_stage2`` candidates into RNet, the top ``k_stage3`` boxes into ONet,
with masked NMS (``ops/nms.py``) in between, so the kept set is the JAX
one. Everything but the NMS loops runs on the detector's device:

- the pyramid resize is ``F.interpolate(bilinear, antialias=True)``, which
  matches ``jax.image.resize(..., "linear")`` when it downsamples;
- the RNet/ONet crops are bilinear samples at pixel coordinates with zero
  padding (``F.grid_sample``, ``align_corners=True``), as the JAX
  ``_crop_resize``.
"""
from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.frozen.ops.nms import masked_nms, topk_mask


class Flatten(nn.Module):
    """The reference's flatten: (N, C, H, W) -> (N, C*W*H) in (C, W, H)
    order, the order the pretrained dense heads expect."""

    def forward(self, x):
        return x.transpose(3, 2).contiguous().flatten(1)


def _pool(k: int, s: int) -> nn.MaxPool2d:
    return nn.MaxPool2d(k, s, ceil_mode=True)


class PNet(nn.Module):
    """Fully-convolutional proposal net (12x12 window, stride 2)."""

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(OrderedDict([
            ("conv1", nn.Conv2d(3, 10, 3)), ("prelu1", nn.PReLU(10)),
            ("pool1", _pool(2, 2)),
            ("conv2", nn.Conv2d(10, 16, 3)), ("prelu2", nn.PReLU(16)),
            ("conv3", nn.Conv2d(16, 32, 3)), ("prelu3", nn.PReLU(32))]))
        self.conv4_1 = nn.Conv2d(32, 2, 1)
        self.conv4_2 = nn.Conv2d(32, 4, 1)

    def forward(self, x):
        """x (N, 3, H, W) -> (offsets (N, 4, h, w), probs (N, 2, h, w))."""
        x = self.features(x)
        return self.conv4_2(x), F.softmax(self.conv4_1(x), dim=1)


class RNet(nn.Module):
    """24x24 refinement net."""

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(OrderedDict([
            ("conv1", nn.Conv2d(3, 28, 3)), ("prelu1", nn.PReLU(28)),
            ("pool1", _pool(3, 2)),
            ("conv2", nn.Conv2d(28, 48, 3)), ("prelu2", nn.PReLU(48)),
            ("pool2", _pool(3, 2)),
            ("conv3", nn.Conv2d(48, 64, 2)), ("prelu3", nn.PReLU(64)),
            ("flatten", Flatten()),
            ("conv4", nn.Linear(576, 128)), ("prelu4", nn.PReLU(128))]))
        self.conv5_1 = nn.Linear(128, 2)
        self.conv5_2 = nn.Linear(128, 4)

    def forward(self, x):
        """x (N, 3, 24, 24) -> (offsets (N, 4), probs (N, 2))."""
        x = self.features(x)
        return self.conv5_2(x), F.softmax(self.conv5_1(x), dim=1)


class ONet(nn.Module):
    """48x48 output net with 5-point landmarks."""

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(OrderedDict([
            ("conv1", nn.Conv2d(3, 32, 3)), ("prelu1", nn.PReLU(32)),
            ("pool1", _pool(3, 2)),
            ("conv2", nn.Conv2d(32, 64, 3)), ("prelu2", nn.PReLU(64)),
            ("pool2", _pool(3, 2)),
            ("conv3", nn.Conv2d(64, 64, 3)), ("prelu3", nn.PReLU(64)),
            ("pool3", _pool(2, 2)),
            ("conv4", nn.Conv2d(64, 128, 2)), ("prelu4", nn.PReLU(128)),
            ("flatten", Flatten()),
            ("conv5", nn.Linear(1152, 256)), ("drop5", nn.Dropout(0.25)),
            ("prelu5", nn.PReLU(256))]))
        self.conv6_1 = nn.Linear(256, 2)
        self.conv6_2 = nn.Linear(256, 4)
        self.conv6_3 = nn.Linear(256, 10)

    def forward(self, x):
        """x (N, 3, 48, 48) -> (landmarks (N, 10), offsets (N, 4),
        probs (N, 2))."""
        x = self.features(x)
        return (self.conv6_3(x), self.conv6_2(x),
                F.softmax(self.conv6_1(x), dim=1))


def _load_npy(net: nn.Module, npy_path: str) -> nn.Module:
    d = np.load(npy_path, allow_pickle=True)[()]
    net.load_state_dict({k: torch.from_numpy(np.asarray(v, np.float32))
                         for k, v in d.items()})
    return net


def load_pnet(npy_path: str) -> PNet:
    """The reference ``pnet.npy`` (a pickled {key: array} dict) -> PNet."""
    return _load_npy(PNet(), npy_path)


def load_rnet(npy_path: str) -> RNet:
    return _load_npy(RNet(), npy_path)


def load_onet(npy_path: str) -> ONet:
    return _load_npy(ONet(), npy_path)


def pyramid_scales(height: int, width: int, min_face_size: float = 20.0,
                   min_detection_size: int = 12, factor: float = 0.707
                   ) -> list[float]:
    """Image-pyramid scales (detector.py:30-50)."""
    m = min_detection_size / min_face_size
    min_length = min(height, width) * m
    scales = []
    count = 0
    while min_length > min_detection_size:
        scales.append(m * factor**count)
        min_length *= factor
        count += 1
    return scales


def _f32(t: float) -> float:
    """A threshold as the fp32 value the JAX package compares against."""
    return float(np.float32(t))


def _preprocess(img: torch.Tensor) -> torch.Tensor:
    return (img - 127.5) * 0.0078125


def _crop_resize(img: torch.Tensor, boxes: torch.Tensor, size: int
                 ) -> torch.Tensor:
    """(K, 3, size, size) crops of img (1, 3, H, W) at inclusive boxes:
    bilinear samples at pixel centres, zero outside the image (the
    reference pads with zeros, box_utils.py:127-160)."""
    x1, y1, x2, y2 = boxes.unbind(1)
    u = (torch.arange(size, dtype=torch.float32, device=img.device)
         + 0.5) / size
    sx = x1[:, None] + u[None, :] * (x2 - x1 + 1.0)[:, None] - 0.5
    sy = y1[:, None] + u[None, :] * (y2 - y1 + 1.0)[:, None] - 0.5
    H, W = img.shape[2:]
    k = boxes.shape[0]
    gx = (2.0 * sx / (W - 1) - 1.0)[:, None, :].expand(k, size, size)
    gy = (2.0 * sy / (H - 1) - 1.0)[:, :, None].expand(k, size, size)
    grid = torch.stack([gx, gy], dim=-1).reshape(1, k * size, size, 2)
    crops = F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=True)      # (1, 3, k*size, size)
    return crops.reshape(3, k, size, size).transpose(0, 1)


def _calibrate(boxes: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Box regression (box_utils.py:94-125)."""
    x1, y1, x2, y2 = boxes.unbind(1)
    w = x2 - x1 + 1.0
    h = y2 - y1 + 1.0
    return boxes + torch.stack([w, h, w, h], dim=1) * offsets


def _to_square(boxes: torch.Tensor) -> torch.Tensor:
    """box_utils.py:71-91."""
    x1, y1, x2, y2 = boxes.unbind(1)
    h = y2 - y1 + 1.0
    w = x2 - x1 + 1.0
    side = torch.maximum(h, w)
    nx1 = x1 + w * 0.5 - side * 0.5
    ny1 = y1 + h * 0.5 - side * 0.5
    return torch.stack([nx1, ny1, nx1 + side - 1.0, ny1 + side - 1.0], dim=1)


class MTCNNDetector:
    """The three-stage cascade on ``device`` (no default: detection runs
    where the caller puts it). Capacities: ``k_scale`` candidates per
    pyramid level, ``k_stage2`` into RNet, ``k_stage3`` into ONet."""

    def __init__(self, pnet: PNet, rnet: RNet, onet: ONet,
                 device: torch.device | str, k_scale: int = 256,
                 k_stage2: int = 128, k_stage3: int = 32):
        self.device = torch.device(device)
        self.pnet = pnet.to(self.device).eval()
        self.rnet = rnet.to(self.device).eval()
        self.onet = onet.to(self.device).eval()
        self.k_scale, self.k2, self.k3 = k_scale, k_stage2, k_stage3

    def _stage1_one_scale(self, imgs, scale, threshold):
        """PNet at one pyramid level over a stack of images (B, 3, H, W)
        -> per image, (k_scale, 9) candidates [box, score, offsets] and
        their keep mask (the NMS on the host, image by image)."""
        h, w = imgs.shape[2:]
        scaled = F.interpolate(imgs, size=(math.ceil(h * scale),
                                           math.ceil(w * scale)),
                               mode="bilinear", align_corners=False,
                               antialias=True)
        offsets, probs = self.pnet(_preprocess(scaled))
        ow = probs.shape[3]
        # a device tensor: CUDA divides by a host scalar as a multiply by
        # its reciprocal, which can move a rounded box edge by a pixel
        s = torch.tensor(scale, dtype=torch.float32, device=imgs.device)
        stride, cell = 2.0, 12.0
        out = []
        for b in range(imgs.shape[0]):
            prob = probs[b, 1].reshape(-1)
            k = min(self.k_scale, prob.shape[0])
            idx, _ = topk_mask(prob, torch.ones_like(prob, dtype=torch.bool),
                               k)
            vals = prob[idx]
            valid = vals > _f32(threshold)
            rows = (idx // ow).float()
            cols = (idx % ow).float()
            boxes = torch.stack(
                [torch.round((stride * cols + 1.0) / s),
                 torch.round((stride * rows + 1.0) / s),
                 torch.round((stride * cols + 1.0 + cell) / s),
                 torch.round((stride * rows + 1.0 + cell) / s)], dim=1)
            offs = offsets[b].permute(1, 2, 0).reshape(-1, 4)[idx]
            keep = masked_nms(boxes, vals, valid, 0.5)   # first_stage.py:44
            cand = torch.cat([boxes, vals[:, None], offs], dim=1)
            pad = self.k_scale - k
            out.append((F.pad(cand, (0, 0, 0, pad)), F.pad(keep, (0, pad))))
        return out

    def _stage23(self, imgs, cands, masks, thresholds, nms_thresholds):
        """RNet and ONet over every image's candidates at once, the NMS
        between them image by image. imgs (B, 3, H, W); cands and masks
        one (N, 9) / (N,) per image -> per image (boxes (k3, 5), landmarks
        (k3, 10), keep (k3,))."""
        B = imgs.shape[0]
        sel = []
        for cand, mask in zip(cands, masks):
            idx, vmask = topk_mask(cand[:, 4], mask, self.k2)
            cand = cand[idx]
            valid = masked_nms(cand[:, :4], cand[:, 4], vmask,
                               nms_thresholds[0])
            sel.append((torch.round(_to_square(_calibrate(cand[:, :4],
                                                          cand[:, 5:9]))),
                        valid))
        crops = torch.cat([_crop_resize(imgs[b:b + 1], sel[b][0], 24)
                           for b in range(B)])
        off2, p2 = self.rnet(_preprocess(crops))
        boxes3, vmasks = [], []
        for b, (boxes, valid) in enumerate(sel):
            rows = slice(b * self.k2, (b + 1) * self.k2)
            scores = p2[rows, 1]
            valid = valid & (scores > _f32(thresholds[1]))
            valid = masked_nms(boxes, scores, valid, nms_thresholds[1])
            boxes = torch.round(_to_square(_calibrate(boxes, off2[rows])))
            idx, vmask = topk_mask(scores, valid, self.k3)
            boxes3.append(boxes[idx])
            vmasks.append(vmask)
        crops = torch.cat([_crop_resize(imgs[b:b + 1], boxes3[b], 48)
                           for b in range(B)])
        lm3_all, off3_all, p3_all = self.onet(_preprocess(crops))
        out = []
        for b in range(B):
            rows = slice(b * self.k3, (b + 1) * self.k3)
            lm3, off3, scores3 = lm3_all[rows], off3_all[rows], p3_all[rows, 1]
            bx = boxes3[b]
            valid3 = vmasks[b] & (scores3 > _f32(thresholds[2]))
            bw = bx[:, 2] - bx[:, 0] + 1.0
            bh = bx[:, 3] - bx[:, 1] + 1.0
            landmarks = torch.cat([bx[:, 0:1] + bw[:, None] * lm3[:, 0:5],
                                   bx[:, 1:2] + bh[:, None] * lm3[:, 5:10]],
                                  dim=1)
            bx = _calibrate(bx, off3)
            keep = masked_nms(bx, scores3, valid3, nms_thresholds[2],
                              mode="min")
            out.append((torch.cat([bx, scores3[:, None]], dim=1), landmarks,
                        keep))
        return out

    @torch.inference_mode()
    def detect_batch(self, imgs: np.ndarray, min_face_size: float = 20.0,
                     thresholds=(0.6, 0.7, 0.8),
                     nms_thresholds=(0.7, 0.7, 0.7)) -> list:
        """Detect faces in a stack of same-size RGB images (B, H, W, 3),
        uint8 or float 0-255: PNet once per pyramid level on the whole
        stack, RNet and ONet once on every image's candidates, the NMS
        image by image on the host. Returns per image numpy (boxes (k, 5),
        landmarks (k, 10)) of the kept detections, as ``__call__`` gives
        them for that image alone."""
        imgs = np.asarray(imgs)
        B, h, w = imgs.shape[:3]
        scales = pyramid_scales(h, w, min_face_size)
        if not scales:
            return [(np.zeros((0, 5), np.float32),
                     np.zeros((0, 10), np.float32)) for _ in range(B)]
        img_t = torch.as_tensor(np.ascontiguousarray(imgs),
                                dtype=torch.float32,
                                device=self.device).permute(0, 3, 1, 2)
        per_scale = [self._stage1_one_scale(img_t, s, thresholds[0])
                     for s in scales]
        cands = [torch.cat([level[b][0] for level in per_scale])
                 for b in range(B)]
        masks = [torch.cat([level[b][1] for level in per_scale])
                 for b in range(B)]
        out = []
        for boxes, lms, keep in self._stage23(img_t, cands, masks,
                                              thresholds, nms_thresholds):
            keep = keep.cpu().numpy()
            out.append((boxes.cpu().numpy()[keep], lms.cpu().numpy()[keep]))
        return out

    def __call__(self, img: np.ndarray, min_face_size: float = 20.0,
                 thresholds=(0.6, 0.7, 0.8), nms_thresholds=(0.7, 0.7, 0.7)):
        """Detect faces in an (H, W, 3) RGB image (uint8 or float, 0-255).
        Returns numpy (boxes (k, 5), landmarks (k, 10)) of the kept
        detections (MTCNN/detector.py:16-128)."""
        return self.detect_batch(np.asarray(img)[None], min_face_size,
                                 thresholds, nms_thresholds)[0]
