"""FAN3D and ResNetDepth, the 68-point 3D landmark source of the CLI
(the reference driver's ``face_alignment.FaceAlignment(LandmarksType._3D)
.get_landmarks``, main_end2end_module2.py:188-193). Port of
``animateportrait_tpu/models/fan3d.py``, NCHW.

The nets carry face_alignment's own ``state_dict`` names, so that a public
``3DFAN4`` / ``depth`` checkpoint loads with a strict ``load_state_dict``:

- ``FAN3D``: a 7x7/s2 stem and ConvBlocks to 256 channels at 64x64, then
  ``num_modules`` (published: 4) depth-4 hourglasses, each giving 68
  heatmaps; the last module's heatmaps are the output;
- ``ResNetDepth``: a ResNet-152-shaped bottleneck net, ``(3, 8, 36, 3)``
  blocks, over the 256x256 crop and 68 landmark gaussians, regressing 68
  z values; its ``AvgPool2d(7)`` on the 8x8 map covers the top-left 7x7
  window only (floor mode), as in torch.

Their norms are BatchNorms in eval mode, so the nets need no kernel of
the port's own. The face_alignment API quirks are kept, on the host in
numpy as in the JAX package: the box's centre lifted by 12% of its height
and scale ``(w + h) / 195``; ``fa_transform`` truncating to int64 as torch
``.long()`` does; ``fa_crop``, a 1-based integer crop with zero padding
resized to 256 by ``utils/image.py:resize_linear`` (``cv2.resize``
INTER_LINEAR, byte for byte). On the nets' device: the heatmap decode
(first maximum, a quarter-pixel shift toward the stronger neighbour on
interior peaks, then -0.5) and the depth net's input gaussians at the
256-space predictions; z is scaled by ``200 * scale / 256``.
"""
from __future__ import annotations

import glob
import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from animateportrait_tpu_torch.nn import BatchNorm2d
from animateportrait_tpu_torch.utils.device import (
    DEFAULT_DEVICE, resolve_device)
from animateportrait_tpu_torch.utils.image import resize_linear

FA_REFERENCE_SCALE = 195.0  # SFD face detector reference_scale
NUM_LANDMARKS = 68
DEPTH_LAYERS = (3, 8, 36, 3)


def _conv3x3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, 1, 1, bias=False)


class ConvBlockFA(nn.Module):
    """face_alignment ``ConvBlock``: a pre-activation 3-branch block (out/2
    + out/4 + out/4 channels concatenated) with a BN-ReLU-1x1 shortcut when
    the widths differ."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.bn1 = BatchNorm2d(cin)
        self.conv1 = _conv3x3(cin, cout // 2)
        self.bn2 = BatchNorm2d(cout // 2)
        self.conv2 = _conv3x3(cout // 2, cout // 4)
        self.bn3 = BatchNorm2d(cout // 4)
        self.conv3 = _conv3x3(cout // 4, cout // 4)
        self.downsample = (nn.Sequential(BatchNorm2d(cin), nn.ReLU(),
                                         nn.Conv2d(cin, cout, 1, bias=False))
                           if cin != cout else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y1 = self.conv1(F.relu(self.bn1(x)))
        y2 = self.conv2(F.relu(self.bn2(y1)))
        y3 = self.conv3(F.relu(self.bn3(y2)))
        res = x if self.downsample is None else self.downsample(x)
        return torch.cat([y1, y2, y3], dim=1) + res


class HourGlassFA(nn.Module):
    """Depth-4 hourglass (face_alignment ``HourGlass``, no CoordConv):
    2x2 average pooling down, nearest x2 up."""

    def __init__(self, depth: int = 4, features: int = 256):
        super().__init__()
        self.depth = depth
        for lv in range(depth, 0, -1):
            self.add_module(f"b1_{lv}", ConvBlockFA(features, features))
            self.add_module(f"b2_{lv}", ConvBlockFA(features, features))
            if lv == 1:
                self.add_module("b2_plus_1", ConvBlockFA(features, features))
            self.add_module(f"b3_{lv}", ConvBlockFA(features, features))

    def _level(self, x: torch.Tensor, lv: int) -> torch.Tensor:
        up1 = self._modules[f"b1_{lv}"](x)
        low1 = self._modules[f"b2_{lv}"](F.avg_pool2d(x, 2, 2))
        low2 = (self._level(low1, lv - 1) if lv > 1
                else self._modules["b2_plus_1"](low1))
        low3 = self._modules[f"b3_{lv}"](low2)
        return up1 + F.interpolate(low3, scale_factor=2.0, mode="nearest")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._level(x, self.depth)


class FAN3D(nn.Module):
    """forward(img (N, 3, 256, 256) RGB in [0, 1]) -> list of
    ``num_modules`` heatmaps, each (N, 68, 64, 64)."""

    def __init__(self, num_modules: int = 4,
                 num_landmarks: int = NUM_LANDMARKS):
        super().__init__()
        self.num_modules = num_modules
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3)
        self.bn1 = BatchNorm2d(64)
        self.conv2 = ConvBlockFA(64, 128)
        self.conv3 = ConvBlockFA(128, 128)
        self.conv4 = ConvBlockFA(128, 256)
        for m in range(num_modules):
            self.add_module(f"m{m}", HourGlassFA())
            self.add_module(f"top_m_{m}", ConvBlockFA(256, 256))
            self.add_module(f"conv_last{m}", nn.Conv2d(256, 256, 1))
            self.add_module(f"bn_end{m}", BatchNorm2d(256))
            self.add_module(f"l{m}", nn.Conv2d(256, num_landmarks, 1))
            if m < num_modules - 1:
                self.add_module(f"bl{m}", nn.Conv2d(256, 256, 1))
                self.add_module(f"al{m}", nn.Conv2d(num_landmarks, 256, 1))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.avg_pool2d(self.conv2(x), 2, 2)
        previous = self.conv4(self.conv3(x))
        outputs = []
        for i in range(self.num_modules):
            ll = self._modules[f"top_m_{i}"](self._modules[f"m{i}"](previous))
            ll = F.relu(self._modules[f"bn_end{i}"](
                self._modules[f"conv_last{i}"](ll)))
            out = self._modules[f"l{i}"](ll)
            outputs.append(out)
            if i < self.num_modules - 1:
                previous = (previous + self._modules[f"bl{i}"](ll)
                            + self._modules[f"al{i}"](out))
        return outputs


class BottleneckFA(nn.Module):
    """torchvision-style ResNet bottleneck, expansion 4."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = (nn.Sequential(
            nn.Conv2d(cin, planes * 4, 1, stride, bias=False),
            BatchNorm2d(planes * 4)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(y + res)


class ResNetDepth(nn.Module):
    """forward((N, 71, 256, 256): RGB / 255 and 68 gaussians) -> (N, 68)
    z values."""

    def __init__(self, layers: tuple[int, ...] = DEPTH_LAYERS,
                 num_classes: int = NUM_LANDMARKS):
        super().__init__()
        self.conv1 = nn.Conv2d(3 + NUM_LANDMARKS, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        cin = 64
        for li, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
            stride = 1 if li == 0 else 2
            blocks = []
            for b in range(n):
                s = stride if b == 0 else 1
                blocks.append(BottleneckFA(
                    cin, planes, s, b == 0 and (s != 1 or cin != planes * 4)))
                cin = planes * 4
            self.add_module(f"layer{li + 1}", nn.Sequential(*blocks))
        self.fc = nn.Linear(512 * 4, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for li in range(1, 5):
            x = self._modules[f"layer{li}"](x)
        x = F.avg_pool2d(x, 7)                 # floor mode: the 7x7 corner
        return self.fc(x.flatten(1))


# ---------------------------------------------------------------------------
# face_alignment API semantics
# ---------------------------------------------------------------------------

def bbox_to_center_scale(box) -> tuple[np.ndarray, float]:
    """face_alignment api.py: box -> (centre, scale); the centre's y is
    lifted by 12% of the box's height, scale = (w + h) / 195."""
    x1, y1, x2, y2 = (float(v) for v in box[:4])
    center = np.array([x2 - (x2 - x1) / 2.0, y2 - (y2 - y1) / 2.0])
    center[1] = center[1] - (y2 - y1) * 0.12
    return center, (x2 - x1 + y2 - y1) / FA_REFERENCE_SCALE


def fa_transform(point, center, scale, resolution: float,
                 invert: bool = False) -> np.ndarray:
    """face_alignment utils.transform between image space and the
    resolution x resolution crop; int64, truncated as torch ``.long()``
    truncates."""
    h = 200.0 * scale
    t = np.eye(3)
    t[0, 0] = t[1, 1] = resolution / h
    t[0, 2] = resolution * (-center[0] / h + 0.5)
    t[1, 2] = resolution * (-center[1] / h + 0.5)
    if invert:
        t = np.linalg.inv(t)
    out = t @ np.array([float(point[0]), float(point[1]), 1.0])
    return np.trunc(out[:2]).astype(np.int64)


def fa_crop(image: np.ndarray, center, scale,
            resolution: int = 256) -> np.ndarray:
    """face_alignment utils.crop: integer-corner crop with zero padding,
    resized to resolution x resolution as cv2 INTER_LINEAR. image:
    (H, W, 3) uint8 RGB."""
    ul = fa_transform([1, 1], center, scale, resolution, invert=True)
    br = fa_transform([resolution, resolution], center, scale, resolution,
                      invert=True)
    ht, wd = image.shape[:2]
    new_img = np.zeros((int(br[1] - ul[1]), int(br[0] - ul[0]),
                        image.shape[2]), np.uint8)
    new_x = [int(max(1, -ul[0] + 1)), int(min(br[0], wd) - ul[0])]
    new_y = [int(max(1, -ul[1] + 1)), int(min(br[1], ht) - ul[1])]
    old_x = [int(max(1, ul[0] + 1)), int(min(br[0], wd))]
    old_y = [int(max(1, ul[1] + 1)), int(min(br[1], ht))]
    new_img[new_y[0] - 1: new_y[1], new_x[0] - 1: new_x[1]] = \
        image[old_y[0] - 1: old_y[1], old_x[0] - 1: old_x[1]]
    return resize_linear(new_img, (resolution, resolution))


def decode_heatmaps(hm: torch.Tensor) -> torch.Tensor:
    """face_alignment get_preds_fromhm, vectorised: (N, C, H, W) heatmaps
    -> (N, C, 2) peaks in heatmap space (1-based, minus 0.5)."""
    n, c, h, w = hm.shape
    flat = hm.reshape(n, c, h * w)
    idx = torch.argmax(flat, dim=2)            # the first maximum
    px, py = idx % w, idx // w

    def at(y, x):
        lin = y.clamp(0, h - 1) * w + x.clamp(0, w - 1)
        return torch.gather(flat, 2, lin[..., None])[..., 0]

    dx = torch.sign(at(py, px + 1) - at(py, px - 1))
    dy = torch.sign(at(py + 1, px) - at(py - 1, px))
    interior = (px > 0) & (px < w - 1) & (py > 0) & (py < h - 1)
    zero = torch.zeros_like(dx)
    fx = (px + 1).to(hm.dtype) + torch.where(interior, dx * 0.25, zero)
    fy = (py + 1).to(hm.dtype) + torch.where(interior, dy * 0.25, zero)
    return torch.stack([fx - 0.5, fy - 0.5], dim=-1)


def draw_gaussian_fa(size_hw: tuple[int, int], points: torch.Tensor,
                     sigma: int = 2) -> torch.Tensor:
    """face_alignment utils.draw_gaussian on fresh zero images, for C
    points at once: (C, 2) 1-based (x, y) -> (C, H, W). The
    (6 sigma + 1)-wide patch has relative sigma 0.25 and centre 0.5 of its
    size, is shifted (not clipped) where its window crosses the top or left
    edge, and is not drawn at all where the window lies outside."""
    h, w = size_hw
    spatch = 6 * sigma + 1
    p = points.float()
    ul = torch.floor(p - 3 * sigma)
    br = torch.floor(p + 3 * sigma)
    skip = (ul[:, 0] > w) | (ul[:, 1] > h) | (br[:, 0] < 1) | (br[:, 1] < 1)
    one = torch.ones((), device=p.device)

    def axis(n, lo, hi):                       # (C,), (C,) -> (C, n)
        coord = torch.arange(n, dtype=torch.float32, device=p.device)[None]
        g = (coord + 1.0) - torch.maximum(one, lo)[:, None] + torch.maximum(
            one, -lo)[:, None]
        val = torch.exp(-0.5 * torch.square(
            (g - (0.5 * spatch + 0.5)) / (0.25 * spatch)))
        last = torch.minimum(hi, torch.full_like(hi, n))
        inside = ((coord + 1.0) >= torch.maximum(one, lo)[:, None]) & (
            (coord + 1.0) <= last[:, None])
        return val * inside

    gy = axis(h, ul[:, 1], br[:, 1])
    gx = axis(w, ul[:, 0], br[:, 0])
    patch = torch.clamp(gy[:, :, None] * gx[:, None, :], max=1.0)
    return torch.where(skip[:, None, None], torch.zeros_like(patch), patch)


# ---------------------------------------------------------------------------
# the predictor (the driver's FaceAlignment(3D).get_landmarks)
# ---------------------------------------------------------------------------

class FaceAlignment3D:
    """Box-conditioned 68 x 3 landmarks of a photo: FAN3D's 2D points and,
    with a depth net, their z. Without ``depth`` z is 0, which the driver
    path does not read: ``norm_input_face`` overwrites z with the
    canonical face's. The nets run on ``device`` in eval mode; the crop
    and the transforms run on the host."""

    def __init__(self, fan: FAN3D, depth: ResNetDepth | None = None,
                 device: torch.device | str = DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.fan = fan.to(self.device).eval()
        self.depth = None if depth is None else depth.to(self.device).eval()

    @torch.no_grad()
    def heatmaps_and_depth(self, crop: np.ndarray
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor | None]:
        """A (256, 256, 3) uint8 RGB crop -> (FAN's last heatmaps
        (1, 68, 64, 64), their decoded peaks (68, 2) in heatmap space, the
        depth net's raw z (68,) or None), on the nets' device."""
        inp = torch.as_tensor(crop, device=self.device).permute(
            2, 0, 1)[None].float() / 255.0
        hm = self.fan(inp)[-1]
        preds = decode_heatmaps(hm)[0]
        if self.depth is None:
            return hm, preds, None
        pts = preds * 4.0                      # 256-space
        maps = draw_gaussian_fa((256, 256), pts, sigma=2)
        maps = torch.where((pts[:, 0] > 0)[:, None, None], maps,
                           torch.zeros_like(maps))
        z = self.depth(torch.cat([inp, maps[None]], dim=1))[0]
        return hm, preds, z

    def landmarks_from_box(self, img_rgb: np.ndarray, box) -> np.ndarray:
        """img_rgb (H, W, 3) uint8; box (x1, y1, x2, y2[, score]) ->
        (68, 3) float64 in image pixels (x, y truncated to integers as the
        reference's transform does; z in the same scale)."""
        center, scale = bbox_to_center_scale(box)
        hm, preds, z = self.heatmaps_and_depth(fa_crop(img_rgb, center,
                                                       scale))
        preds = preds.cpu().numpy()
        pts = np.stack([fa_transform(p, center, scale, hm.shape[2],
                                     invert=True)
                        for p in preds]).astype(np.float64)
        zs = (np.zeros((NUM_LANDMARKS, 1)) if z is None else
              (z.cpu().numpy().astype(np.float64)
               * (200.0 * scale / 256.0))[:, None])
        return np.concatenate([pts, zs], axis=1)

    def __call__(self, img_rgb: np.ndarray, boxes) -> list[np.ndarray]:
        """get_landmarks: one (68, 3) array per box."""
        return [self.landmarks_from_box(img_rgb, b) for b in boxes]


def make_fan_landmark_fn(fa: FaceAlignment3D, detector):
    """The end-to-end pipeline's landmark hook: aligned BGR photo ->
    (68, 3), from MTCNN's first box on the RGB image as float32 (the
    driver takes ``shapes[0]``, main_end2end_module2.py:193)."""

    def fn(img_bgr: np.ndarray) -> np.ndarray:
        rgb = np.ascontiguousarray(img_bgr[:, :, ::-1])
        boxes, _ = detector(rgb.astype(np.float32))
        if len(boxes) == 0:
            raise ValueError("no face detected for FAN landmarks")
        return fa.landmarks_from_box(rgb, boxes[0])

    return fn


# the public face_alignment package's checkpoint names
FAN_CKPT_NAMES = ("3DFAN4-4a694010b9.zip", "3DFAN4-7835d9f11d.pth.tar",
                  "3DFAN4.pth", "2DFAN4-cd938726ad.zip",
                  "2DFAN4-11f355bf06.pth.tar", "2DFAN4.pth")
DEPTH_CKPT_NAMES = ("depth-6c4283c0e0.zip", "depth-2a464da4ea.pth.tar",
                    "depth.pth")


def find_fan_checkpoints(ckpt_dir: str) -> tuple[str | None, str | None]:
    """(FAN, depth) checkpoint paths under <ckpt_dir>[/face_alignment], by
    the public names, then by the globs ``*FAN4*.pth*`` and
    ``depth-*.pth*``; None where there is none."""
    fan = depth = None
    for root in (ckpt_dir, os.path.join(ckpt_dir, "face_alignment")):
        for n in FAN_CKPT_NAMES:
            if fan is None and os.path.exists(os.path.join(root, n)):
                fan = os.path.join(root, n)
        for n in DEPTH_CKPT_NAMES:
            if depth is None and os.path.exists(os.path.join(root, n)):
                depth = os.path.join(root, n)
        if fan is None:
            g = sorted(glob.glob(os.path.join(root, "*FAN4*.pth*")))
            fan = g[0] if g else None
        if depth is None:
            g = sorted(glob.glob(os.path.join(root, "depth-*.pth*")))
            depth = g[0] if g else None
    return fan, depth
