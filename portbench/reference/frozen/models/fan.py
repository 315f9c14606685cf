"""The Adaptive Wing stacked-hourglass FAN and its loss in plain ``torch``,
as the ``fan_awing_train`` configuration runs them (Wang, Bo and Fuxin,
"Adaptive Wing Loss for Robust Face Alignment via Heatmap Regression",
ICCV 2019; https://github.com/protossw512/AdaptiveWingLoss, vendored in
AnimatePortrait as Module1/thirdparty/AdaptiveWingLoss/core/{models,
coord_conv}.py): the boundary-aware CoordConv, the pre-activation dense
``ConvBlock``, the recursive ``HourGlass`` and the stacked ``FAN`` with
intermediate supervision; the Adaptive Wing map; and the training
targets (the gaussian maps, the B-spline boundary map and the weight
map of the vendored data loader, on the host). NCHW; the module layout
gives the reference checkpoints' state-dict keys.

What the published code does, kept as it is:

- the coordinate channels are its swapped ones: ``xx`` varies along H and
  ``yy`` along W, both in [-1, 1]; ``rr`` is divided by its maximum over
  the whole batch's tensor;
- the boundary channels gate ``xx`` and ``yy`` where the previous stack's
  last heatmap, clipped to [0, 1], is above 0.05: a threshold no gradient
  passes;
- the nearest 2x upsampling and the 2x2 average pooling of the hourglass.

BatchNorm is ``frozen/models/pose.py``'s, written out. One departure from
the published model is kept on purpose, because the port makes it: in
training mode the batch variance is flax's biased E[x^2] - E[x]^2
(clipped at 0), and the running variance takes that biased value
(torch's BatchNorm2d takes the unbiased one). The Adaptive Wing map is
the paper's formula, ``omega ln(1 + (delta / epsilon)^(alpha - y))``
below ``theta``."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.frozen.models.pose import BatchNorm2d

# WFLW's 98-point curves, as the data loader's AddBoundary draws them
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


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=1e-5, momentum=0.1)


def add_coords(x, heatmap=None, with_boundary: bool = False):
    """AddCoordsTh with ``with_r``: x (N, C, H, W) -> x, xx, yy, rr (and
    the two boundary channels when ``with_boundary`` and a heatmap)."""
    n, _, h, w = x.shape
    xx = (torch.arange(h, dtype=x.dtype, device=x.device) / (h - 1)
          * 2 - 1)[None, None, :, None].expand(n, 1, h, w)
    yy = (torch.arange(w, dtype=x.dtype, device=x.device) / (w - 1)
          * 2 - 1)[None, None, None, :].expand(n, 1, h, w)
    rr = torch.sqrt(xx ** 2 + yy ** 2)
    chans = [x, xx, yy, rr / torch.max(rr)]
    if with_boundary and heatmap is not None:
        gate = torch.clamp(heatmap[:, -1:], 0.0, 1.0) > 0.05
        zero = torch.zeros_like(xx)
        chans += [torch.where(gate, xx, zero), torch.where(gate, yy, zero)]
    return torch.cat(chans, 1)


class CoordConvTh(nn.Module):
    """Coordinate channels, then a conv; forward returns (out, the last
    two channels appended)."""

    def __init__(self, cin: int, cout: int, kernel: int = 1,
                 stride: int = 1, padding: int = 0,
                 with_boundary: bool = False):
        super().__init__()
        self.with_boundary = with_boundary
        self.conv = nn.Conv2d(cin + 3 + 2 * int(with_boundary), cout,
                              kernel, stride, padding)

    def forward(self, x, heatmap=None):
        ret = add_coords(x, heatmap, self.with_boundary)
        return self.conv(ret), ret[:, -2:]


class ConvBlock(nn.Module):
    """models.py ConvBlock: three pre-activated 3x3 convs to half, a
    quarter and a quarter of ``cout``, concatenated, plus the input (or
    its pre-activated 1x1 projection)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.bn1 = _bn(cin)
        self.conv1 = nn.Conv2d(cin, cout // 2, 3, 1, 1, bias=False)
        self.bn2 = _bn(cout // 2)
        self.conv2 = nn.Conv2d(cout // 2, cout // 4, 3, 1, 1, bias=False)
        self.bn3 = _bn(cout // 4)
        self.conv3 = nn.Conv2d(cout // 4, cout // 4, 3, 1, 1, bias=False)
        self.downsample = None
        if cin != cout:
            self.downsample = nn.Sequential(
                _bn(cin), nn.ReLU(), nn.Conv2d(cin, cout, 1, bias=False))

    def forward(self, x):
        out1 = self.conv1(F.relu(self.bn1(x)))
        out2 = self.conv2(F.relu(self.bn2(out1)))
        out3 = self.conv3(F.relu(self.bn3(out2)))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.cat((out1, out2, out3), 1) + residual


class HourGlass(nn.Module):
    """A boundary CoordConv, then a recursive hourglass of ``depth``
    levels: at each level an upper branch and a pooled lower branch,
    added after the nearest 2x upsampling."""

    def __init__(self, depth: int, first_one: bool, features: int = 256):
        super().__init__()
        self.depth = depth
        self.coordconv = CoordConvTh(features, features,
                                     with_boundary=not first_one)
        for level in range(depth, 0, -1):
            self.add_module(f"b1_{level}", ConvBlock(features, features))
            self.add_module(f"b2_{level}", ConvBlock(features, features))
            if level == 1:
                self.add_module(f"b2_plus_{level}",
                                ConvBlock(features, features))
            self.add_module(f"b3_{level}", ConvBlock(features, features))

    def _forward(self, level: int, x):
        up1 = self._modules[f"b1_{level}"](x)
        low1 = self._modules[f"b2_{level}"](F.avg_pool2d(x, 2, stride=2))
        if level > 1:
            low2 = self._forward(level - 1, low1)
        else:
            low2 = self._modules[f"b2_plus_{level}"](low1)
        low3 = self._modules[f"b3_{level}"](low2)
        return up1 + F.interpolate(low3, scale_factor=2, mode="nearest")

    def forward(self, x, heatmap=None):
        x, last = self.coordconv(x, heatmap)
        return self._forward(self.depth, x), last


class FAN(nn.Module):
    """The published FAN: 4 stacked hourglasses of depth 4 and 256
    features by default; forward(img (N, 3, S, S)) -> (heatmaps, boundary
    channels), one of each a stack; every heatmap (N, num_landmarks + 1,
    S/4, S/4)."""

    def __init__(self, num_modules: int = 4, num_landmarks: int = 98,
                 end_relu: bool = False):
        super().__init__()
        self.num_modules, self.end_relu = num_modules, end_relu
        self.conv1 = CoordConvTh(3, 64, kernel=7, stride=2, padding=3)
        self.bn1 = _bn(64)
        self.conv2 = ConvBlock(64, 128)
        self.conv3 = ConvBlock(128, 128)
        self.conv4 = ConvBlock(128, 256)
        for i in range(num_modules):
            self.add_module(f"m{i}", HourGlass(4, i == 0))
            self.add_module(f"top_m_{i}", ConvBlock(256, 256))
            self.add_module(f"conv_last{i}", nn.Conv2d(256, 256, 1))
            self.add_module(f"bn_end{i}", _bn(256))
            self.add_module(f"l{i}", nn.Conv2d(256, num_landmarks + 1, 1))
            if i < num_modules - 1:
                self.add_module(f"bl{i}", nn.Conv2d(256, 256, 1))
                self.add_module(f"al{i}", nn.Conv2d(num_landmarks + 1, 256,
                                                    1))

    def forward(self, x):
        x, _ = self.conv1(x)
        x = F.relu(self.bn1(x))
        x = F.avg_pool2d(self.conv2(x), 2, stride=2)
        x = self.conv4(self.conv3(x))
        previous, tmp_out = x, None
        outputs, boundary_channels = [], []
        for i in range(self.num_modules):
            hg, boundary = self._modules[f"m{i}"](previous, tmp_out)
            ll = self._modules[f"top_m_{i}"](hg)
            ll = F.relu(self._modules[f"bn_end{i}"](
                self._modules[f"conv_last{i}"](ll)))
            tmp_out = self._modules[f"l{i}"](ll)
            if self.end_relu:
                tmp_out = F.relu(tmp_out)
            outputs.append(tmp_out)
            boundary_channels.append(boundary)
            if i < self.num_modules - 1:
                previous = previous + self._modules[f"bl{i}"](ll) \
                    + self._modules[f"al{i}"](tmp_out)
        return outputs, boundary_channels


def adaptive_wing_map(pred, target, omega: float = 14.0,
                      theta: float = 0.5, epsilon: float = 1.0,
                      alpha: float = 2.1):
    """The per-element Adaptive Wing loss: ``omega ln(1 + (delta /
    epsilon)^(alpha - y))`` where ``delta = |y - pred|`` is under
    ``theta``, else ``A delta - C``, the line that meets it there with
    its slope."""
    delta = (target - pred).abs()
    e = alpha - target
    ratio = theta / epsilon
    a = omega * (1 / (1 + torch.pow(ratio, e))) * e \
        * torch.pow(ratio, e - 1) * (1 / epsilon)
    c = theta * a - omega * torch.log1p(torch.pow(ratio, e))
    small = omega * torch.log1p(torch.pow(delta / epsilon, e))
    return torch.where(delta < theta, small, a * delta - c)


# --- training targets (core/dataloader.py), on the host --------------------

def draw_gaussian(heatmap: torch.Tensor, point, sigma: int = 1
                  ) -> torch.Tensor:
    """utils.py draw_gaussian: adds a (6 sigma + 1)-wide gaussian around
    ``point`` (x, y) into ``heatmap`` (H, W) at the published code's
    1-based placement, with its shifted patch at the top and left edges,
    then clips to 1."""
    h, w = heatmap.shape
    dev, dt = heatmap.device, heatmap.dtype
    point = torch.as_tensor(point, dtype=dt, device=dev)
    size = 6 * sigma + 1
    ulx = torch.floor(torch.floor(point[0]) - 3 * sigma)
    uly = torch.floor(torch.floor(point[1]) - 3 * sigma)
    brx = torch.floor(torch.floor(point[0]) + 3 * sigma)
    bry = torch.floor(torch.floor(point[1]) + 3 * sigma)
    skip = (ulx > w) | (uly > h) | (brx < 1) | (bry < 1)
    one = torch.ones((), dtype=dt, device=dev)

    def axis_vals(n, ul, br):
        coords = torch.arange(n, dtype=dt, device=dev)
        r = coords - torch.maximum(one, ul) + torch.maximum(one, -ul)
        val = torch.exp(-0.5 * torch.square((r - 3 * sigma) / (0.25 * size)))
        inside = (coords >= torch.maximum(one, ul) - 1) & \
            (coords < torch.minimum(br, torch.full_like(br, n)))
        return val * inside

    patch = axis_vals(h, uly, bry)[:, None] * axis_vals(w, ulx, brx)[None, :]
    out = torch.clamp(heatmap + patch, max=1.0)
    return torch.where(skip, heatmap, out)


def boundary_heatmap(landmarks: np.ndarray, size: int = 64,
                     sigma: float = 1.0) -> np.ndarray:
    """AddBoundary for 98 points: B-splines through each curve of
    ``BOUNDARY_GROUPS_98`` (``splprep`` k = min(4, n) - 1, s = 0) on the
    heatmap grid, turned into a line map by a distance transform, ``exp(-d^2
    / 2 sigma^2)`` cut at 3 sigma. Landmarks (98, 2) in image pixels."""
    from scipy import interpolate, ndimage

    lm = np.floor(landmarks[:, :2] / 4.0)
    mask = np.ones((size, size), np.float32)
    for inds in BOUNDARY_GROUPS_98.values():
        pts = lm[inds]
        keep = [0]
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
    """AddWeightMap: 1 where the 3x3 grey dilation of a map exceeds 0.2."""
    from scipy import ndimage

    w = np.zeros_like(heatmaps)
    for c in range(heatmaps.shape[0]):
        d = ndimage.grey_dilation(heatmaps[c], size=(3, 3))
        w[c] = (d > 0.2).astype(heatmaps.dtype)
    return w


def fan_targets(landmarks: np.ndarray, hm_size: int = 64
                ) -> tuple[np.ndarray, np.ndarray]:
    """Landmarks (98, 2) (x, y) in image pixels -> (maps, weights), each
    (99, hm, hm) fp32: the gaussians at landmarks / 4 + 1 (sigma 1), the
    boundary map last, and the weight map of all 99."""
    p = landmarks.shape[0]
    zero = torch.zeros((hm_size, hm_size), dtype=torch.float32)
    pts = torch.from_numpy((landmarks[:, :2] / 4.0 + 1.0).astype(np.float32))
    hm = np.zeros((p + 1, hm_size, hm_size), np.float32)
    hm[:p] = torch.stack([draw_gaussian(zero, q) for q in pts]).numpy()
    hm[p] = boundary_heatmap(landmarks, size=hm_size)
    return hm, weight_map(hm)
