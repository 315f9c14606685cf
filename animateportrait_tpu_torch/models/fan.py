"""The AdaptiveWingLoss FAN (stacked hourglasses with boundary-aware
CoordConv), NCHW. Port of ``animateportrait_tpu/models/fan.py`` (the
reference's Module1/thirdparty/AdaptiveWingLoss/core/{models,coord_conv}.py),
not ``fan3d.py``'s face_alignment FAN.

- ``add_coords`` appends the reference's coordinate channels: ``xx`` varies
  along H and ``yy`` along W (its swapped convention), both in [-1, 1],
  ``rr`` over its maximum, and with a heatmap the boundary channels
  ``where(clip(hm[:, -1]) > 0.05, xx / yy, 0)``, through which no gradient
  reaches the heatmap.
- Every BatchNorm is the port's ``nn.BatchNorm2d`` (flax's training
  statistics); the module names are the reference's (``conv1``, ``bn1``,
  ``m{i}.b1_{lv}``, ``top_m_{i}``, ``downsample.{0,2}``, ...).
- ``heatmaps_to_landmarks``, ``draw_gaussian`` / ``gaussian_heatmaps``,
  ``adaptive_wing_map`` / ``adaptive_wing_loss`` and ``fan_nme`` are the
  JAX package's functions on tensors, heatmaps NCHW.

No kernel of the port lies on this path.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from animateportrait_tpu_torch.nn import BatchNorm2d


def add_coords(x: torch.Tensor, with_r: bool = True,
               heatmap: torch.Tensor | None = None,
               with_boundary: bool = False) -> torch.Tensor:
    """AddCoordsTh (coord_conv.py:8-78): x (N, C, H, W) -> x with xx, yy
    (and rr, and the two boundary channels) appended."""
    n, _, h, w = x.shape
    xx = (torch.arange(h, dtype=x.dtype, device=x.device) / (h - 1) * 2 - 1
          )[:, None].expand(h, w)
    yy = (torch.arange(w, dtype=x.dtype, device=x.device) / (w - 1) * 2 - 1
          )[None, :].expand(h, w)
    xx = xx[None, None].expand(n, 1, h, w)
    yy = yy[None, None].expand(n, 1, h, w)
    chans = [x, xx, yy]
    if with_r:
        rr = torch.sqrt(xx * xx + yy * yy)
        chans.append(rr / rr.max())
    if with_boundary and heatmap is not None:
        keep = torch.clamp(heatmap[:, -1:], 0.0, 1.0) > 0.05
        chans.append(torch.where(keep, xx, torch.zeros_like(xx)))
        chans.append(torch.where(keep, yy, torch.zeros_like(yy)))
    return torch.cat(chans, dim=1)


class CoordConvTh(nn.Module):
    """CoordConvTh: coordinate channels, then a conv; forward returns (out,
    the last two channels it appended)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 1,
                 stride: int = 1, padding: int = 0, with_r: bool = True,
                 with_boundary: bool = False):
        super().__init__()
        self.with_r, self.with_boundary = with_r, with_boundary
        extra = 2 + int(with_r) + 2 * int(with_boundary)
        self.conv = nn.Conv2d(in_channels + extra, out_channels, kernel,
                              stride, padding)

    def forward(self, x, heatmap=None):
        ret = add_coords(x, self.with_r, heatmap, self.with_boundary)
        return self.conv(ret), ret[:, -2:]


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=1e-5, momentum=0.1)


class ConvBlock(nn.Module):
    """Pre-activation dense block (models.py:46-90)."""

    def __init__(self, in_planes: int, out_planes: int):
        super().__init__()
        half, quarter = out_planes // 2, out_planes // 4
        self.bn1 = _bn(in_planes)
        self.conv1 = nn.Conv2d(in_planes, half, 3, 1, 1, bias=False)
        self.bn2 = _bn(half)
        self.conv2 = nn.Conv2d(half, quarter, 3, 1, 1, bias=False)
        self.bn3 = _bn(quarter)
        self.conv3 = nn.Conv2d(quarter, quarter, 3, 1, 1, bias=False)
        self.downsample = None
        if in_planes != out_planes:
            self.downsample = nn.Sequential(
                _bn(in_planes), nn.ReLU(),
                nn.Conv2d(in_planes, out_planes, 1, bias=False))

    def forward(self, x):
        y1 = self.conv1(F.relu(self.bn1(x)))
        y2 = self.conv2(F.relu(self.bn2(y1)))
        y3 = self.conv3(F.relu(self.bn3(y2)))
        res = x if self.downsample is None else self.downsample(x)
        return torch.cat([y1, y2, y3], dim=1) + res


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """A VALID 2x2 average."""
    return F.avg_pool2d(x, 2, 2)


def _up2_nearest(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class HourGlass(nn.Module):
    """Depth-``depth`` hourglass behind a boundary CoordConv
    (models.py:92-142); forward(x, heatmap) -> (out, boundary channels)."""

    def __init__(self, depth: int = 4, first_one: bool = False,
                 features: int = 256):
        super().__init__()
        self.depth = depth
        self.coordconv = CoordConvTh(features, features, with_r=True,
                                     with_boundary=not first_one)
        for lv in range(depth, 0, -1):
            self.add_module(f"b1_{lv}", ConvBlock(features, features))
            self.add_module(f"b2_{lv}", ConvBlock(features, features))
            if lv == 1:
                self.add_module(f"b2_plus_{lv}", ConvBlock(features, features))
            self.add_module(f"b3_{lv}", ConvBlock(features, features))

    def _level(self, x, lv):
        up1 = getattr(self, f"b1_{lv}")(x)
        low1 = getattr(self, f"b2_{lv}")(_avg_pool2(x))
        if lv > 1:
            low2 = self._level(low1, lv - 1)
        else:
            low2 = getattr(self, f"b2_plus_{lv}")(low1)
        return up1 + _up2_nearest(getattr(self, f"b3_{lv}")(low2))

    def forward(self, x, heatmap=None):
        x, last = self.coordconv(x, heatmap)
        return self._level(x, self.depth), last


class FAN(nn.Module):
    """forward(img (N, 3, 256, 256) in [0, 1]) -> (heatmaps, boundary
    channels), a list of ``num_modules`` each; every heatmap (N,
    num_landmarks + 1, 64, 64), the last channel the boundary map."""

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
            self.add_module(f"m{i}", HourGlass(4, first_one=i == 0))
            self.add_module(f"top_m_{i}", ConvBlock(256, 256))
            self.add_module(f"conv_last{i}", nn.Conv2d(256, 256, 1))
            self.add_module(f"bn_end{i}", _bn(256))
            self.add_module(f"l{i}", nn.Conv2d(256, num_landmarks + 1, 1))
            if i < num_modules - 1:
                self.add_module(f"bl{i}", nn.Conv2d(256, 256, 1))
                self.add_module(f"al{i}", nn.Conv2d(num_landmarks + 1,
                                                    256, 1))

    def forward(self, x):
        x, _ = self.conv1(x)
        x = F.relu(self.bn1(x))
        x = _avg_pool2(self.conv2(x))
        x = self.conv4(self.conv3(x))
        previous, tmp_out = x, None
        outputs, boundaries = [], []
        for i in range(self.num_modules):
            hg, boundary = getattr(self, f"m{i}")(previous, tmp_out)
            ll = getattr(self, f"top_m_{i}")(hg)
            ll = F.relu(getattr(self, f"bn_end{i}")(
                getattr(self, f"conv_last{i}")(ll)))
            tmp_out = getattr(self, f"l{i}")(ll)
            if self.end_relu:
                tmp_out = F.relu(tmp_out)
            outputs.append(tmp_out)
            boundaries.append(boundary)
            if i < self.num_modules - 1:
                previous = previous + getattr(self, f"bl{i}")(ll) \
                    + getattr(self, f"al{i}")(tmp_out)
        return outputs, boundaries


def heatmaps_to_landmarks(hm: torch.Tensor) -> torch.Tensor:
    """get_preds_fromhm (utils.py:259-287): heatmaps (N, C, H, W) -> (N, C,
    2) (x, y) in heatmap pixels, 1-based with a quarter-pixel shift toward
    the stronger neighbour, then -0.5."""
    n, c, h, w = hm.shape
    flat = hm.reshape(n, c, h * w)
    idx = torch.argmax(flat, dim=2)
    px, py = idx % w, idx // w

    def gather(y, x):
        lin = y.clamp(0, h - 1) * w + x.clamp(0, w - 1)
        return torch.gather(flat, 2, lin[..., None])[..., 0]

    dx = torch.sign(gather(py, px + 1) - gather(py, px - 1))
    dy = torch.sign(gather(py + 1, px) - gather(py - 1, px))
    interior = (px > 0) & (px < w - 1) & (py > 0) & (py < h - 1)
    zero = torch.zeros_like(dx)
    fx = px + 1 + torch.where(interior, dx * 0.25, zero)
    fy = py + 1 + torch.where(interior, dy * 0.25, zero)
    return torch.stack([fx - 0.5, fy - 0.5], dim=-1)


def draw_gaussian(heatmap: torch.Tensor, point, sigma: int = 1
                  ) -> torch.Tensor:
    """AdaptiveWingLoss/utils/utils.py:42-81: adds a (6 sigma + 1)-wide
    gaussian around ``point`` (x, y) into ``heatmap`` (H, W), with the
    reference's 1-based placement and its shifted patch at the top and
    left edges, then clips to 1."""
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


def gaussian_heatmaps(points: torch.Tensor, size_hw: tuple[int, int],
                      sigma: int = 1, boundary: bool = False
                      ) -> torch.Tensor:
    """points (P, 2) -> (P, H, W) ground-truth maps (+ the accumulated
    boundary channel when ``boundary``), fp32."""
    points = torch.as_tensor(points, dtype=torch.float32)
    zero = torch.zeros(size_hw, dtype=torch.float32, device=points.device)
    maps = [draw_gaussian(zero, p, sigma) for p in points]
    if boundary:
        acc = zero
        for p in points:
            acc = draw_gaussian(acc, p, sigma)
        maps.append(acc)
    return torch.stack(maps)


def adaptive_wing_map(pred: torch.Tensor, target: torch.Tensor,
                      omega: float = 14.0, theta: float = 0.5,
                      epsilon: float = 1.0, alpha: float = 2.1
                      ) -> torch.Tensor:
    """Per-element Adaptive Wing loss (Wang et al. 2019). The exponent
    ``alpha - target`` is above 1, so the gradient at ``delta == 0`` is 0."""
    delta = torch.abs(target - pred)
    e = alpha - target
    r = theta / epsilon
    a = omega * (1.0 / (1.0 + torch.pow(r, e))) * e \
        * torch.pow(r, e - 1.0) / epsilon
    c = theta * a - omega * torch.log1p(torch.pow(r, e))
    small = omega * torch.log1p(torch.pow(delta / epsilon, e))
    large = a * delta - c
    return torch.where(delta < theta, small, large)


def adaptive_wing_loss(pred: torch.Tensor, target: torch.Tensor,
                       **kw) -> torch.Tensor:
    return torch.mean(adaptive_wing_map(pred, target, **kw))


_NME_EVAL = {"68", "98", "29", "19"}


def fan_nme(pred_heatmaps: torch.Tensor, gt_landmarks: torch.Tensor,
            num_landmarks: int = 68, stride: float = 4.0) -> torch.Tensor:
    """fan_NME (utils.py:188-223): the summed normalized mean error over
    the batch; heatmaps (N, C, H, W), ground truth (N, C, 2) in image
    pixels."""
    pred = heatmaps_to_landmarks(pred_heatmaps) * stride
    gt = gt_landmarks
    if num_landmarks == 68:
        norm = torch.linalg.norm(gt[:, 36:42].mean(1) - gt[:, 42:48].mean(1),
                                 dim=-1)
    elif num_landmarks == 98:
        norm = torch.linalg.norm(gt[:, 60] - gt[:, 72], dim=-1)
    elif num_landmarks == 29:
        norm = torch.linalg.norm(gt[:, 16] - gt[:, 17], dim=-1)
    elif num_landmarks == 19:
        lt, rb = gt[:, -2], gt[:, -1]
        norm = torch.sqrt(torch.abs(rb[:, 0] - lt[:, 0])
                          * torch.abs(lt[:, 1] - rb[:, 1]))
        gt = gt[:, :-2]
        pred = pred[:, :gt.shape[1]]
    else:
        raise ValueError(f"num_landmarks must be one of {_NME_EVAL}")
    per = torch.linalg.norm(pred - gt, dim=-1).mean(1) / norm
    return per.sum()
