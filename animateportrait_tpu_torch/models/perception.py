"""Frozen perception nets of the training losses, NCHW. Port of
``animateportrait_tpu/models/perception.py``: MobileFaceNet (the 68-point
landmark regressor of the geometry loss), Sphere20a (the sphereface
features of the identity loss), ``face_loss`` and ``crop_head_bbox``.

The modules keep the reference's layout (Module2/models/mobilefacenet.py,
Module2/models/facenet.py:200-282), so their state-dict keys are the
reference checkpoints'. MobileFaceNet's BatchNorms run on their running
statistics: build it, then call ``.eval()`` (``init_frozen_random`` and the
training step do). Both nets stay frozen in training: the losses
differentiate through them with respect to their input only.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from animateportrait_tpu_torch.ops.warp import sample_bilinear


class ConvBlock(nn.Module):
    """Conv (no bias) + BN + PReLU (mobilefacenet.py:17-27)."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1,
                 padding: int = 0, groups: int = 1, prelu: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding,
                              groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(cout)
        self.prelu = nn.PReLU(cout) if prelu else None

    def forward(self, x):
        x = self.bn(self.conv(x))
        return x if self.prelu is None else self.prelu(x)


def _linear_block(cin: int, cout: int, kernel: int = 1,
                  groups: int = 1) -> ConvBlock:
    """Conv (no bias) + BN, no activation (mobilefacenet.py:29-37)."""
    return ConvBlock(cin, cout, kernel, groups=groups, prelu=False)


class DepthWise(nn.Module):
    """1x1 expand to ``groups`` -> 3x3 depthwise -> 1x1 project to ``cout``
    (mobilefacenet.py:39-56), with the input added when ``residual``."""

    def __init__(self, cin: int, cout: int, groups: int, stride: int = 2,
                 residual: bool = False):
        super().__init__()
        self.conv = ConvBlock(cin, groups)
        self.conv_dw = ConvBlock(groups, groups, 3, stride, 1, groups=groups)
        self.project = _linear_block(groups, cout)
        self.residual = residual

    def forward(self, x):
        y = self.project(self.conv_dw(self.conv(x)))
        return x + y if self.residual else y


class Residual(nn.Module):
    """``num_block`` residual DepthWise blocks (mobilefacenet.py:58-67)."""

    def __init__(self, c: int, num_block: int, groups: int):
        super().__init__()
        self.model = nn.Sequential(*[
            DepthWise(c, c, groups, stride=1, residual=True)
            for _ in range(num_block)])

    def forward(self, x):
        return self.model(x)


class GDC(nn.Module):
    """The global depthwise head: 7x7 depthwise, flatten, linear, BN."""

    def __init__(self, embedding_size: int):
        super().__init__()
        self.conv_6_dw = _linear_block(512, 512, 7, groups=512)
        self.linear = nn.Linear(512, embedding_size, bias=False)
        self.bn = nn.BatchNorm1d(embedding_size)

    def forward(self, x):
        return self.bn(self.linear(self.conv_6_dw(x).flatten(1)))


class MobileFaceNet(nn.Module):
    """forward(img (N, 3, 112, 112) in [0, 1]) -> (landmarks (N, 136) as
    68 x (x, y) in [0, 1], features (N, 512, 7, 7))."""

    def __init__(self, embedding_size: int = 136):
        super().__init__()
        self.conv1 = ConvBlock(3, 64, 3, 2, 1)
        self.conv2_dw = ConvBlock(64, 64, 3, 1, 1, groups=64)
        self.conv_23 = DepthWise(64, 64, 128)
        self.conv_3 = Residual(64, 4, 128)
        self.conv_34 = DepthWise(64, 128, 256)
        self.conv_4 = Residual(128, 6, 256)
        self.conv_45 = DepthWise(128, 128, 512)
        self.conv_5 = Residual(128, 2, 256)
        self.conv_6_sep = ConvBlock(128, 512)
        self.output_layer = GDC(embedding_size)

    def forward(self, x):
        x = self.conv2_dw(self.conv1(x))
        x = self.conv_3(self.conv_23(x))
        x = self.conv_4(self.conv_34(x))
        x = self.conv_5(self.conv_45(x))
        features = self.conv_6_sep(x)
        return self.output_layer(features), features


# Sphere20a's stages: (first conv, channels, residual pairs)
_SPHERE_STAGES = ((1, 64, 1), (2, 128, 2), (3, 256, 4), (4, 512, 1))


class Sphere20a(nn.Module):
    """forward(img (N, 3, 112, 96) in [-1, 1]) -> the 5 feature levels of
    the FaceLoss (facenet.py:200-282): the output of each of the 4 PReLU
    residual stages, then ``fc5`` of the NCHW-flattened last one."""

    def __init__(self):
        super().__init__()
        cin = 3
        for stage, ch, pairs in _SPHERE_STAGES:
            for j in range(1, 2 * pairs + 2):
                self.add_module(f"conv{stage}_{j}", nn.Conv2d(
                    cin, ch, 3, 2 if j == 1 else 1, 1))
                self.add_module(f"relu{stage}_{j}", nn.PReLU(ch))
                cin = ch
        self.fc5 = nn.Linear(512 * 7 * 6, 512)

    def _conv(self, name: str, x):
        return getattr(self, f"relu{name}")(getattr(self, f"conv{name}")(x))

    def forward(self, x):
        feats = []
        for stage, _, pairs in _SPHERE_STAGES:
            x = self._conv(f"{stage}_1", x)
            for p in range(pairs):
                a, b = f"{stage}_{2 * p + 2}", f"{stage}_{2 * p + 3}"
                x = x + self._conv(b, self._conv(a, x))
            feats.append(x)
        feats.append(self.fc5(x.flatten(1)))
        return feats


def face_loss(net: nn.Module, img1: torch.Tensor,
              img2: torch.Tensor) -> torch.Tensor:
    """FaceLoss.compute_loss (networks.py:2995-3009): the unweighted sum of
    the mean L1 distances between the 5 feature levels of ``img1`` and of
    the reference ``img2``, which carries no gradient. Inputs NCHW
    112 x 96 in [-1, 1]."""
    f1 = net(img1)
    with torch.no_grad():
        f2 = net(img2)
    loss = 0.0
    for a, b in zip(f1, f2):
        loss = loss + torch.mean(torch.abs(a - b))
    return loss


def crop_head_bbox(imgs: torch.Tensor, bboxs: torch.Tensor,
                   out_hw: tuple[int, int] = (112, 96)) -> torch.Tensor:
    """FaceLoss.crop_head_bbox (networks.py:3014-3037): crop each sample's
    box [lt_x, rt_x, lt_y, rt_y] of ``imgs`` (N, C, H, W) and resize it to
    ``out_hw`` as one bilinear sample grid over the box (align_corners
    semantics, border clamping)."""
    n = imgs.shape[0]
    h, w = out_hw
    b = bboxs.to(torch.float32)
    x0, x1, y0, y1 = (b[:, i, None, None] for i in range(4))
    ty = torch.linspace(0.0, 1.0, h, device=imgs.device)[None, :, None]
    tx = torch.linspace(0.0, 1.0, w, device=imgs.device)[None, None, :]
    iy = (y0 + ty * (y1 - 1 - y0)).expand(n, h, w)
    ix = (x0 + tx * (x1 - 1 - x0)).expand(n, h, w)
    return sample_bilinear(imgs, iy, ix)
