"""Photo2Cartoon U-GAT-IT generator (SoftAdaLIN + hourglass), NCHW. Port of
``animateportrait_tpu/models/photo2cartoon.py`` (reference:
Module2/models/photo2cartoon.py:166-525, ngf 32 with the light FC head as
shipped), built with the reference's layout so the ``genA2B`` state-dict
keys load as they are. ``light=False`` is U-GAT-IT's full head: ``FC.0``
takes the whole bottleneck map flattened in NCHW order (C * H * W inputs,
524 288 at ngf 32 and 256^2, a 268 MB fp32 weight) instead of its spatial
mean, so the generator is built for one ``img_size``.

Every plain InstanceNorm goes through ``nn.InstanceNorm2d`` of this package
(kernel K2), with the ReLU that follows it fused in; its ``Sequential``
slot is an ``Identity``. ``LIN``/``AdaLIN`` mix instance and layer
statistics with torch's *unbiased* variance, as the reference does: plain
PyTorch, not K2. Up-sampling is nearest 2x, pooling a 2x2 average.

The reference's conv block also holds a 1x1 residual projection
(``ConvBlock4``) that only runs when its input and output widths differ;
in this generator they never do, so the port has none and a loader drops
those keys (``UNUSED_KEY``).
"""
from __future__ import annotations

import re

import torch
import torch.nn as nn
import torch.nn.functional as F

from animateportrait_tpu_torch.nn import InstanceNorm2d

# reference keys with no counterpart here: the never-run ConvBlock4
UNUSED_KEY = re.compile(r"\.ConvBlock4\.")


def _in_ln_mix(x: torch.Tensor, rho: torch.Tensor, eps: float
               ) -> torch.Tensor:
    """rho * IN(x) + (1 - rho) * LN(x), unbiased variances."""
    out_in = (x - x.mean((2, 3), keepdim=True)) * torch.rsqrt(
        x.var((2, 3), keepdim=True) + eps)
    out_ln = (x - x.mean((1, 2, 3), keepdim=True)) * torch.rsqrt(
        x.var((1, 2, 3), keepdim=True) + eps)
    return rho * out_in + (1 - rho) * out_ln


class LIN(nn.Module):
    """Learnable IN/LN mix (photo2cartoon.py:507-525)."""

    def __init__(self, nf: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.rho = nn.Parameter(torch.zeros(1, nf, 1, 1))
        self.gamma = nn.Parameter(torch.ones(1, nf, 1, 1))
        self.beta = nn.Parameter(torch.zeros(1, nf, 1, 1))

    def forward(self, x):
        return _in_ln_mix(x, self.rho, self.eps) * self.gamma + self.beta


class AdaLIN(nn.Module):
    """IN/LN mix with external gamma/beta (photo2cartoon.py:489-505)."""

    def __init__(self, nf: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.rho = nn.Parameter(torch.full((1, nf, 1, 1), 0.9))

    def forward(self, x, gamma, beta):
        return (_in_ln_mix(x, self.rho, self.eps) * gamma[:, :, None, None]
                + beta[:, :, None, None])


class SoftAdaLIN(nn.Module):
    """Content/style gamma-beta blended by learned weights
    (photo2cartoon.py:466-487)."""

    def __init__(self, nf: int):
        super().__init__()
        self.norm = AdaLIN(nf)
        self.w_gamma = nn.Parameter(torch.zeros(1, nf))
        self.w_beta = nn.Parameter(torch.zeros(1, nf))
        self.c_gamma = nn.Sequential(nn.Linear(nf, nf), nn.ReLU(),
                                     nn.Linear(nf, nf))
        self.c_beta = nn.Sequential(nn.Linear(nf, nf), nn.ReLU(),
                                    nn.Linear(nf, nf))
        self.s_gamma = nn.Linear(nf, nf)
        self.s_beta = nn.Linear(nf, nf)

    def forward(self, x, content, style):
        gamma = ((1.0 - self.w_gamma) * self.s_gamma(style)
                 + self.w_gamma * self.c_gamma(content))
        beta = ((1.0 - self.w_beta) * self.s_beta(style)
                + self.w_beta * self.c_beta(content))
        return self.norm(x, gamma, beta)


def _pre_act_conv(cin: int, cout: int) -> nn.Sequential:
    """IN + ReLU + reflect pad 1 + conv3x3 (no bias)."""
    return nn.Sequential(InstanceNorm2d(relu=True), nn.Identity(),
                         nn.ReflectionPad2d(1),
                         nn.Conv2d(cin, cout, 3, bias=False))


class UGATITConvBlock(nn.Module):
    """Pre-activation dense block: three IN+ReLU+conv stages of widths
    dim/2, dim/4, dim/4, concatenated and added to the input
    (photo2cartoon.py:294-328)."""

    def __init__(self, dim: int):
        super().__init__()
        self.ConvBlock1 = _pre_act_conv(dim, dim // 2)
        self.ConvBlock2 = _pre_act_conv(dim // 2, dim // 4)
        self.ConvBlock3 = _pre_act_conv(dim // 4, dim // 4)

    def forward(self, x):
        x1 = self.ConvBlock1(x)
        x2 = self.ConvBlock2(x1)
        x3 = self.ConvBlock3(x2)
        return x + torch.cat([x1, x2, x3], dim=1)


class HourGlassBlock(nn.Module):
    """Four-level hourglass of conv blocks (photo2cartoon.py:359-416)."""

    def __init__(self, dim: int):
        super().__init__()
        for i in range(1, 5):
            setattr(self, f"ConvBlock{i}_1", UGATITConvBlock(dim))
            setattr(self, f"ConvBlock{i}_2", UGATITConvBlock(dim))
        for i in range(5, 10):
            setattr(self, f"ConvBlock{i}", UGATITConvBlock(dim))

    def forward(self, x):
        skips, down = [], x
        for i in range(1, 5):
            skips.append(getattr(self, f"ConvBlock{i}_1")(down))
            down = getattr(self, f"ConvBlock{i}_2")(F.avg_pool2d(down, 2))
        up = self.ConvBlock5(down)
        for i in range(4):
            up = F.interpolate(getattr(self, f"ConvBlock{6 + i}")(up),
                               scale_factor=2, mode="nearest")
            up = skips[3 - i] + up
        return up


class HourGlass(nn.Module):
    """Hourglass + conv block + 1x1 conv head (photo2cartoon.py:330-357).
    With ``use_res`` the 3-channel intermediate is projected back and
    added to the input; without, it is the output."""

    def __init__(self, dim: int, use_res: bool = True):
        super().__init__()
        self.use_res = use_res
        self.HG = nn.Sequential(HourGlassBlock(dim), UGATITConvBlock(dim),
                                nn.Conv2d(dim, dim, 1, bias=False),
                                InstanceNorm2d(relu=True), nn.Identity())
        self.Conv1 = nn.Conv2d(dim, 3, 1)
        if use_res:
            self.Conv2 = nn.Conv2d(dim, dim, 1)
            self.Conv3 = nn.Conv2d(3, dim, 1)

    def forward(self, x):
        ll = self.HG(x)
        tmp_out = self.Conv1(ll)
        if not self.use_res:
            return tmp_out
        return x + self.Conv2(ll) + self.Conv3(tmp_out)


class P2CResnetBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3, bias=False),
            InstanceNorm2d(relu=True), nn.Identity(),
            nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3, bias=False),
            InstanceNorm2d())

    def forward(self, x):
        return x + self.conv_block(x)


class P2CSoftAdaLINBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv1 = nn.Conv2d(dim, dim, 3, bias=False)
        self.norm1 = SoftAdaLIN(dim)
        self.conv2 = nn.Conv2d(dim, dim, 3, bias=False)
        self.norm2 = SoftAdaLIN(dim)

    def forward(self, x, content, style):
        y = self.conv1(F.pad(x, (1, 1, 1, 1), mode="reflect"))
        y = torch.relu(self.norm1(y, content, style))
        y = self.conv2(F.pad(y, (1, 1, 1, 1), mode="reflect"))
        return self.norm2(y, content, style) + x


def _up_block(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(nn.Upsample(scale_factor=2, mode="nearest"),
                         nn.ReflectionPad2d(1),
                         nn.Conv2d(cin, cout, 3, bias=False), LIN(cout),
                         nn.ReLU())


def _down_block(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(nn.ReflectionPad2d(1),
                         nn.Conv2d(cin, cout, 3, 2, bias=False),
                         InstanceNorm2d(relu=True), nn.Identity())


class Photo2CartoonGenerator(nn.Module):
    """U-GAT-IT ResnetGenerator, with the light FC head (the shipped one)
    or, ``light=False``, the full head for ``img_size``^2 inputs.

    forward(img (N, 3, H, W) in [-1, 1]) -> (cartoon (N, 3, H, W),
    cam_logit (N, 2), heatmap (N, 1, H/4, W/4))."""

    def __init__(self, ngf: int = 32, light: bool = True,
                 img_size: int = 256):
        super().__init__()
        self.light = light
        self.ConvBlock1 = nn.Sequential(
            nn.ReflectionPad2d(3), nn.Conv2d(3, ngf, 7, bias=False),
            InstanceNorm2d(relu=True), nn.Identity())
        self.HourGlass1 = HourGlass(ngf)
        self.HourGlass2 = HourGlass(ngf)
        self.DownBlock1 = _down_block(ngf, ngf * 2)
        self.DownBlock2 = _down_block(ngf * 2, ngf * 4)
        for i in range(1, 5):
            setattr(self, f"EncodeBlock{i}", P2CResnetBlock(ngf * 4))
        self.gap_fc = nn.Linear(ngf * 4, 1)
        self.gmp_fc = nn.Linear(ngf * 4, 1)
        self.conv1x1 = nn.Conv2d(ngf * 8, ngf * 4, 1)
        fc_in = ngf * 4 * (1 if light else (img_size // 4) ** 2)
        self.FC = nn.Sequential(nn.Linear(fc_in, ngf * 4), nn.ReLU(),
                                nn.Linear(ngf * 4, ngf * 4), nn.ReLU())
        for i in range(1, 5):
            setattr(self, f"DecodeBlock{i}", P2CSoftAdaLINBlock(ngf * 4))
        self.UpBlock1 = _up_block(ngf * 4, ngf * 2)
        self.UpBlock2 = _up_block(ngf * 2, ngf)
        self.HourGlass3 = HourGlass(ngf)
        self.HourGlass4 = HourGlass(ngf, use_res=False)
        self.ConvBlock2 = nn.Sequential(
            nn.ReflectionPad2d(3), nn.Conv2d(3, 3, 7, bias=False), nn.Tanh())

    def forward(self, x):
        x = self.ConvBlock1(x)
        x = self.HourGlass2(self.HourGlass1(x))
        x = self.DownBlock2(self.DownBlock1(x))
        contents = []
        for i in range(1, 5):
            x = getattr(self, f"EncodeBlock{i}")(x)
            contents.append(x.mean((2, 3)))
        gap_logit = self.gap_fc(x.mean((2, 3)))
        gap_x = x * self.gap_fc.weight[0][None, :, None, None]
        gmp_logit = self.gmp_fc(x.amax((2, 3)))
        gmp_x = x * self.gmp_fc.weight[0][None, :, None, None]
        cam_logit = torch.cat([gap_logit, gmp_logit], dim=1)
        x = torch.relu(self.conv1x1(torch.cat([gap_x, gmp_x], dim=1)))
        heatmap = x.sum(1, keepdim=True)
        style = self.FC(x.mean((2, 3)) if self.light else x.flatten(1))
        for i in range(1, 5):
            x = getattr(self, f"DecodeBlock{i}")(x, contents[4 - i], style)
        x = self.UpBlock2(self.UpBlock1(x))
        x = self.HourGlass4(self.HourGlass3(x))
        return self.ConvBlock2(x), cam_logit, heatmap
