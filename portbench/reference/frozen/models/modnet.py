"""MODNet portrait matting (MobileNetV2 backbone), inference. Port of
``animateportrait_tpu/models/modnet.py`` with the reference's module
layout (Module2/models/modnet.py + backbones/{mobilenetv2,wrapper}.py), so
the state-dict keys are the reference checkpoint's. Only the matte is
computed: the semantic and detail heads serve training.

``IBNorm`` normalizes half of the channels by BatchNorm and half by
InstanceNorm; the InstanceNorm half goes through kernel K2, which takes a
contiguous tensor, so the channel slice is made contiguous first.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.frozen.nn import BatchNorm2d, InstanceNorm2d

ENC_CHANNELS = (16, 24, 32, 96, 1280)
HR_CHANNELS = 32
_MOBILENET_SETTING = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
                      (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2),
                      (6, 320, 1, 1))


def _conv_bn(cin, cout, k, stride, pad):
    return nn.Sequential(nn.Conv2d(cin, cout, k, stride, pad, bias=False),
                         BatchNorm2d(cout), nn.ReLU6())


class InvertedResidual(nn.Module):
    def __init__(self, inp: int, oup: int, stride: int, expansion: int):
        super().__init__()
        hidden = round(inp * expansion)
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expansion != 1:
            layers += [nn.Conv2d(inp, hidden, 1, 1, 0, bias=False),
                       BatchNorm2d(hidden), nn.ReLU6()]
        layers += [nn.Conv2d(hidden, hidden, 3, stride, 1, groups=hidden,
                             bias=False),
                   BatchNorm2d(hidden), nn.ReLU6(),
                   nn.Conv2d(hidden, oup, 1, 1, 0, bias=False),
                   BatchNorm2d(oup)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        return x + self.conv(x) if self.use_res else self.conv(x)


class MobileNetV2(nn.Module):
    def __init__(self):
        super().__init__()
        feats = [_conv_bn(3, 32, 3, 2, 1)]
        inp = 32
        for t, c, n, s in _MOBILENET_SETTING:
            for i in range(n):
                feats.append(InvertedResidual(inp, c, s if i == 0 else 1, t))
                inp = c
        feats.append(_conv_bn(inp, 1280, 1, 1, 0))
        self.features = nn.Sequential(*feats)


class MobileNetV2Backbone(nn.Module):
    """Returns [enc2x, enc4x, enc8x, enc16x, enc32x]."""

    def __init__(self):
        super().__init__()
        self.model = MobileNetV2()

    def forward(self, x):
        outs = []
        for i, f in enumerate(self.model.features):
            x = f(x)
            if i in (1, 3, 6, 13, 18):
                outs.append(x)
        return outs


class IBNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.bnorm_channels = c // 2
        self.bnorm = BatchNorm2d(c // 2)
        self.inorm = InstanceNorm2d()

    def forward(self, x):
        h = self.bnorm_channels
        return torch.cat([self.bnorm(x[:, :h]),
                          self.inorm(x[:, h:].contiguous())], dim=1)


class Conv2dIBNormRelu(nn.Module):
    def __init__(self, cin, cout, k, stride=1, padding=0, with_ibn=True,
                 with_relu=True):
        super().__init__()
        layers = [nn.Conv2d(cin, cout, k, stride=stride, padding=padding)]
        if with_ibn:
            layers.append(IBNorm(cout))
        if with_relu:
            layers.append(nn.ReLU())
        self.layers = nn.Sequential(*layers)

    def forward(self, x):
        return self.layers(x)


class SEBlock(nn.Module):
    def __init__(self, c: int, r: int = 4):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(c, c // r, bias=False), nn.ReLU(),
                                nn.Linear(c // r, c, bias=False),
                                nn.Sigmoid())

    def forward(self, x):
        w = self.fc(x.mean(dim=(2, 3)))
        return x * w[:, :, None, None]


def _up2x(x):
    return F.interpolate(x, size=(x.shape[2] * 2, x.shape[3] * 2),
                         mode="bilinear", align_corners=False)


def _down(x, factor):
    return F.interpolate(x, size=(x.shape[2] // factor, x.shape[3] // factor),
                         mode="bilinear", align_corners=False)


class LRBranch(nn.Module):
    def __init__(self):
        super().__init__()
        ec = ENC_CHANNELS
        self.backbone = MobileNetV2Backbone()
        self.se_block = SEBlock(ec[4])
        self.conv_lr16x = Conv2dIBNormRelu(ec[4], ec[3], 5, padding=2)
        self.conv_lr8x = Conv2dIBNormRelu(ec[3], ec[2], 5, padding=2)

    def forward(self, img):
        enc = self.backbone(img)
        lr16x = self.conv_lr16x(_up2x(self.se_block(enc[4])))
        return self.conv_lr8x(_up2x(lr16x)), enc[0], enc[1]


class HRBranch(nn.Module):
    def __init__(self, hc: int = HR_CHANNELS):
        super().__init__()
        ec = ENC_CHANNELS
        self.tohr_enc2x = Conv2dIBNormRelu(ec[0], hc, 1)
        self.conv_enc2x = Conv2dIBNormRelu(hc + 3, hc, 3, stride=2, padding=1)
        self.tohr_enc4x = Conv2dIBNormRelu(ec[1], hc, 1)
        self.conv_enc4x = Conv2dIBNormRelu(2 * hc, 2 * hc, 3, padding=1)
        self.conv_hr4x = nn.Sequential(
            Conv2dIBNormRelu(3 * hc + 3, 2 * hc, 3, padding=1),
            Conv2dIBNormRelu(2 * hc, 2 * hc, 3, padding=1),
            Conv2dIBNormRelu(2 * hc, hc, 3, padding=1))
        self.conv_hr2x = nn.Sequential(
            Conv2dIBNormRelu(2 * hc, 2 * hc, 3, padding=1),
            Conv2dIBNormRelu(2 * hc, hc, 3, padding=1),
            Conv2dIBNormRelu(hc, hc, 3, padding=1),
            Conv2dIBNormRelu(hc, hc, 3, padding=1))

    def forward(self, img, enc2x, enc4x, lr8x):
        enc2x = self.tohr_enc2x(enc2x)
        hr4x = self.conv_enc2x(torch.cat([_down(img, 2), enc2x], dim=1))
        hr4x = self.conv_enc4x(torch.cat([hr4x, self.tohr_enc4x(enc4x)],
                                         dim=1))
        hr4x = self.conv_hr4x(torch.cat([hr4x, _up2x(lr8x), _down(img, 4)],
                                        dim=1))
        return self.conv_hr2x(torch.cat([_up2x(hr4x), enc2x], dim=1))


class FusionBranch(nn.Module):
    def __init__(self, hc: int = HR_CHANNELS):
        super().__init__()
        self.conv_lr4x = Conv2dIBNormRelu(ENC_CHANNELS[2], hc, 5, padding=2)
        self.conv_f2x = Conv2dIBNormRelu(2 * hc, hc, 3, padding=1)
        self.conv_f = nn.Sequential(
            Conv2dIBNormRelu(hc + 3, hc // 2, 3, padding=1),
            Conv2dIBNormRelu(hc // 2, 1, 1, with_ibn=False, with_relu=False))

    def forward(self, img, lr8x, hr2x):
        lr2x = _up2x(self.conv_lr4x(_up2x(lr8x)))
        f2x = self.conv_f2x(torch.cat([lr2x, hr2x], dim=1))
        return torch.sigmoid(self.conv_f(torch.cat([_up2x(f2x), img], dim=1)))


class MODNet(nn.Module):
    """forward(img (N,3,H,W) in [-1,1]) -> matte (N,1,H,W) in [0,1]."""

    def __init__(self, hr_channels: int = HR_CHANNELS):
        super().__init__()
        self.lr_branch = LRBranch()
        self.hr_branch = HRBranch(hr_channels)
        self.f_branch = FusionBranch(hr_channels)
        self.eval()

    def forward(self, img):
        lr8x, enc2x, enc4x = self.lr_branch(img)
        hr2x = self.hr_branch(img, enc2x, enc4x, lr8x)
        return self.f_branch(img, lr8x, hr2x)
