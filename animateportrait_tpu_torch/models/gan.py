"""Module2 generators of the slice, NCHW. Port of the inference generators
of ``animateportrait_tpu/models/gan.py``: ``TridentGeneratorFullIFW``
(with its ``encode_static`` / ``decode`` split) and
``ResnetStyle2Generator``, built with the reference's ``Sequential``
layout (Module2/models/networks.py) so the state-dict keys are the
reference checkpoints'.

Every InstanceNorm is ``nn.InstanceNorm2d`` of this package (kernel K2)
with the ReLU that follows it fused in; the ReLU's ``Sequential`` slot
holds an ``Identity`` so later indices keep their reference numbers. The
final ``OutConv7`` is a plain reflect-padded 7x7 conv on the same
parameters (the JAX space-to-depth packing is a TPU layout trick).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from animateportrait_tpu_torch.nn import InstanceNorm2d, conv_in_relu
from animateportrait_tpu_torch.ops.warp import warp_acc_flow


def _stem(cin: int, cout: int) -> nn.Sequential:
    """ReflectionPad(3) + Conv7x7 + IN + ReLU."""
    return nn.Sequential(nn.ReflectionPad2d(3), nn.Conv2d(cin, cout, 7),
                         InstanceNorm2d(relu=True), nn.Identity())


def _up2x(cin: int, cout: int) -> list[nn.Module]:
    """ConvTranspose(k3, s2, p1, op1) + IN + ReLU."""
    return [nn.ConvTranspose2d(cin, cout, 3, 2, 1, output_padding=1),
            InstanceNorm2d(relu=True), nn.Identity()]


def _out_conv7(cin: int, cout: int) -> list[nn.Module]:
    return [nn.ReflectionPad2d(3), nn.Conv2d(cin, cout, 7), nn.Tanh()]


class ResnetBlock(nn.Module):
    """networks.py:2303-2361, reflect padding."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3),
            InstanceNorm2d(relu=True), nn.Identity(),
            nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3),
            InstanceNorm2d())

    def forward(self, x):
        return x + self.conv_block(x)


class ResnetBlock2(nn.Module):
    """networks.py:2363-2421: the block with a conv shortcut."""

    def __init__(self, din: int, dout: int):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.ReflectionPad2d(1), nn.Conv2d(din, dout, 3),
            InstanceNorm2d(relu=True), nn.Identity(),
            nn.ReflectionPad2d(1), nn.Conv2d(dout, dout, 3),
            InstanceNorm2d())
        self.shortcut = nn.Sequential(nn.Conv2d(din, dout, 3, padding=1),
                                      InstanceNorm2d())

    def forward(self, x):
        return self.shortcut(x) + self.conv_block(x)


class ResnetStyle2Generator(nn.Module):
    """Static photo -> drawing net with the style injected at the
    bottleneck (networks.py:573-637). forward(photo, style_map)."""

    def __init__(self, input_nc: int = 3, output_nc: int = 1, ngf: int = 64,
                 n_blocks: int = 9, extra_channel: int = 3):
        super().__init__()
        m0 = list(_stem(input_nc, ngf))
        for i in range(2):
            mult = 2 ** i
            m0 += conv_in_relu(ngf * mult, ngf * mult * 2, stride=2)
        m = conv_in_relu(ngf * 4 + extra_channel, ngf * 4)
        m += [ResnetBlock(ngf * 4) for _ in range(n_blocks)]
        for i in range(2):
            mult = 2 ** (2 - i)
            m += _up2x(ngf * mult, ngf * mult // 2)
        m += _out_conv7(ngf, output_nc)
        self.model0 = nn.Sequential(*m0)
        self.model = nn.Sequential(*m)

    def forward(self, x, style):
        return self.model(torch.cat([self.model0(x), style], dim=1))


def double_feature_warping(x: torch.Tensor, motion: torch.Tensor,
                           flow: torch.Tensor, ifmask: torch.Tensor,
                           level: int) -> torch.Tensor:
    """Warp features by BOTH the TPS motion grid and the intrinsic flow
    and concatenate the two (networks.py:1296-1313).

    x (N,C,H,W); motion (N,Hm,Wm,2) normalized (x, y) grid; flow
    (N,2,Hf,Wf) pixel flow at full resolution; ifmask (N,1,Hf,Wf). At
    level > 0 the three are resized to x's size with align_corners=True
    (the flow also divided by 2**level). The motion warp samples with
    align_corners=False; the flow warp has the ``warp_acc_flow`` quirk and
    is -1 where ifmask <= 0.5.
    """
    if level > 0:
        size = x.shape[2:]
        motion = F.interpolate(motion.permute(0, 3, 1, 2), size=size,
                               mode="bilinear", align_corners=True
                               ).permute(0, 2, 3, 1)
        flow = F.interpolate(flow / 2 ** level, size=size, mode="bilinear",
                             align_corners=True)
        ifmask = F.interpolate(ifmask, size=size, mode="bilinear",
                               align_corners=True)
    x1 = F.grid_sample(x, motion, align_corners=False)
    x2 = warp_acc_flow(x, flow, mask=ifmask)
    return torch.cat([x1, x2], dim=1)


class TridentGeneratorFullIFW(nn.Module):
    """resnet_9blocks_rcatland32_full_ifw (networks.py:1190-1340).

    forward(x_in, land1, land2, motion, flow, ifmask) with images NCHW,
    motion (N,H,W,2), flow (N,2,H,W), ifmask (N,1,H,W). Blocks with
    (i + disp) % div == 0 are ``ResnetBlock2`` conditioned on the source
    and target landmark encodings.
    """

    def __init__(self, input_nc: int = 3, output_nc: int = 3, ngf: int = 64,
                 n_blocks: int = 9, div: int = 3, disp: int = 1):
        super().__init__()
        self.n_blocks, self.div, self.disp = n_blocks, div, disp
        self.model_tri00 = _stem(input_nc, ngf // 2)
        self.model_tri01 = nn.Sequential(*conv_in_relu(ngf, ngf * 2, 2))
        self.model_tri02 = nn.Sequential(*conv_in_relu(ngf * 2, ngf * 4, 2))
        self.model_tri10 = _stem(input_nc, ngf)
        self.model_tri11 = nn.Sequential(*conv_in_relu(ngf, ngf, 2))
        self.model_tri12 = nn.Sequential(*conv_in_relu(ngf * 2, ngf * 4, 2))
        self.model_tri20 = _stem(input_nc, ngf)
        self.model_tri21 = nn.Sequential(*conv_in_relu(ngf, ngf * 2, 2))
        self.model_tri22 = nn.Sequential(*conv_in_relu(ngf * 2, ngf * 2, 2))
        self.model_tri_merge = nn.Conv2d(ngf * 12, ngf * 4, 3, padding=1)
        self.model_landmark_trans = nn.Sequential(
            *conv_in_relu(1, 8), *conv_in_relu(8, 16, 2),
            *conv_in_relu(16, 16, 2, relu=False)[:2])
        self.model2 = nn.Sequential(*[
            ResnetBlock2(ngf * 4 + 32, ngf * 4) if self._conditioned(i)
            else ResnetBlock(ngf * 4) for i in range(n_blocks)])
        self.model3 = nn.Sequential(*_up2x(ngf * 4, ngf * 2),
                                    *_up2x(ngf * 2, ngf),
                                    *_out_conv7(ngf, output_nc))

    def _conditioned(self, i: int) -> bool:
        return (i + self.disp) % self.div == 0

    def encode_static(self, x_in, land1) -> dict[str, torch.Tensor]:
        """The frame-invariant half: photo stems up to each branch's warp
        point and the source-landmark encoding, computed once per photo."""
        return {
            "s1": self.model_tri00(x_in),
            "s2": self.model_tri11(self.model_tri10(x_in)),
            "s3": self.model_tri22(self.model_tri21(self.model_tri20(x_in))),
            "l1": self.model_landmark_trans(land1),
        }

    def decode(self, cache, land2, motion, flow, ifmask):
        """The per-frame half; batch-1 ``cache`` entries broadcast over
        the frame batch."""
        B = motion.shape[0]

        def bc(t):
            return t.expand(B, *t.shape[1:])

        x1 = double_feature_warping(bc(cache["s1"]), motion, flow, ifmask, 0)
        x1 = self.model_tri02(self.model_tri01(x1))
        x2 = double_feature_warping(bc(cache["s2"]), motion, flow, ifmask, 1)
        x2 = self.model_tri12(x2)
        x3 = double_feature_warping(bc(cache["s3"]), motion, flow, ifmask, 2)
        x = self.model_tri_merge(torch.cat([x1, x2, x3], dim=1))
        l1 = bc(cache["l1"])
        l2 = self.model_landmark_trans(land2)
        for i, block in enumerate(self.model2):
            if self._conditioned(i):
                x = block(torch.cat([x, l1, l2], dim=1))
            else:
                x = block(x)
        return self.model3(x)

    def forward(self, x_in, land1, land2, motion, flow, ifmask):
        return self.decode(self.encode_static(x_in, land1), land2, motion,
                           flow, ifmask)
