"""Module2 generators and discriminator, NCHW. Port of
``animateportrait_tpu/models/gan.py``: ``TridentGeneratorFullIFW`` (with
its ``encode_static`` / ``decode`` split), ``ResnetStyle2Generator``, the
plain ``ResnetGenerator`` (resnet_9blocks), the 70x70 PatchGAN
``NLayerDiscriminator``, the 1x1 ``PixelDiscriminator``, ``gan_loss`` and
the training step's from-scratch ``init_weights``, built with the reference's
``Sequential`` layout (Module2/models/networks.py) so the state-dict keys
are the reference checkpoints'.

Every InstanceNorm is ``nn.InstanceNorm2d`` of this package (kernel K2)
with the ReLU that follows it fused in; the ReLU's ``Sequential`` slot
holds an ``Identity`` so later indices keep their reference numbers. The
final ``OutConv7`` is a plain reflect-padded 7x7 conv on the same
parameters (the JAX space-to-depth packing is a TPU layout trick).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.frozen.nn import InstanceNorm2d, conv_in_relu
from portbench.reference.frozen.ops.warp import (
    grid_sample_features, warp_acc_flow)


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


def landmark_encoder(land_nc: int = 1, con_dim: int = 16) -> nn.Sequential:
    """model_landmark_trans (networks.py:1284-1286): a landmark image ->
    ``con_dim`` channels at 1/4 resolution, the last InstanceNorm without
    its ReLU."""
    return nn.Sequential(*conv_in_relu(land_nc, 8),
                         *conv_in_relu(8, con_dim, 2),
                         *conv_in_relu(con_dim, con_dim, 2, relu=False)[:2])


class ResnetGenerator(nn.Module):
    """Plain resnet_9blocks / resnet_6blocks generator (networks.py:509-571),
    the reference's ``model`` Sequential."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3, ngf: int = 64,
                 n_blocks: int = 9):
        super().__init__()
        m = list(_stem(input_nc, ngf))
        for i in range(2):
            mult = 2 ** i
            m += conv_in_relu(ngf * mult, ngf * mult * 2, stride=2)
        m += [ResnetBlock(ngf * 4) for _ in range(n_blocks)]
        for i in range(2):
            mult = 2 ** (2 - i)
            m += _up2x(ngf * mult, ngf * mult // 2)
        m += _out_conv7(ngf, output_nc)
        self.model = nn.Sequential(*m)

    def forward(self, x):
        return self.model(x)


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
    is -1 where ifmask <= 0.5. The grids and every index computation stay
    in motion's and flow's dtype (fp32) when x is bf16; only the samples
    are bf16 (``grid_sample_features``).
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
    x1 = grid_sample_features(x, motion, align_corners=False)
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
                 n_blocks: int = 9, div: int = 3, disp: int = 1,
                 land_nc: int = 1, doubling: bool = True):
        super().__init__()
        self.n_blocks, self.div, self.disp = n_blocks, div, disp
        # each warp doubles its branch's channels (TPS and flow copies);
        # a single-warp variant widens the branch before its warp instead
        d = 1 if doubling else 2
        self.model_tri00 = _stem(input_nc, ngf * d // 2)
        self.model_tri01 = nn.Sequential(*conv_in_relu(ngf, ngf * 2, 2))
        self.model_tri02 = nn.Sequential(*conv_in_relu(ngf * 2, ngf * 4, 2))
        self.model_tri10 = _stem(input_nc, ngf)
        self.model_tri11 = nn.Sequential(*conv_in_relu(ngf, ngf * d, 2))
        self.model_tri12 = nn.Sequential(*conv_in_relu(ngf * 2, ngf * 4, 2))
        self.model_tri20 = _stem(input_nc, ngf)
        self.model_tri21 = nn.Sequential(*conv_in_relu(ngf, ngf * 2, 2))
        self.model_tri22 = nn.Sequential(*conv_in_relu(ngf * 2, ngf * 2 * d,
                                                       2))
        self.model_tri_merge = nn.Conv2d(ngf * 12, ngf * 4, 3, padding=1)
        self.model_landmark_trans = landmark_encoder(land_nc)
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

    def warp(self, x, level, motion, flow, ifmask, motion2=None):
        """The features of a branch warped at ``level``: both warps,
        concatenated."""
        return double_feature_warping(x, motion, flow, ifmask, level)

    def decode(self, cache, land2, motion, flow, ifmask, motion2=None):
        """The per-frame half; batch-1 ``cache`` entries broadcast over
        the frame batch."""
        B = land2.shape[0]

        def bc(t):
            return t.expand(B, *t.shape[1:])

        def w(x, level):
            return self.warp(bc(x), level, motion, flow, ifmask, motion2)

        x1 = self.model_tri02(self.model_tri01(w(cache["s1"], 0)))
        x2 = self.model_tri12(w(cache["s2"], 1))
        x3 = w(cache["s3"], 2)
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


class NLayerDiscriminator(nn.Module):
    """70x70 PatchGAN (networks.py:2602-2647): C64 (no norm) - C128 - C256
    - C512 (stride 1) - 1 channel, 4x4 kernels, LeakyReLU 0.2, each
    InstanceNorm through K2 (and K2b in the backward pass)."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3):
        super().__init__()
        seq = [nn.Conv2d(input_nc, ndf, 4, 2, 1), nn.LeakyReLU(0.2)]
        mult = 1
        for n in range(1, n_layers + 1):
            prev, mult = mult, min(2 ** n, 8)
            seq += [nn.Conv2d(ndf * prev, ndf * mult, 4,
                              2 if n < n_layers else 1, 1),
                    InstanceNorm2d(), nn.LeakyReLU(0.2)]
        seq.append(nn.Conv2d(ndf * mult, 1, 4, 1, 1))
        self.model = nn.Sequential(*seq)

    def forward(self, x):
        return self.model(x)


class PixelDiscriminator(nn.Module):
    """1x1 PatchGAN (networks.py:2720-2749), the reference's ``net``
    Sequential; its InstanceNorm through K2 (and K2b in the backward)."""

    def __init__(self, input_nc: int, ndf: int = 64):
        super().__init__()
        self.net = nn.Sequential(
            nn.Conv2d(input_nc, ndf, 1), nn.LeakyReLU(0.2),
            nn.Conv2d(ndf, ndf * 2, 1), InstanceNorm2d(), nn.LeakyReLU(0.2),
            nn.Conv2d(ndf * 2, 1, 1))

    def forward(self, x):
        return self.net(x)


def gan_loss(prediction: torch.Tensor, target_is_real: bool,
             mode: str = "lsgan") -> torch.Tensor:
    """GANLoss (networks.py:407-473): lsgan = MSE against 1/0, vanilla =
    BCE with logits, wgangp = signed mean."""
    if mode == "lsgan":
        return torch.mean(torch.square(prediction - float(target_is_real)))
    if mode == "vanilla":
        t = float(target_is_real)
        return torch.mean(torch.clamp(prediction, min=0) - prediction * t
                          + torch.log1p(torch.exp(-torch.abs(prediction))))
    if mode == "wgangp":
        return -prediction.mean() if target_is_real else prediction.mean()
    raise ValueError(mode)


_WEIGHTED = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)
_NORMS = (nn.BatchNorm1d, nn.BatchNorm2d)


def _randn(t: torch.Tensor, generator: torch.Generator | None
           ) -> torch.Tensor:
    """N(0, 1) of ``t``'s shape, drawn on the generator's device."""
    dev = t.device if generator is None else generator.device
    return torch.randn(t.shape, generator=generator, device=dev)


@torch.no_grad()
def init_weights(module: nn.Module, init_type: str = "normal",
                 gain: float = 0.02,
                 generator: torch.Generator | None = None) -> nn.Module:
    """From-scratch init of the reference's ``init_weights``
    (networks.py:71-102), in place: conv and linear weights by
    ``init_type`` (normal N(0, gain), xavier_normal with ``gain``,
    kaiming_normal fan_in, orthogonal with ``gain``), their biases 0, and
    BatchNorm weights N(1, gain) with biases 0 (the generator and the
    discriminators hold affine-free InstanceNorms, so no norm weights)."""
    for m in module.modules():
        if isinstance(m, _WEIGHTED):
            w = m.weight
            fan_in, fan_out = nn.init._calculate_fan_in_and_fan_out(w)
            if init_type == "orthogonal":
                nn.init.orthogonal_(w, gain=gain, generator=generator)
            elif init_type in ("normal", "xavier", "kaiming"):
                std = {"normal": gain,
                       "xavier": gain * math.sqrt(2.0 / (fan_in + fan_out)),
                       "kaiming": math.sqrt(2.0 / fan_in)}[init_type]
                w.copy_(_randn(w, generator) * std)
            else:
                raise ValueError(f"unknown init_type {init_type!r}")
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, _NORMS) and m.affine:
            m.weight.copy_(1.0 + gain * _randn(m.weight, generator))
            m.bias.zero_()
    return module
