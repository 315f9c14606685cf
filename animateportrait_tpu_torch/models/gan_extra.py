"""The rest of the Module2 network registry, NCHW. Port of
``animateportrait_tpu/models/gan_extra.py`` (the reference's
Module2/models/networks.py:123-371 and the nets it serves):

- ``ConditionalResnetGenerator`` in its four modes (rcatland32 and its
  ``_fw``, ``_fw2`` and ``_ifw`` warps), ``ConditionalResnetDualHead``
  (rcatland4), ``ConditionalResnetWarped`` (rcatland2) and
  ``TridentGeneratorVariant`` (the other trident warps);
- ``UnetGenerator`` (unet_128 / unet_256), ``Regressor`` (archs 1-5),
  ``Combiner``, ``NLayerDiscriminatorCls``, ``HED``, ``ULP`` and
  ``UnetParseGenerator`` (``define_p``, BatchNorm);
- ``define_g``, ``define_d`` and ``define_p``, which serve the same names
  as the JAX package's and refuse the others with the same error.

The blocks are ``models/gan.py``'s (``_stem``, ``_up2x``,
``_out_conv7``, ``ResnetBlock``, ``ResnetBlock2``, ``landmark_encoder``,
``double_feature_warping``) and ``nn.py:conv_in_relu``: every
InstanceNorm runs through kernel K2 (and K2b in the backward), with the
ReLU that follows it fused in where one does. Module names follow the JAX
package's (``stem``, ``down0``, ``block`` stacks in ``model2``, the
decoder in ``model3``, ``c0``/``fc0``, ...); ``io/from_jax.py`` converts
its variables. Dropout, where a net has it, is active in training mode
and draws its mask from the ``generator`` passed to ``forward``.

A motion grid is (N, H, W, 2) normalized (x, y), a flow (N, 2, H, W) in
pixels (dx, dy), a mask (N, 1, H, W); at a lower level they are resized
with align_corners=True (the flow also divided by 2**level) and sampled
with align_corners=False, as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from animateportrait_tpu_torch.models.gan import (
    NLayerDiscriminator, PixelDiscriminator, ResnetBlock, ResnetBlock2,
    ResnetGenerator, ResnetStyle2Generator, TridentGeneratorFullIFW,
    _out_conv7, _stem, _up2x, double_feature_warping, landmark_encoder)
from animateportrait_tpu_torch.nn import (
    BatchNorm2d, InstanceNorm2d, conv_in_relu)
from animateportrait_tpu_torch.ops.warp import (
    grid_sample_features, warp_acc_flow)


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout(p)``: in training mode keep each element with
    probability 1 - p (drawn from ``generator``) and scale it by 1 / (1 -
    p); the identity otherwise."""
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def resize(t: torch.Tensor, size, grid: bool = False) -> torch.Tensor:
    """Bilinear, align_corners=True: an NCHW map, or with ``grid`` an (N,
    H, W, 2) sampling grid."""
    if grid:
        return F.interpolate(t.permute(0, 3, 1, 2), size=tuple(size),
                             mode="bilinear", align_corners=True
                             ).permute(0, 2, 3, 1)
    return F.interpolate(t, size=tuple(size), mode="bilinear",
                         align_corners=True)


def _grid(x: torch.Tensor, motion: torch.Tensor) -> torch.Tensor:
    return grid_sample_features(x, motion, align_corners=False)


def _blocks(ngf: int, n_blocks: int, conditioned, cond_nc: int
            ) -> nn.Sequential:
    """The bottleneck stack at ngf * 4: a ``ResnetBlock2`` that also takes
    ``cond_nc`` conditioning channels where ``conditioned(i)``."""
    return nn.Sequential(*[
        ResnetBlock2(ngf * 4 + cond_nc, ngf * 4) if conditioned(i)
        else ResnetBlock(ngf * 4) for i in range(n_blocks)])


def _run_blocks(stack: nn.Sequential, x: torch.Tensor, cond: list,
                conditioned) -> torch.Tensor:
    for i, block in enumerate(stack):
        x = block(torch.cat([x, *cond], dim=1)) if conditioned(i) \
            else block(x)
    return x


def _decoder(ngf: int, output_nc: int) -> nn.Sequential:
    """Two ``Upsample2x`` and the reflect-padded 7x7 tanh head."""
    return nn.Sequential(*_up2x(ngf * 4, ngf * 2), *_up2x(ngf * 2, ngf),
                         *_out_conv7(ngf, output_nc))


class ConditionalResnetGenerator(nn.Module):
    """The single-encoder landmark-conditioned ResNet (networks.py:806-1189).
    ``mode``: 'none' (rcatland32), 'fw' (the 1/4-resolution features
    sampled by the resized motion grid), 'fw2' (the stem's output sampled
    by it) or 'ifw' (the stem's output warped by the grid and by the flow,
    concatenated). forward(x_in, land1, land2, motion=None, flow=None,
    ifmask=None)."""

    MODES = ("none", "fw", "fw2", "ifw")

    def __init__(self, input_nc: int = 3, output_nc: int = 3, ngf: int = 64,
                 n_blocks: int = 9, div: int = 3, disp: int = 1,
                 mode: str = "none"):
        super().__init__()
        if mode not in self.MODES:
            raise ValueError(f"mode {mode!r}: one of {self.MODES}")
        self.mode, self.div, self.disp = mode, div, disp
        self.stem = _stem(input_nc, ngf // 2 if mode == "ifw" else ngf)
        self.down0 = nn.Sequential(*conv_in_relu(ngf, ngf * 2, 2))
        self.down1 = nn.Sequential(*conv_in_relu(ngf * 2, ngf * 4, 2))
        self.model_landmark_trans = landmark_encoder()
        self.model2 = _blocks(ngf, n_blocks, self._conditioned, 32)
        self.model3 = _decoder(ngf, output_nc)

    def _conditioned(self, i: int) -> bool:
        return (i + self.disp) % self.div == 0

    def forward(self, x_in, land1, land2, motion=None, flow=None,
                ifmask=None):
        x = self.stem(x_in)
        if self.mode == "fw2":
            x = _grid(x, motion)
        elif self.mode == "ifw":
            x = torch.cat([_grid(x, motion),
                           warp_acc_flow(x, flow, mask=ifmask)], dim=1)
        x = self.down1(self.down0(x))
        if self.mode == "fw":
            x = _grid(x, resize(motion, x.shape[2:], grid=True))
        lenc = self.model_landmark_trans
        x = _run_blocks(self.model2, x, [lenc(land1), lenc(land2)],
                        self._conditioned)
        return self.model3(x)


class UnetSkipBlock(nn.Module):
    """One level of the U-Net (networks.py:2455-2521): LeakyReLU (not at
    the outermost), a 4x4 stride-2 conv, InstanceNorm (not at either end),
    the inner levels, ReLU, a 4x4 stride-2 transposed conv and InstanceNorm
    (tanh at the outermost), dropout in training mode where asked, and the
    input concatenated in front."""

    def __init__(self, outer_nc: int, inner_nc: int,
                 input_nc: int | None = None,
                 inner: "UnetSkipBlock | None" = None,
                 outermost: bool = False, innermost: bool = False,
                 use_dropout: bool = False):
        super().__init__()
        self.outermost, self.innermost = outermost, innermost
        self.use_dropout = use_dropout and not (outermost or innermost)
        self.down = nn.Conv2d(input_nc or outer_nc, inner_nc, 4, 2, 1)
        self.down_norm = None if (outermost or innermost) \
            else InstanceNorm2d()
        self.inner = inner
        self.up = nn.ConvTranspose2d(inner_nc if innermost else inner_nc * 2,
                                     outer_nc, 4, 2, 1)
        self.up_norm = None if outermost else InstanceNorm2d()

    def forward(self, x, generator=None):
        y = x if self.outermost else F.leaky_relu(x, 0.2)
        y = self.down(y)
        if self.down_norm is not None:
            y = self.down_norm(y)
        if self.inner is not None:
            y = self.inner(y, generator)
        y = self.up(F.relu(y))
        if self.outermost:
            return torch.tanh(y)
        y = self.up_norm(y)
        if self.use_dropout:
            y = dropout(y, 0.5, self.training, generator)
        return torch.cat([x, y], dim=1)


class UnetGenerator(nn.Module):
    """unet_128 / unet_256 (networks.py:2423-2452): ``num_downs`` = 7 / 8
    levels; forward(x, generator=None). ``model`` is the outermost level,
    each level's ``inner`` the next."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3,
                 num_downs: int = 8, ngf: int = 64,
                 use_dropout: bool = False):
        super().__init__()
        block = UnetSkipBlock(ngf * 8, ngf * 8, innermost=True)
        for _ in range(num_downs - 5):
            block = UnetSkipBlock(ngf * 8, ngf * 8, inner=block,
                                  use_dropout=use_dropout)
        block = UnetSkipBlock(ngf * 4, ngf * 8, inner=block)
        block = UnetSkipBlock(ngf * 2, ngf * 4, inner=block)
        block = UnetSkipBlock(ngf, ngf * 2, inner=block)
        self.model = UnetSkipBlock(output_nc, ngf, input_nc, inner=block,
                                   outermost=True)

    def forward(self, x, generator=None):
        return self.model(x, generator)


class Regressor(nn.Module):
    """An 11x11 patch -> a scalar, archs 1-5 (networks.py:2524-2600);
    forward(x, generator=None) (arch 5's dropout)."""

    def __init__(self, input_nc: int = 3, ngf: int = 64, arch: int = 1):
        super().__init__()
        if arch not in (1, 2, 3, 4, 5):
            raise ValueError(f"Regressor arch {arch}: one of 1-5")
        self.arch = arch
        c = nn.Conv2d
        if arch == 1:
            self.c0 = c(input_nc, ngf, 3, 2, 0)
            self.c1 = c(ngf, 1, 5)
        elif arch == 2:
            self.c0 = c(input_nc, ngf, 3)
            self.c1 = c(ngf, ngf * 2, 3)
            self.c2 = c(ngf * 2, ngf * 4, 3)
            self.c3 = c(ngf * 4, 1, 5)
            self.norm1, self.norm2 = InstanceNorm2d(), InstanceNorm2d()
        elif arch == 3:
            self.c0 = c(input_nc, ngf, 3, 1, 1)
            self.c1 = c(ngf, 1, 11)
        else:
            self.c0 = c(input_nc, ngf, 3, 1, 1)
            self.c1 = c(ngf, ngf * 2, 3, 1, 1)
            self.c2 = c(ngf * 2, ngf * 4, 3, 1, 1)
            if arch == 4:
                self.c3 = c(ngf * 4, 1, 11)
            else:
                self.fc0 = nn.Linear(ngf * 4 * 11 * 11, 4096)
                self.fc1 = nn.Linear(4096, 1)

    def forward(self, x, generator=None):
        def lrelu(t):
            return F.leaky_relu(t, 0.2)

        if self.arch == 1:
            return self.c1(lrelu(self.c0(x)))
        if self.arch == 2:
            x = lrelu(self.c0(x))
            x = lrelu(self.norm1(self.c1(x)))
            x = lrelu(self.norm2(self.c2(x)))
            return self.c3(x)
        if self.arch == 3:
            return self.c1(lrelu(self.c0(x)))
        for conv in (self.c0, self.c1, self.c2):
            x = lrelu(conv(x))
        if self.arch == 4:
            return self.c3(x)
        x = F.relu(self.fc0(x.reshape(x.shape[0], -1)))
        return self.fc1(dropout(x, 0.5, self.training, generator))


class Combiner(nn.Module):
    """7x7 stem, ``n_blocks`` ResNet blocks and the 7x7 tanh head
    (networks.py:2178-2206), one ``model`` Sequential."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3, ngf: int = 64,
                 n_blocks: int = 2):
        super().__init__()
        self.model = nn.Sequential(
            *_stem(input_nc, ngf), *[ResnetBlock(ngf) for _ in range(n_blocks)],
            *_out_conv7(ngf, output_nc))

    def forward(self, x):
        return self.model(x)


class NLayerDiscriminatorCls(nn.Module):
    """PatchGAN with an ``n_class`` head (networks.py:2650-2718); forward(x)
    -> (patch (N, 1, h, w), class logits (N, n_class)). The 16x16 VALID
    class conv sizes it for 512^2 inputs."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3,
                 n_class: int = 3):
        super().__init__()
        self.n_layers = n_layers
        self.conv0 = nn.Conv2d(input_nc, ndf, 4, 2, 1)
        nf = 1
        for n in range(1, n_layers):
            prev, nf = nf, min(2 ** n, 8)
            self.add_module(f"conv{n}", nn.Conv2d(ndf * prev, ndf * nf,
                                                  4, 2, 1))
            self.add_module(f"norm{n}", InstanceNorm2d())
        nf2 = min(2 ** n_layers, 8)
        self.p_conv0 = nn.Conv2d(ndf * nf, ndf * nf2, 4, 1, 1)
        self.p_norm = InstanceNorm2d()
        self.p_out = nn.Conv2d(ndf * nf2, 1, 4, 1, 1)
        self.c_conv0 = nn.Conv2d(ndf * nf, ndf * nf2, 4, 2, 1)
        self.c_norm0 = InstanceNorm2d()
        self.c_conv1 = nn.Conv2d(ndf * nf2, ndf * nf2, 4, 2, 1)
        self.c_norm1 = InstanceNorm2d()
        self.c_out = nn.Conv2d(ndf * nf2, n_class, 16)

    def forward(self, x):
        def lrelu(t):
            return F.leaky_relu(t, 0.2)

        x = lrelu(self.conv0(x))
        for n in range(1, self.n_layers):
            x = lrelu(getattr(self, f"norm{n}")(getattr(self, f"conv{n}")(x)))
        patch = self.p_out(lrelu(self.p_norm(self.p_conv0(x))))
        c = lrelu(self.c_norm0(self.c_conv0(x)))
        c = lrelu(self.c_norm1(self.c_conv1(c)))
        if c.shape[2:] == self.c_out.kernel_size:
            # the VALID conv is as large as its input (512^2 images): a
            # linear map of the flattened map, computed as one; torch
            # 2.13's oneDNN CPU convolution gives this shape a wrong weight
            # gradient at batch 1
            return patch, F.linear(c.flatten(1), self.c_out.weight.flatten(1),
                                   self.c_out.bias)
        return patch, self.c_out(c).flatten(1)


_HED_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
_HED_MEAN_BGR = (104.00698793, 116.66876762, 122.67891434)


class HED(nn.Module):
    """VGG16 edge detector with five side outputs and BGR mean subtraction
    (networks.py:2752-2837); forward(RGB in [0, 1]) -> (N, 1, H, W) edge
    probabilities."""

    def __init__(self):
        super().__init__()
        cin = 3
        for s, (ch, convs) in enumerate(_HED_STAGES, start=1):
            for i in range(convs):
                self.add_module(f"vgg{s}_c{i}", nn.Conv2d(cin, ch, 3, 1, 1))
                cin = ch
            self.add_module(f"score{s - 1}", nn.Conv2d(ch, 1, 1))
        self.combine = nn.Conv2d(5, 1, 1)

    def forward(self, x):
        h, w = x.shape[2:]
        mean = torch.tensor(_HED_MEAN_BGR, dtype=x.dtype, device=x.device)
        y = x.flip(1) * 255.0 - mean[None, :, None, None]
        scores = []
        for s, (_, convs) in enumerate(_HED_STAGES, start=1):
            if s > 1:
                y = F.max_pool2d(y, 2, 2, ceil_mode=True)
            for i in range(convs):
                y = F.relu(getattr(self, f"vgg{s}_c{i}")(y))
            sc = getattr(self, f"score{s - 1}")(y)
            scores.append(F.interpolate(sc, size=(h, w), mode="bilinear",
                                        align_corners=False))
        return torch.sigmoid(self.combine(torch.cat(scores, dim=1)))


class ULP(nn.Module):
    """68 -> ``landmark_num`` upper-landmark MLP (networks.py:2840-2859):
    (N, 68, 2) -> (N, landmark_num, 2)."""

    def __init__(self, landmark_num: int = 17):
        super().__init__()
        self.landmark_num = landmark_num
        for i in range(6):
            self.add_module(f"l{i}", nn.Linear(136 if i == 0 else 512, 512))
        self.out = nn.Linear(512, landmark_num * 2)

    def forward(self, lm68):
        x = lm68.reshape(-1, 136)
        for i in range(6):
            x = F.leaky_relu(getattr(self, f"l{i}")(x), 0.2)
        return self.out(x).reshape(-1, self.landmark_num, 2)


class TridentGeneratorVariant(TridentGeneratorFullIFW):
    """The other trident generators (networks.py:1467-2153), by warp kind:
    'both' (full_ifw, and full_ifw_colorcoded with ``land_nc`` 3: grid and
    flow, concatenated), 'dual_motion' (full_ifw2: two grids,
    concatenated), 'motion' (full_ifw_single / single3: the grid alone)
    or 'flow' (full_ifw_single2 / ifw_single2: the flow alone). The
    doubling kinds stem branch 1 at ngf / 2 as full_ifw does; the single
    ones widen the branches before their warps instead. forward(x_in,
    land1, land2, motion=None, flow=None, ifmask=None, motion2=None)."""

    WARPS = ("both", "dual_motion", "motion", "flow")

    def __init__(self, input_nc: int = 3, output_nc: int = 3, ngf: int = 64,
                 n_blocks: int = 9, div: int = 3, disp: int = 1,
                 warp: str = "both", land_nc: int = 1):
        if warp not in self.WARPS:
            raise ValueError(f"warp {warp!r}: one of {self.WARPS}")
        super().__init__(input_nc, output_nc, ngf, n_blocks, div, disp,
                         land_nc=land_nc,
                         doubling=warp in ("both", "dual_motion"))
        self.warp_kind = warp

    def warp(self, x, level, motion, flow, ifmask, motion2=None):
        kind = self.warp_kind
        if kind == "both":
            return double_feature_warping(x, motion, flow, ifmask, level)
        if level > 0:
            size = x.shape[2:]
            if kind == "flow":
                flow = resize(flow / 2 ** level, size)
                ifmask = resize(ifmask, size)
            else:
                motion = resize(motion, size, grid=True)
            if kind == "dual_motion":
                motion2 = resize(motion2, size, grid=True)
        if kind == "dual_motion":
            return torch.cat([_grid(x, motion), _grid(x, motion2)], dim=1)
        if kind == "motion":
            return _grid(x, motion)
        return warp_acc_flow(x, flow, mask=ifmask)

    def forward(self, x_in, land1, land2, motion=None, flow=None,
                ifmask=None, motion2=None):
        return self.decode(self.encode_static(x_in, land1), land2, motion,
                           flow, ifmask, motion2)


class ConditionalResnetDualHead(nn.Module):
    """resnet_9blocks_rcatland4 (networks.py:2060-2176): a shared encoder,
    two landmark-conditioned block stacks (``n_blocks`` and ``n_blocks2``)
    and two decoders; forward(x_in, land1, land2) -> (out1, out2)."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3, ngf: int = 64,
                 n_blocks: int = 9, n_blocks2: int = 9, div: int = 3):
        super().__init__()
        self.div = div
        self.stem = _stem(input_nc, ngf)
        self.down0 = nn.Sequential(*conv_in_relu(ngf, ngf * 2, 2))
        self.down1 = nn.Sequential(*conv_in_relu(ngf * 2, ngf * 4, 2))
        self.model_landmark_trans = landmark_encoder()
        self.a_model2 = _blocks(ngf, n_blocks, self._conditioned, 32)
        self.a_model3 = _decoder(ngf, output_nc)
        self.b_model2 = _blocks(ngf, n_blocks2, self._conditioned, 32)
        self.b_model3 = _decoder(ngf, output_nc)

    def _conditioned(self, i: int) -> bool:
        return (i + 1) % self.div == 0

    def forward(self, x_in, land1, land2):
        x = self.down1(self.down0(self.stem(x_in)))
        cond = [self.model_landmark_trans(land1),
                self.model_landmark_trans(land2)]
        return tuple(head(_run_blocks(stack, x, cond, self._conditioned))
                     for stack, head in ((self.a_model2, self.a_model3),
                                         (self.b_model2, self.b_model3)))


class ConditionalResnetWarped(nn.Module):
    """resnet_9blocks_rcatland2 (networks.py:2208-2300): one encoder for the
    photo and for a pre-warped photo, whose encoding conditions the
    ``ResnetBlock2``s; forward(x_in, warped)."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3, ngf: int = 64,
                 n_blocks: int = 9, div: int = 3):
        super().__init__()
        self.div = div
        self.stem = _stem(input_nc, ngf)
        self.down0 = nn.Sequential(*conv_in_relu(ngf, ngf * 2, 2))
        self.down1 = nn.Sequential(*conv_in_relu(ngf * 2, ngf * 4, 2))
        self.model2 = _blocks(ngf, n_blocks, self._conditioned, ngf * 4)
        self.model3 = _decoder(ngf, output_nc)

    def _conditioned(self, i: int) -> bool:
        return (i + 1) % self.div == 0

    def _encode(self, y):
        return self.down1(self.down0(self.stem(y)))

    def forward(self, x_in, warped):
        x = _run_blocks(self.model2, self._encode(x_in),
                        [self._encode(warped)], self._conditioned)
        return self.model3(x)


class UnetParseSkipBlock(nn.Module):
    """UnetParseSkipConnectionBlock (networks.py:334-405): the U-Net level
    with BatchNorm, a transposed conv with output_padding 1 cropped back to
    the input's size about its centre, and tanh inside the outermost
    level."""

    def __init__(self, outer_nc: int, inner_nc: int,
                 input_nc: int | None = None,
                 inner: "UnetParseSkipBlock | None" = None,
                 outermost: bool = False, innermost: bool = False,
                 use_dropout: bool = False):
        super().__init__()
        self.outermost = outermost
        self.use_dropout = use_dropout and not (outermost or innermost)
        self.down = nn.Conv2d(input_nc or outer_nc, inner_nc, 4, 2, 1,
                              bias=False)
        self.down_bn = None if (outermost or innermost) \
            else BatchNorm2d(inner_nc, momentum=0.1)
        self.inner = inner
        self.up = nn.ConvTranspose2d(inner_nc if innermost else inner_nc * 2,
                                     outer_nc, 4, 2, 1, output_padding=1,
                                     bias=outermost)
        self.up_bn = None if outermost else BatchNorm2d(outer_nc,
                                                         momentum=0.1)

    def forward(self, x, generator=None):
        y = x if self.outermost else F.leaky_relu(x, 0.2)
        y = self.down(y)
        if self.down_bn is not None:
            y = self.down_bn(y)
        if self.inner is not None:
            y = self.inner(y, generator)
        y = self.up(F.relu(y))
        ha, wa = x.shape[2:]
        t, le = (y.shape[2] - ha) // 2, (y.shape[3] - wa) // 2
        y = y[:, :, t:t + ha, le:le + wa]
        if self.outermost:
            return torch.tanh(y)
        y = self.up_bn(y)
        if self.use_dropout:
            y = dropout(y, 0.5, self.training, generator)
        return torch.cat([x, y], dim=1)


class UnetParseGenerator(nn.Module):
    """The segmentation U-Net (networks.py:311-331): a softmax over
    ``segment_classes`` channels; forward(x, generator=None)."""

    def __init__(self, input_nc: int = 3, segment_classes: int = 3,
                 num_downs: int = 7, ngf: int = 64,
                 use_dropout: bool = False):
        super().__init__()
        block = UnetParseSkipBlock(ngf * 8, ngf * 8, innermost=True)
        for _ in range(num_downs - 5):
            block = UnetParseSkipBlock(ngf * 8, ngf * 8, inner=block,
                                       use_dropout=use_dropout)
        block = UnetParseSkipBlock(ngf * 4, ngf * 8, inner=block)
        block = UnetParseSkipBlock(ngf * 2, ngf * 4, inner=block)
        block = UnetParseSkipBlock(ngf, ngf * 2, inner=block)
        self.model = UnetParseSkipBlock(segment_classes, ngf, input_nc,
                                        inner=block, outermost=True)

    def forward(self, x, generator=None):
        return torch.softmax(self.model(x, generator), dim=1)


# netG names of the trident family that differ from full_ifw by their warp
# or landmark channels (the JAX package's table)
TRIDENT_VARIANTS = {
    "resnet_9blocks_rcatland32_full_ifw_colorcoded": dict(warp="both",
                                                          land_nc=3),
    "resnet_9blocks_rcatland32_full_ifw2": dict(warp="dual_motion"),
    "resnet_9blocks_rcatland32_full_ifw_single": dict(warp="motion"),
    "resnet_9blocks_rcatland32_full_ifw_single3": dict(warp="motion"),
    "resnet_9blocks_rcatland32_full_ifw_single2": dict(warp="flow"),
    "resnet_9blocks_rcatland32_ifw_single2": dict(warp="flow"),
}
CONDITIONAL = {"resnet_9blocks_rcatland32": (9, "none"),
               "resnet_10blocks_rcatland32": (10, "none"),
               "resnet_9blocks_rcatland32_fw": (9, "fw"),
               "resnet_9blocks_rcatland32_fw2": (9, "fw2"),
               "resnet_9blocks_rcatland32_ifw": (9, "ifw"),
               # pre-32 revisions, served by the 32 variant
               "resnet_9blocks_rcatland": (9, "none"),
               "resnet_9blocks_rcatland3": (9, "none")}
NETG = (("resnet_9blocks", "resnet_6blocks", "resnet_style2_9blocks",
         "resnet_9blocks_rcatland32_full_ifw", "resnet_9blocks_rcatland4",
         "resnet_9blocks_rcatland2", "unet_128", "unet_256", "regressor",
         "combiner") + tuple(CONDITIONAL) + tuple(TRIDENT_VARIANTS))
NETD = ("basic", "n_layers", "pixel", "cls")


def define_g(netg: str, input_nc: int = 3, output_nc: int = 3,
             ngf: int = 64, n_blocks: int | None = None, div: int = 3,
             disp: int = 1, **kw) -> nn.Module:
    """The reference's define_G registry (networks.py:123-201): every name
    in ``NETG``; any other raises ``ValueError("unknown netG ...")``."""
    nb = n_blocks
    common = dict(input_nc=input_nc, output_nc=output_nc, ngf=ngf)
    if netg in TRIDENT_VARIANTS:
        return TridentGeneratorVariant(n_blocks=nb or 9, div=div, disp=disp,
                                       **common, **TRIDENT_VARIANTS[netg])
    if netg in CONDITIONAL:
        default, mode = CONDITIONAL[netg]
        return ConditionalResnetGenerator(n_blocks=nb or default, div=div,
                                          disp=disp, mode=mode, **common)
    if netg == "resnet_9blocks_rcatland4":
        return ConditionalResnetDualHead(n_blocks=nb or 9, div=div, **common)
    if netg == "resnet_9blocks_rcatland2":
        return ConditionalResnetWarped(n_blocks=nb or 9, div=div, **common)
    if netg == "resnet_9blocks_rcatland32_full_ifw":
        return TridentGeneratorFullIFW(n_blocks=nb or 9, div=div, disp=disp,
                                       **common)
    if netg in ("resnet_9blocks", "resnet_6blocks"):
        return ResnetGenerator(n_blocks=nb or int(netg[7]), **common)
    if netg == "resnet_style2_9blocks":
        return ResnetStyle2Generator(n_blocks=nb or 9, **common, **kw)
    if netg in ("unet_128", "unet_256"):
        return UnetGenerator(num_downs=7 if netg == "unet_128" else 8,
                             **common)
    if netg == "regressor":
        return Regressor(input_nc=input_nc, ngf=ngf, **kw)
    if netg == "combiner":
        return Combiner(**common, **kw)
    raise ValueError(f"unknown netG {netg}")


def define_d(netd: str, input_nc: int = 3, ndf: int = 64,
             n_layers: int = 3, **kw) -> nn.Module:
    """The reference's define_D registry (networks.py:204-247)."""
    if netd == "basic":
        return NLayerDiscriminator(input_nc, ndf=ndf, n_layers=3)
    if netd == "n_layers":
        return NLayerDiscriminator(input_nc, ndf=ndf, n_layers=n_layers)
    if netd == "pixel":
        return PixelDiscriminator(input_nc, ndf=ndf)
    if netd == "cls":
        return NLayerDiscriminatorCls(input_nc, ndf=ndf, n_layers=n_layers,
                                      **kw)
    raise ValueError(f"unknown netD {netd}")


def define_p(segment_classes: int, which_model_netg: str = "unet_128",
             ngf: int = 64, use_dropout: bool = False,
             input_nc: int = 3) -> UnetParseGenerator:
    """The reference's define_P (networks.py:294-309)."""
    downs = {"unet_128": 6, "unet_256": 7}
    if which_model_netg not in downs:
        raise ValueError(f"unknown parse netG {which_model_netg}")
    return UnetParseGenerator(input_nc, segment_classes,
                              downs[which_model_netg], ngf, use_dropout)
