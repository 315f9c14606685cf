"""The intrinsic-flow pose-transfer nets and losses in plain ``torch``, as
the ``pose_transfer_train`` configuration runs them (Li, Huang and Loy,
"Dense Intrinsic Appearance Flow for Human Pose Transfer", CVPR 2019;
https://github.com/ly015/intrinsic_flow, vendored in AnimatePortrait as
Module2/intrinsic_flow_models/): the DualUnet generator with flow-warped
appearance skips and the residual visibility blocks, the BatchNorm
PatchGAN, VGG19's loss slices, and the L1, VGG content and LSGAN losses.
Only the configuration's branches are here (dual_unet, ``G_vis_mode``
residual, ReLU, lsgan); the module layout gives the reference
checkpoints' state-dict keys.

BatchNorm is written out (no ``F.batch_norm``). One departure from the
published model is kept on purpose, because the port makes it and the
step reads D's running statistics: in training mode the batch variance is
flax's biased E[x^2] - E[x]^2 (clipped at 0), and the running variance
takes that biased value (torch's BatchNorm2d takes the unbiased one).

The DualUnet's appearance encoder shares its downsample modules with the
pose encoder, as networks.py:327 registers ``p_downsample`` under both
names: one set of weights, and its BatchNorm statistics updated by both
encoders' passes. NCHW; flows (N, 2, H, W) in pixels, (dx, dy);
visibility (N, 1, H, W): 0 visible, 1 invisible, 2 background."""
from __future__ import annotations

import torch
import torch.nn as nn

from portbench.reference.frozen.ops.warp import warp_acc_flow


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d with its arithmetic written out: in training mode the
    batch mean and flax's biased variance, both folded into the running
    statistics by ``momentum``; in eval mode the running statistics."""

    def forward(self, x):
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            mean = x.mean((0, 2, 3))
            var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean,
                              min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean = (1.0 - m) * self.running_mean \
                    + m * mean
                self.running_var = (1.0 - m) * self.running_var + m * var
                self.num_batches_tracked = self.num_batches_tracked + 1
        scale = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[None, :, None, None]) * scale[None, :, None, None] \
            + self.bias[None, :, None, None]


def conv_norm(cin: int, cout: int, kernel: int = 1, padding: int = 0):
    """networks.py conv(): Conv2d (no bias) + BatchNorm2d."""
    return nn.Sequential(nn.Conv2d(cin, cout, kernel, 1, padding,
                                   bias=False), BatchNorm2d(cout))


class ResidualBlock(nn.Module):
    """networks.py:26-60: x + norm(conv3x3(relu(x))), or, with a side
    input a, x + norm(conv3x3(relu([x, norm(conv1x1(relu(a)))])))."""

    def __init__(self, dim: int, dim_a: int = 0):
        super().__init__()
        if dim_a > 0:
            self.conv_a = conv_norm(dim_a, dim)
        self.conv = conv_norm(dim * 2 if dim_a > 0 else dim, dim, 3, 1)

    def forward(self, x, a=None):
        r = x if a is None else torch.cat([x, self.conv_a(torch.relu(a))],
                                          1)
        return x + self.conv(torch.relu(r))


def downsample(cin: int, cout: int):
    """[ReLU, Conv2d k3 s2 p1, BatchNorm2d] (networks.py:297-302)."""
    return nn.Sequential(nn.ReLU(), nn.Conv2d(cin, cout, 3, 2, 1,
                                              bias=False), BatchNorm2d(cout))


def upsample(cin: int, cout: int):
    """[ReLU, Conv2d to 4 cout k3 p1, PixelShuffle(2), BatchNorm2d]
    (networks.py:337-343)."""
    return nn.Sequential(nn.ReLU(), nn.Conv2d(cin, cout * 4, 3, 1, 1,
                                              bias=False),
                         nn.PixelShuffle(2), BatchNorm2d(cout))


class DualUnetGenerator(nn.Module):
    """networks.py:233-431 with ``vis_mode`` residual: forward(x_p (N,
    pose_nc, H, W), x_a (N, 3, H, W), flow, vis) -> the output image
    before its tanh. At each of the first ``num_warp_scales`` scales every
    appearance skip is warped by the flow, average-pooled to the scale
    and divided by its factor, and passed through a residual block fed
    with the skip split by the visibility (min-pooled to the scale) into
    its visible and invisible parts."""

    def __init__(self, pose_nc: int, appearance_nc: int = 3,
                 output_nc: int = 3, nf: int = 32, max_nf: int = 128,
                 num_scales: int = 7, num_warp_scales: int = 5,
                 n_residual_blocks: int = 2):
        super().__init__()
        self.num_scales, self.n_res = num_scales, n_residual_blocks
        self.num_warp_scales = num_warp_scales
        chans = [min(nf * (l + 1), max_nf) for l in range(num_scales + 1)]
        self.encp_pre_conv = conv_norm(pose_nc, nf)
        self.enca_pre_conv = conv_norm(appearance_nc, nf)
        for l in range(num_scales):
            down = downsample(chans[l], chans[l + 1])
            self.add_module(f"encp_{l}_downsample", down)
            self.add_module(f"enca_{l}_downsample", down)
            self.add_module(f"dec_{l}_upsample",
                            upsample(chans[l + 1], chans[l]))
            for i in range(n_residual_blocks):
                self.add_module(f"encp_{l}_res_{i}", ResidualBlock(chans[l]))
                self.add_module(f"enca_{l}_res_{i}", ResidualBlock(chans[l]))
                self.add_module(f"dec_{l}_res_{i}",
                                ResidualBlock(chans[l], chans[l] * 2))
                if l < num_warp_scales:
                    self.add_module(f"enca_{l}_vis_{i}",
                                    ResidualBlock(chans[l], chans[l] * 2))
        self.dec_fuse = conv_norm(chans[-1] * 2, chans[-1])
        self.dec_output = nn.Sequential(nn.ReflectionPad2d(3),
                                        nn.Conv2d(nf, output_nc, 7))

    def forward(self, x_p, x_a, flow, vis):
        vis = torch.round(vis)
        x_p = self.encp_pre_conv(x_p)
        x_a = self.enca_pre_conv(x_a)
        hidden_p, hidden_a = [], []
        for l in range(self.num_scales):
            down = getattr(self, f"encp_{l}_downsample")
            for i in range(self.n_res):
                x_p = getattr(self, f"encp_{l}_res_{i}")(x_p)
                hidden_p.append(x_p)
            x_p = down(x_p)
            k = 2 ** l
            warp = l < self.num_warp_scales
            if warp:
                flow_l = flow if l == 0 else \
                    nn.functional.avg_pool2d(flow, k, k) / k
                # visible < invisible < background: the scale keeps the
                # most visible label of its cell
                vis_l = vis if l == 0 else \
                    -nn.functional.max_pool2d(-vis, k, k)
            for i in range(self.n_res):
                x_a = getattr(self, f"enca_{l}_res_{i}")(x_a)
                if warp:
                    x_w = warp_acc_flow(x_a, flow_l)
                    parts = torch.cat([x_w * (vis_l == 0).to(x_w.dtype),
                                       x_w * (vis_l == 1).to(x_w.dtype)], 1)
                    hidden_a.append(
                        getattr(self, f"enca_{l}_vis_{i}")(x_w, parts))
                else:
                    hidden_a.append(x_a)
            x_a = down(x_a)
        x = self.dec_fuse(torch.cat([x_p, x_a], 1))
        for l in range(self.num_scales - 1, -1, -1):
            x = getattr(self, f"dec_{l}_upsample")(x)
            for i in range(self.n_res - 1, -1, -1):
                x = getattr(self, f"dec_{l}_res_{i}")(
                    x, torch.cat([hidden_p.pop(), hidden_a.pop()], 1))
        return self.dec_output(x)


class BNPatchDiscriminator(nn.Module):
    """networks.py:750-798 NLayerDiscriminator with BatchNorm2d and an
    output bias, no sigmoid (lsgan); keys ``model.{i}``."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3):
        super().__init__()
        layers = [nn.Conv2d(input_nc, ndf, 4, 2, 1), nn.LeakyReLU(0.2)]
        mult = 1
        for n in range(1, n_layers + 1):
            prev, mult = mult, min(2 ** n, 8)
            layers += [nn.Conv2d(ndf * prev, ndf * mult, 4,
                                 2 if n < n_layers else 1, 1, bias=False),
                       BatchNorm2d(ndf * mult), nn.LeakyReLU(0.2)]
        layers.append(nn.Conv2d(ndf * mult, 1, 4, 1, 1))
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        return self.model(x)


# torchvision's vgg19 ``features`` and the ends of the loss's five slices
# (relu1_1, relu2_1, relu3_1, relu4_1, relu5_1)
VGG19 = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M")
SLICE_ENDS = (2, 7, 12, 21, 30)
# modules.VGGLoss's content weights, one a slice
CONTENT_W = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)


class Vgg19Features(nn.Module):
    """vgg19.features (keys ``features.{i}``); forward -> the five slice
    outputs (the layers past relu5_1 are held for the keys, not run)."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for v in VGG19:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, v, 3, 1, 1), nn.ReLU()]
                cin = v
        self.features = nn.Sequential(*layers)

    def forward(self, x):
        outs = []
        for i in range(SLICE_ENDS[-1]):
            x = self.features[i](x)
            if i + 1 in SLICE_ENDS:
                outs.append(x)
        return outs


def vgg_normalize(x):
    """modules.VGGLoss.normalize: [-1, 1] -> ImageNet's statistics."""
    mean = torch.tensor([0.485, 0.456, 0.406], dtype=x.dtype,
                        device=x.device)[None, :, None, None]
    std = torch.tensor([0.229, 0.224, 0.225], dtype=x.dtype,
                       device=x.device)[None, :, None, None]
    return (x * 0.5 + 0.5 - mean) / std


def content_loss(vgg: Vgg19Features, x, y):
    """modules.VGGLoss, content: the weighted per-slice mean |difference|
    of the features; y carries no gradient."""
    fx = vgg(vgg_normalize(x))
    with torch.no_grad():
        fy = vgg(vgg_normalize(y))
    loss = 0.0
    for w, a, b in zip(CONTENT_W, fx, fy):
        loss = loss + w * torch.mean(torch.abs(a - b))
    return loss


def lsgan_loss(pred, target: float):
    """modules.GANLoss, lsgan: the mean squared gap to the target label."""
    return torch.mean((pred - target) ** 2)
