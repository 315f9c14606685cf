"""The residual intrinsic-flow nets: FlowUnet_v2, DualUnetGenerator and the
intrinsic-flow UnetGenerator (plain and multi-output). Port of
``animateportrait_tpu/models/flowunet_extra.py`` with the reference's
module layout (Module2/intrinsic_flow_models/networks.py), so the
state-dict keys are the reference checkpoints':

- ``conv()`` (:16-24) is ``Sequential(Conv2d, BatchNorm2d)`` (bias only
  without the norm);
- ``ResidualBlock`` (:26-60) holds ``conv`` and, with a side input,
  ``conv_a``; ``GateBlock`` (:62-75) holds ``conv``;
- downsamples are ``Sequential(act, Conv2d s2, norm)``, upsamples
  ``Sequential(act, Conv2d, PixelShuffle(2), norm)``, the flow and
  visibility heads ``Sequential(act, Conv2d)``, the image heads
  ``Sequential(ReflectionPad2d(3), Conv2d 7x7)``.

Reference quirk kept: DualUnetGenerator's appearance encoder shares its
downsample modules with the pose encoder (networks.py:327 registers
``p_downsample`` as ``enca_%d_downsample`` too), so both names are in the
state dict and hold one tensor. BatchNorms are the port's
(``nn.BatchNorm2d``: flax's statistics in training mode); dropout is off,
as in the JAX package. NCHW; flows (N, 2, H, W) in pixels, (dx, dy).
DualUnetGenerator adds each skip warp to the counter ``pt.feature_warps``
(``utils/observe.py``) while a profiler records.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from animateportrait_tpu_torch.nn import BatchNorm2d
from animateportrait_tpu_torch.ops.warp import warp_acc_flow
from animateportrait_tpu_torch.utils import observe


def _act(slope: float = 0.0) -> nn.Module:
    """The nets' G_activation: ReLU, or LeakyReLU(slope) when slope > 0."""
    return nn.LeakyReLU(slope) if slope else nn.ReLU()


def conv_norm(cin: int, cout: int, kernel: int = 1, stride: int = 1,
              padding: int = 0, end_norm: bool = True) -> nn.Sequential:
    """conv() (networks.py:16-22): Conv2d + BatchNorm2d, or a biased
    Conv2d alone."""
    layers = [nn.Conv2d(cin, cout, kernel, stride, padding,
                        bias=not end_norm)]
    if end_norm:
        layers.append(BatchNorm2d(cout))
    return nn.Sequential(*layers)


class ResidualBlock(nn.Module):
    """networks.py:26-60. ``dim_a`` > 0 maps a side input through a 1x1
    conv and concatenates it before the 3x3 residual conv."""

    def __init__(self, dim: int, dim_a: int = 0, no_end_norm: bool = False,
                 slope: float = 0.0):
        super().__init__()
        self.act = _act(slope)
        if dim_a > 0:
            self.conv_a = conv_norm(dim_a, dim)
        self.conv = conv_norm(dim * 2 if dim_a > 0 else dim, dim, 3, 1, 1,
                              end_norm=not no_end_norm)

    def forward(self, x, a=None):
        r = x if a is None else torch.cat([x, self.conv_a(self.act(a))], 1)
        return x + self.conv(self.act(r))


class GateBlock(nn.Module):
    """networks.py:62-75: a sigmoid gate over a side input."""

    def __init__(self, dim: int, dim_a: int):
        super().__init__()
        self.conv = nn.Conv2d(dim_a, dim, 1)

    def forward(self, x, a):
        return x * torch.sigmoid(self.conv(F.relu(a)))


def downsample(cin: int, cout: int, slope: float = 0.0) -> nn.Sequential:
    """[act, Conv2d k3 s2 p1, norm] (networks.py:297-302)."""
    return nn.Sequential(_act(slope), nn.Conv2d(cin, cout, 3, 2, 1,
                                                bias=False),
                         BatchNorm2d(cout))


def upsample(cin: int, cout: int, slope: float = 0.0) -> nn.Sequential:
    """[act, Conv2d c -> 4 cout k3 p1, PixelShuffle(2), norm]
    (networks.py:337-343)."""
    return nn.Sequential(_act(slope), nn.Conv2d(cin, cout * 4, 3, 1, 1,
                                                bias=False),
                         nn.PixelShuffle(2), BatchNorm2d(cout))


def pred_head(cin: int, cout: int) -> nn.Sequential:
    """[ReLU, Conv2d k3 p1] flow / visibility head (networks.py:710-720)."""
    return nn.Sequential(nn.ReLU(), nn.Conv2d(cin, cout, 3, 1, 1))


def out_head(cin: int, cout: int) -> nn.Sequential:
    """[ReflectionPad2d(3), Conv2d k7] image head."""
    return nn.Sequential(nn.ReflectionPad2d(3), nn.Conv2d(cin, cout, 7))


class FlowUnetV2(nn.Module):
    """FlowUnet_v2 (networks.py:647-744): forward(x (N,input_nc,H,W)) ->
    (flow, vis, flow_pyramid, feat), flow and vis bilinearly upsampled by
    ``start_scale`` (half-pixel centres)."""

    def __init__(self, input_nc: int, nf: int = 64, max_nf: int = 256,
                 start_scale: int = 2, num_scales: int = 7,
                 n_residual_blocks: int = 2):
        super().__init__()
        self.num_scales, self.n_res = num_scales, n_residual_blocks
        self.start_scale = start_scale
        start_level = start_scale.bit_length() - 1
        pre = [conv_norm(input_nc, nf)]
        for i in range(start_level):
            c_in, c_out = min(nf * (i + 1), max_nf), min(nf * (i + 2), max_nf)
            pre += [ResidualBlock(c_in), nn.ReLU(),
                    nn.Conv2d(c_in, c_out, 3, 2, 1, bias=False),
                    BatchNorm2d(c_out)]
        self.pre_conv = nn.Sequential(*pre)
        chans = [min(nf * (start_level + l + 1), max_nf)
                 for l in range(num_scales + 1)]
        for l in range(num_scales):
            for i in range(n_residual_blocks):
                self.add_module(f"enc_{l}_res_{i}", ResidualBlock(chans[l]))
                self.add_module(f"dec_{l}_res_{i}",
                                ResidualBlock(chans[l], dim_a=chans[l]))
            self.add_module(f"enc_{l}_downsample",
                            downsample(chans[l], chans[l + 1]))
            self.add_module(f"dec_{l}_upsample",
                            upsample(chans[l + 1], chans[l]))
            self.add_module(f"pred_flow_{l}", pred_head(chans[l], 2))
        self.pred_vis = pred_head(chans[0], 3)

    def forward(self, x):
        x = self.pre_conv(x)
        hiddens = []
        for l in range(self.num_scales):
            for i in range(self.n_res):
                x = getattr(self, f"enc_{l}_res_{i}")(x)
                hiddens.append(x)
            x = getattr(self, f"enc_{l}_downsample")(x)
        flow_pyr = []
        for l in range(self.num_scales - 1, -1, -1):
            x = getattr(self, f"dec_{l}_upsample")(x)
            for i in range(self.n_res - 1, -1, -1):
                x = getattr(self, f"dec_{l}_res_{i}")(x, hiddens.pop())
            flow_pyr.insert(0, getattr(self, f"pred_flow_{l}")(x))
        vis = self.pred_vis(x)
        size = (x.shape[2] * self.start_scale, x.shape[3] * self.start_scale)
        flow = F.interpolate(flow_pyr[0], size=size, mode="bilinear",
                             align_corners=False)
        vis = F.interpolate(vis, size=size, mode="bilinear",
                            align_corners=False)
        return flow, vis, flow_pyr, x


class DualUnetGenerator(nn.Module):
    """DualUnetGenerator (networks.py:233-431): forward(x_p, x_a, flow=None,
    vis=None) -> out, or (out, aux_outs) with ``aux_output_nc``. The
    appearance encoder's skip features are warped to the target pose by
    ``flow`` (N,2,H,W) with visibility ``vis`` (N,1,H,W: 0 visible, 1
    invisible, 2 background) gating them at the first
    ``num_warp_scales`` scales."""

    def __init__(self, pose_nc: int = 68, appearance_nc: int = 3,
                 output_nc: int = 3, aux_output_nc: tuple = (),
                 nf: int = 32, max_nf: int = 128, num_scales: int = 7,
                 num_warp_scales: int = 5, n_residual_blocks: int = 2,
                 vis_mode: str = "none", no_end_norm: bool = False,
                 vis_expand_mult: int = 2):
        super().__init__()
        self.num_scales, self.n_res = num_scales, n_residual_blocks
        self.num_warp_scales, self.vis_mode = num_warp_scales, vis_mode
        self.vis_expand_mult = vis_expand_mult
        self.n_aux = len(aux_output_nc)
        chans = [min(nf * (l + 1), max_nf) for l in range(num_scales + 1)]
        self.encp_pre_conv = conv_norm(pose_nc, nf, end_norm=not no_end_norm)
        self.enca_pre_conv = conv_norm(appearance_nc, nf,
                                       end_norm=not no_end_norm)
        for l in range(num_scales):
            down = downsample(chans[l], chans[l + 1])
            self.add_module(f"encp_{l}_downsample", down)
            # the reference registers the same module a second time
            self.add_module(f"enca_{l}_downsample", down)
            self.add_module(f"dec_{l}_upsample",
                            upsample(chans[l + 1], chans[l]))
            for i in range(n_residual_blocks):
                self.add_module(f"encp_{l}_res_{i}", ResidualBlock(chans[l]))
                self.add_module(f"enca_{l}_res_{i}", ResidualBlock(chans[l]))
                last = l == num_scales - 1 and i == n_residual_blocks - 1
                self.add_module(f"dec_{l}_res_{i}", ResidualBlock(
                    chans[l], dim_a=chans[l] * 2,
                    no_end_norm=no_end_norm and last))
                if l < num_warp_scales:
                    vis_block = {
                        "soft_gate": lambda c=chans[l]: GateBlock(
                            c, c * vis_expand_mult),
                        "residual": lambda c=chans[l]: ResidualBlock(
                            c, dim_a=c * vis_expand_mult),
                        "res_no_vis": lambda c=chans[l]: ResidualBlock(c),
                    }.get(vis_mode)
                    if vis_block is not None:
                        self.add_module(f"enca_{l}_vis_{i}", vis_block())
        self.dec_fuse = conv_norm(chans[-1] * 2, chans[-1])
        self.dec_output = out_head(nf, output_nc)
        for i, a_nc in enumerate(aux_output_nc):
            self.add_module(f"dec_aux_output_{i}", out_head(nf, a_nc))

    def _vis_expand(self, feat, vis):
        return torch.cat([feat * (vis == i).to(feat.dtype)
                          for i in range(self.vis_expand_mult)], dim=1)

    def forward(self, x_p, x_a, flow=None, vis=None):
        use_fw = flow is not None
        if use_fw:
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
            warp = use_fw and l < self.num_warp_scales
            if warp:
                k = 2 ** l
                flow_l = flow if l == 0 else F.avg_pool2d(flow, k, k) / k
                # visible > invisible > background: a min-pool
                vis_l = vis if l == 0 else -F.max_pool2d(-vis, k, k)
            for i in range(self.n_res):
                x_a = getattr(self, f"enca_{l}_res_{i}")(x_a)
                if not warp:
                    hidden_a.append(x_a)
                    continue
                x_w = warp_acc_flow(x_a, flow_l)
                observe.count("pt.feature_warps", 1)
                if self.vis_mode == "hard_gate":
                    x_w = x_w * (vis_l < 2).to(x_w.dtype)
                elif self.vis_mode in ("soft_gate", "residual"):
                    x_w = getattr(self, f"enca_{l}_vis_{i}")(
                        x_w, self._vis_expand(x_w, vis_l))
                elif self.vis_mode == "res_no_vis":
                    x_w = getattr(self, f"enca_{l}_vis_{i}")(x_w)
                hidden_a.append(x_w)
            x_a = down(x_a)
        x = self.dec_fuse(torch.cat([x_p, x_a], dim=1))
        for l in range(self.num_scales - 1, -1, -1):
            x = getattr(self, f"dec_{l}_upsample")(x)
            for i in range(self.n_res - 1, -1, -1):
                x = getattr(self, f"dec_{l}_res_{i}")(
                    x, torch.cat([hidden_p.pop(), hidden_a.pop()], dim=1))
        out = self.dec_output(x)
        if self.n_aux:
            return out, [getattr(self, f"dec_aux_output_{i}")(x)
                         for i in range(self.n_aux)]
        return out


class IFUnetGenerator(nn.Module):
    """The intrinsic-flow UnetGenerator (networks.py:76-150): residual
    blocks per scale, strided-conv downsampling, pixel-shuffle upsampling,
    skips into the decoder blocks' side inputs. forward(x) -> (N,
    output_nc, H, W) pre-tanh; with ``multi_output_nc`` the
    UnetGenerator_MultiOutput (:151-231): a list of heads, each
    [1x1 conv-norm, act, reflect pad, 7x7 conv] (pre-sigmoid), as
    PoseTransferModel's pixel warper netPW uses with (1,)."""

    def __init__(self, input_nc: int, output_nc: int = 3, nf: int = 64,
                 max_nf: int = 256, num_scales: int = 7,
                 n_residual_blocks: int = 2, slope: float = 0.0,
                 multi_output_nc: tuple = ()):
        super().__init__()
        self.num_scales, self.n_res = num_scales, n_residual_blocks
        self.multi_output_nc = tuple(multi_output_nc)
        chans = [min(nf * (l + 1), max_nf) for l in range(num_scales + 1)]
        self.pre_conv = conv_norm(input_nc, nf)
        for l in range(num_scales):
            self.add_module(f"enc_{l}_downsample",
                            downsample(chans[l], chans[l + 1], slope))
            self.add_module(f"dec_{l}_upsample",
                            upsample(chans[l + 1], chans[l], slope))
            for i in range(n_residual_blocks):
                self.add_module(f"enc_{l}_res_{i}",
                                ResidualBlock(chans[l], slope=slope))
                self.add_module(f"dec_{l}_res_{i}", ResidualBlock(
                    chans[l], dim_a=chans[l], slope=slope))
        if self.multi_output_nc:
            for i, c in enumerate(self.multi_output_nc):
                self.add_module(f"dec_output_{i}", nn.Sequential(
                    conv_norm(nf, nf), _act(slope), nn.ReflectionPad2d(3),
                    nn.Conv2d(nf, c, 7)))
        else:
            self.dec_output = out_head(nf, output_nc)

    def forward(self, x):
        x = self.pre_conv(x)
        hiddens = []
        for l in range(self.num_scales):
            for i in range(self.n_res):
                x = getattr(self, f"enc_{l}_res_{i}")(x)
                hiddens.append(x)
            x = getattr(self, f"enc_{l}_downsample")(x)
        for l in range(self.num_scales - 1, -1, -1):
            x = getattr(self, f"dec_{l}_upsample")(x)
            for i in range(self.n_res - 1, -1, -1):
                x = getattr(self, f"dec_{l}_res_{i}")(x, hiddens.pop())
        if self.multi_output_nc:
            return [getattr(self, f"dec_output_{i}")(x)
                    for i in range(len(self.multi_output_nc))]
        return self.dec_output(x)


class IFUnetGeneratorMultiOutput(IFUnetGenerator):
    """UnetGenerator_MultiOutput (networks.py:151-231) with netPW's widths:
    forward(x) -> a list of (N, c, H, W) heads, pre-sigmoid."""

    def __init__(self, input_nc: int, output_nc: tuple = (1,), nf: int = 32,
                 max_nf: int = 128, num_scales: int = 7,
                 n_residual_blocks: int = 2, slope: float = 0.0):
        super().__init__(input_nc, nf=nf, max_nf=max_nf,
                         num_scales=num_scales,
                         n_residual_blocks=n_residual_blocks, slope=slope,
                         multi_output_nc=output_nc)
