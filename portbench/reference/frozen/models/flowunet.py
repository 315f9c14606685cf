"""Intrinsic-flow regressor (FlowUnet) and its keypoint-map front end. Port
of ``animateportrait_tpu/models/flowunet.py``, built recursively like the
reference (Module2/intrinsic_flow_models/networks.py:509-644) so the
state-dict keys are the reference checkpoint's. The JAX package's packed
stem and stride-2 convs (``_SameConvPacked``, ``_Stride2Conv``) are plain
convs here on the same parameters. BatchNorm runs on running statistics
(the net is built in eval mode); after ``.train()`` it takes flax's batch
statistics, as the flow-regression trainer's step does.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.frozen.nn import BatchNorm2d


class FlowUnetSkipConnectionBlock(nn.Module):
    def __init__(self, outer_nc: int, inner_nc: int,
                 submodule: nn.Module | None = None, outermost: bool = False,
                 innermost: bool = False):
        super().__init__()
        self.outermost, self.innermost = outermost, innermost
        downconv = nn.Conv2d(outer_nc, inner_nc, 4, 2, 1, bias=False)
        if outermost:
            upconv = nn.ConvTranspose2d(inner_nc * 2, outer_nc, 4, 2, 1)
            down = [downconv, BatchNorm2d(inner_nc)]
        elif innermost:
            upconv = nn.ConvTranspose2d(inner_nc, outer_nc, 4, 2, 1,
                                        bias=False)
            down = [nn.LeakyReLU(0.2), downconv]
        else:
            upconv = nn.ConvTranspose2d(inner_nc * 2, outer_nc, 4, 2, 1,
                                        bias=False)
            down = [nn.LeakyReLU(0.2), downconv, BatchNorm2d(inner_nc)]
        self.down = nn.Sequential(*down)
        self.up = nn.Sequential(nn.ReLU(), upconv, BatchNorm2d(outer_nc))
        self.submodule = submodule
        self.predict_flow = nn.Sequential(nn.LeakyReLU(0.1),
                                          nn.Conv2d(outer_nc, 2, 3, 1, 1))

    def forward(self, x):
        if self.innermost:
            x_ = self.up(self.down(x))
            flows = []
        else:
            x_, flows = self.submodule(self.down(x))
            x_ = self.up(x_)
        out = x_ if self.outermost else torch.cat([x, x_], dim=1)
        return out, [self.predict_flow(x_)] + flows


class FlowUnet(nn.Module):
    """FlowUnet, start_scale 2. forward(x (N, input_nc, H, W)) ->
    (flow (N,2,H,W), vis (N,3,H,W), flow_pyramid, feat)."""

    def __init__(self, input_nc: int = 136, nf: int = 16, num_scale: int = 4,
                 max_nf: int = 512):
        super().__init__()
        self.conv_downsample = nn.Sequential(
            nn.Conv2d(input_nc, nf, 7, padding=3, bias=False),
            BatchNorm2d(nf), nn.LeakyReLU(0.1),
            nn.Conv2d(nf, nf * 2, 3, 2, 1, bias=False),
            BatchNorm2d(nf * 2), nn.LeakyReLU(0.1))
        nc = nf * 2
        block = None
        for level in reversed(range(num_scale)):
            block = FlowUnetSkipConnectionBlock(
                min(max_nf, nc * 2 ** level), min(max_nf, nc * 2 ** (level + 1)),
                submodule=block, outermost=level == 0,
                innermost=level == num_scale - 1)
        self.unet_block = block
        self.predict_vis = nn.Sequential(nn.LeakyReLU(0.1),
                                         nn.Conv2d(min(max_nf, nc), 3, 3, 1, 1))
        self.eval()

    def forward(self, x):
        feat, flows = self.unet_block(self.conv_downsample(x))
        vis = self.predict_vis(feat)
        size = (feat.shape[2] * 2, feat.shape[3] * 2)
        flow = F.interpolate(flows[0], size=size, mode="bilinear",
                             align_corners=False)
        vis = F.interpolate(vis, size=size, mode="bilinear",
                            align_corners=False)
        return flow, vis, flows, feat


def kp_to_map_binary(size_hw: tuple[int, int], kps: torch.Tensor,
                     radius: float = 4.0) -> torch.Tensor:
    """Binary-disc keypoint maps (geomcgt_ifw_test_model.py:12-37).
    kps: (..., K, 2) (x, y) -> (..., K, H, W) in kps' float dtype;
    keypoints at (-1, -1) give empty maps."""
    h, w = size_hw
    dt = kps.dtype if kps.is_floating_point() else torch.float32
    xg = torch.arange(w, dtype=dt, device=kps.device)
    yg = torch.arange(h, dtype=dt, device=kps.device)
    x = kps[..., 0][..., None, None]
    y = kps[..., 1][..., None, None]
    d2 = (xg[None, :] - x) ** 2 + (yg[:, None] - y) ** 2
    m = (d2 <= radius ** 2).to(dt)
    invalid = (kps[..., 0] == -1) | (kps[..., 1] == -1)
    return m * (1.0 - invalid[..., None, None].to(dt))
