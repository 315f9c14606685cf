"""The LPIPS learned perceptual metric (``PNetLin``) and its ranking heads,
NCHW. Port of ``animateportrait_tpu/models/lpips.py`` (the reference's
Module2/models/networks_basic.py and the backbones of
pretrained_networks.py).

The backbones are written out here, in torchvision's ``features`` layout
(vgg16, alexnet, squeezenet1_1), so a torchvision state dict's
``features.N.*`` keys load as they are (``load_backbone``); the LPIPS
linear heads keep their ``lin{k}.model.1.weight`` keys (``load_pnetlin``).
No torchvision. ``normalize_tensor`` divides by ``norm + 1e-10``, as the
reference does. No kernel of the port lies on this path.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def scaling_layer(x: torch.Tensor) -> torch.Tensor:
    """ScalingLayer (networks_basic.py:92-99): RGB in [-1, 1] -> the
    backbones' input scale."""
    shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device)
    scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device)
    return (x - shift[None, :, None, None]) / scale[None, :, None, None]


def normalize_tensor(feat: torch.Tensor, eps: float = 1e-10
                     ) -> torch.Tensor:
    """util.normalize_tensor (Module2/util/util.py:100-102), over channels."""
    return feat / (torch.sqrt(torch.sum(feat * feat, dim=1, keepdim=True))
                   + eps)


class _Backbone(nn.Module):
    """A torchvision ``features`` Sequential, returning the outputs of the
    layers in ``TAPS``."""

    TAPS: tuple = ()

    def forward(self, x):
        outs = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self.TAPS:
                outs.append(x)
        return outs


def _relu():
    return nn.ReLU()


class Vgg16Features(_Backbone):
    """vgg16 slices 1-5, ending at relu1_2, 2_2, 3_3, 4_3, 5_3
    (pretrained_networks.py:97-138)."""

    TAPS = (3, 8, 15, 22, 29)

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for b, block in enumerate(((64, 64), (128, 128), (256,) * 3,
                                   (512,) * 3, (512,) * 3)):
            if b:
                layers.append(nn.MaxPool2d(2, 2))
            for c in block:
                layers += [nn.Conv2d(cin, c, 3, 1, 1), _relu()]
                cin = c
        self.features = nn.Sequential(*layers)


class AlexNetFeatures(_Backbone):
    """alexnet slices 1-5 (pretrained_networks.py:57-95)."""

    TAPS = (1, 4, 7, 9, 11)

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 11, 4, 2), _relu(), nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, 1, 2), _relu(), nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, 1, 1), _relu(),
            nn.Conv2d(384, 256, 3, 1, 1), _relu(),
            nn.Conv2d(256, 256, 3, 1, 1), _relu())


class Fire(nn.Module):
    """torchvision's squeezenet Fire module."""

    def __init__(self, cin: int, squeeze: int, expand: int):
        super().__init__()
        self.squeeze = nn.Conv2d(cin, squeeze, 1)
        self.expand1x1 = nn.Conv2d(squeeze, expand, 1)
        self.expand3x3 = nn.Conv2d(squeeze, expand, 3, 1, 1)

    def forward(self, x):
        s = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(s)),
                          F.relu(self.expand3x3(s))], dim=1)


class SqueezeNetFeatures(_Backbone):
    """squeezenet1_1 slices 1-7 (pretrained_networks.py:6-54), ceil-mode
    max pools."""

    TAPS = (1, 4, 7, 9, 10, 11, 12)

    def __init__(self):
        super().__init__()

        def pool():
            return nn.MaxPool2d(3, 2, ceil_mode=True)

        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 3, 2), _relu(), pool(),
            Fire(64, 16, 64), Fire(128, 16, 64), pool(),
            Fire(128, 32, 128), Fire(256, 32, 128), pool(),
            Fire(256, 48, 192), Fire(384, 48, 192), Fire(384, 64, 256),
            Fire(512, 64, 256))


BACKBONES = {
    "vgg": (Vgg16Features, (64, 128, 256, 512, 512)),
    "vgg16": (Vgg16Features, (64, 128, 256, 512, 512)),
    "alex": (AlexNetFeatures, (64, 192, 384, 256, 256)),
    "squeeze": (SqueezeNetFeatures, (64, 128, 256, 384, 384, 512, 512)),
}


class NetLinLayer(nn.Module):
    """A 1x1 conv to one channel without bias (networks_basic.py:101-110);
    slot 0 is the reference's dropout, a no-op in the metric's eval use."""

    def __init__(self, chn_in: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(),
                                   nn.Conv2d(chn_in, 1, 1, bias=False))

    def forward(self, x):
        return self.model(x)


class PNetLin(nn.Module):
    """The learned perceptual metric (networks_basic.py:22-89):
    forward(in0, in1, ret_per_layer=False) -> (N, 1, 1, 1) distance, or
    (N, 1, H, W) maps with ``spatial``; ``lpips=False`` sums the squared
    differences of the normalized features over channels instead of the
    linear heads."""

    def __init__(self, pnet_type: str = "vgg", spatial: bool = False,
                 lpips: bool = True, version: str = "0.1"):
        super().__init__()
        net_cls, chns = BACKBONES[pnet_type]
        self.spatial, self.lpips, self.version = spatial, lpips, version
        self.net = net_cls()
        self.n_layers = len(chns)
        if lpips:
            for k, c in enumerate(chns):
                self.add_module(f"lin{k}", NetLinLayer(c))

    def forward(self, in0, in1, ret_per_layer: bool = False):
        if self.version == "0.1":
            in0, in1 = scaling_layer(in0), scaling_layer(in1)
        res = []
        for k, (f0, f1) in enumerate(zip(self.net(in0), self.net(in1))):
            d = torch.square(normalize_tensor(f0) - normalize_tensor(f1))
            if self.lpips:
                d = getattr(self, f"lin{k}")(d)
            else:
                d = d.sum(dim=1, keepdim=True)
            if self.spatial:
                d = F.interpolate(d, size=in0.shape[2:], mode="bilinear",
                                  align_corners=False)
            else:
                d = d.mean(dim=(2, 3), keepdim=True)
            res.append(d)
        val = sum(res[1:], res[0])
        return (val, res) if ret_per_layer else val

    def load_backbone(self, sd: dict) -> None:
        """A torchvision state dict of the backbone (its ``features.*``
        keys; the classifier's are ignored)."""
        self.net.load_state_dict({k: v for k, v in sd.items()
                                  if k.startswith("features.")})

    def load_pnetlin(self, pnet_sd: dict, lins_sd: dict | None = None
                     ) -> "PNetLin":
        """The backbone's torchvision state dict and the LPIPS heads'
        (``lin{k}.model.1.weight``), as the JAX package's
        ``load_pnetlin_params`` takes them."""
        self.load_backbone(pnet_sd)
        if self.lpips and lins_sd is not None:
            for k in range(self.n_layers):
                getattr(self, f"lin{k}").model[1].weight.data.copy_(
                    lins_sd[f"lin{k}.model.1.weight"])
        return self


class Dist2LogitLayer(nn.Module):
    """(networks_basic.py:112-125): two distances -> a judgement in [0, 1];
    the reference's ``model`` Sequential."""

    def __init__(self, chn_mid: int = 32, use_sigmoid: bool = True):
        super().__init__()
        layers = [nn.Conv2d(5, chn_mid, 1), nn.LeakyReLU(0.2),
                  nn.Conv2d(chn_mid, chn_mid, 1), nn.LeakyReLU(0.2),
                  nn.Conv2d(chn_mid, 1, 1)]
        if use_sigmoid:
            layers.append(nn.Sigmoid())
        self.model = nn.Sequential(*layers)

    def forward(self, d0, d1, eps: float = 0.1):
        return self.model(torch.cat([d0, d1, d0 - d1, d0 / (d1 + eps),
                                     d1 / (d0 + eps)], dim=1))


def bce_ranking_loss(logit: torch.Tensor, judge: torch.Tensor,
                     eps: float = 1e-7) -> torch.Tensor:
    """BCERankingLoss (networks_basic.py:127-137): judge in [-1, 1]."""
    per = (judge + 1.0) / 2.0
    logit = torch.clamp(logit, eps, 1.0 - eps)
    return -torch.mean(per * torch.log(logit)
                       + (1 - per) * torch.log(1 - logit))


def l2_rgb(in0: torch.Tensor, in1: torch.Tensor) -> torch.Tensor:
    """The L2 FakeNet metric in RGB (networks_basic.py:146-153), per
    image."""
    return torch.mean(torch.square(in0 - in1), dim=(1, 2, 3))
