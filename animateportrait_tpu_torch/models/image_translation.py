"""Module1's image-translation renderer (MakeItTalk's texture branch) and
the geometric matching module. Port of
``animateportrait_tpu/models/image_translation.py``
(Module1/src/models/model_image_translation.py), NCHW:

- ``ResUnetGenerator`` (:412-507): a Unet of stride-2 conv downs and
  nearest-upsample + conv ups with two residual blocks on each side. The
  JAX package has no checkpoint loader for it, so its keys are the JAX
  tree's: every skip block is a child of the generator (``outer``,
  ``up1``, ``up2``, ``up4``, ``mid{i}``, ``inner``) and calls the next
  one inward, as the flax blocks (created in the generator's scope) do;
- ``Vgg19Features`` (:510-540): torchvision's ``vgg19.features`` layout,
  sliced after relu1_1, relu2_1, relu3_1, relu4_1 and relu5_1;
  ``gram_matrix`` and ``vgg_loss`` (:542-596);
- the GMM (:102-290, :599-623): ``FeatureExtraction``,
  ``feature_l2_norm``, ``feature_correlation``, ``FeatureRegression``,
  ``affine_grid``, ``tps_grid`` and ``GMM``, with the reference's keys.

BatchNorms are the port's (flax's statistics in training mode).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from animateportrait_tpu_torch.nn import BatchNorm2d


class ResidualBlock(nn.Module):
    """conv-BN-ReLU-conv-BN + skip, then ReLU (:385-409)."""

    def __init__(self, features: int):
        super().__init__()
        self.conv0 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn0 = BatchNorm2d(features)
        self.conv1 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn1 = BatchNorm2d(features)

    def forward(self, x):
        y = F.relu(self.bn0(self.conv0(x)))
        return F.relu(x + self.bn1(self.conv1(y)))


class ResUnetSkipBlock(nn.Module):
    """One level: stride-2 conv down (BN unless outermost or innermost),
    ReLU, two residual blocks, the inner levels, nearest x2 + conv up
    and, below the outermost, BN + ReLU, two residual blocks and the skip
    concatenation."""

    def __init__(self, outer_nc: int, inner_nc: int, input_nc: int,
                 outermost: bool = False, innermost: bool = False):
        super().__init__()
        self.outermost = outermost
        self.down = nn.Conv2d(input_nc, inner_nc, 3, 2, 1, bias=False)
        if not (outermost or innermost):
            self.down_bn = BatchNorm2d(inner_nc)
        self.down_res0 = ResidualBlock(inner_nc)
        self.down_res1 = ResidualBlock(inner_nc)
        # an inner level returns its input and its output concatenated
        self.up = nn.Conv2d(inner_nc if innermost else 2 * inner_nc,
                            outer_nc, 3, 1, 1, bias=False)
        if not outermost:
            self.up_bn = BatchNorm2d(outer_nc)
            self.up_res0 = ResidualBlock(outer_nc)
            self.up_res1 = ResidualBlock(outer_nc)

    def forward(self, x, inner=None):
        y = self.down(x)
        if hasattr(self, "down_bn"):
            y = self.down_bn(y)
        y = self.down_res1(self.down_res0(F.relu(y)))
        if inner is not None:
            y = inner(y)
        y = self.up(F.interpolate(y, scale_factor=2, mode="nearest"))
        if self.outermost:
            return y
        y = self.up_res1(self.up_res0(F.relu(self.up_bn(y))))
        return torch.cat([x, y], dim=1)


class ResUnetGenerator(nn.Module):
    """ResUnet; MakeItTalk's input is 6 channels (image + landmark
    sketch). forward(x (N, input_nc, H, W)) -> (N, output_nc, H, W)."""

    def __init__(self, input_nc: int = 6, output_nc: int = 3,
                 num_downs: int = 6, ngf: int = 64):
        super().__init__()
        g8 = ngf * 8
        specs = [("outer", output_nc, ngf, input_nc, True, False),
                 ("up1", ngf, ngf * 2, ngf, False, False),
                 ("up2", ngf * 2, ngf * 4, ngf * 2, False, False),
                 ("up4", ngf * 4, g8, ngf * 4, False, False)]
        specs += [(f"mid{i}", g8, g8, g8, False, False)
                  for i in reversed(range(num_downs - 5))]
        specs.append(("inner", g8, g8, g8, False, True))
        self.order = [s[0] for s in specs]
        for name, outer_nc, inner_nc, in_nc, outermost, innermost in specs:
            self.add_module(name, ResUnetSkipBlock(
                outer_nc, inner_nc, in_nc, outermost, innermost))

    def _level(self, i: int, x):
        inner = (lambda y: self._level(i + 1, y)) \
            if i + 1 < len(self.order) else None
        return getattr(self, self.order[i])(x, inner)

    def forward(self, x):
        return self._level(0, x)


_VGG19_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M")
# torchvision vgg19.features indices where the slices end
_SLICE_ENDS = (2, 7, 12, 21, 30)


class Vgg19Features(nn.Module):
    """torchvision ``vgg19.features`` sliced at [0, 2, 7, 12, 21, 30):
    forward(x) -> the 5 slice outputs (the layers past 29 are held for the
    checkpoint's keys and not run)."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for v in _VGG19_CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, v, 3, 1, 1), nn.ReLU()]
                cin = v
        self.features = nn.Sequential(*layers)

    def forward(self, x):
        outs = []
        for i, layer in enumerate(self.features[:_SLICE_ENDS[-1]]):
            x = layer(x)
            if i + 1 in _SLICE_ENDS:
                outs.append(x)
        return outs


def gram_matrix(x: torch.Tensor) -> torch.Tensor:
    """(:542-550): the (a c) x (a c) Gram of the NCHW features over
    a c h w."""
    a, c, h, w = x.shape
    feats = x.reshape(a * c, h * w)
    return feats @ feats.T / (a * c * h * w)


def vgg_loss(vgg: Vgg19Features, x, y, style: bool = False):
    """VGGLoss (:561-596): the sum of per-slice L1 (and of Gram MSE x 3e7
    with ``style``); y's features carry no gradient."""
    fx = vgg(x)
    with torch.no_grad():
        fy = vgg(y)
    loss = style_loss = 0.0
    for a, b in zip(fx, fy):
        loss = loss + torch.mean(torch.abs(a - b))
        if style:
            style_loss = style_loss + torch.mean(torch.square(
                gram_matrix(a) - gram_matrix(b))) * 30000000.0
    return (loss, style_loss) if style else loss


# --- the geometric matching module ----------------------------------------

class FeatureExtraction(nn.Module):
    """A strided conv tower in the reference's conv -> ReLU -> BN order
    (:102-121); keys ``model.{i}``."""

    def __init__(self, input_nc: int, ngf: int = 64, n_layers: int = 3):
        super().__init__()
        layers = [nn.Conv2d(input_nc, ngf, 4, 2, 1), nn.ReLU(),
                  BatchNorm2d(ngf)]
        for i in range(n_layers):
            cin = min(2 ** i * ngf, 512)
            cout = 2 ** (i + 1) * ngf if 2 ** i * ngf < 512 else 512
            layers += [nn.Conv2d(cin, cout, 4, 2, 1), nn.ReLU(),
                       BatchNorm2d(cout)]
        layers += [nn.Conv2d(512, 512, 3, 1, 1), nn.ReLU(), BatchNorm2d(512),
                   nn.Conv2d(512, 512, 3, 1, 1), nn.ReLU()]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        return self.model(x)


def feature_l2_norm(feat: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """FeatureL2Norm (:124-131) over the channels."""
    return feat / torch.sqrt(torch.sum(feat * feat, dim=1, keepdim=True)
                             + eps)


def feature_correlation(fa: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
    """FeatureCorrelation (:133-147): (N,C,H,W) x 2 -> (N, W*H, H, W),
    channel j indexing feature A's position column-major (j = x H + y)."""
    n, c, h, w = fa.shape
    a = fa.transpose(2, 3).reshape(n, c, h * w)
    b = fb.reshape(n, c, h * w).transpose(1, 2)
    corr = torch.bmm(b, a)
    return corr.reshape(n, h, w, h * w).permute(0, 3, 1, 2)


class FeatureRegression(nn.Module):
    """(:149-180): the correlation -> 2 grid_size^2 TPS offsets in
    [-1, 1]; ``hw`` is the correlation's spatial size."""

    def __init__(self, input_nc: int, hw: tuple[int, int],
                 output_dim: int = 18):
        super().__init__()
        layers, cin = [], input_nc
        for ch, k, s in ((512, 4, 2), (256, 4, 2), (128, 3, 1), (64, 3, 1)):
            layers += [nn.Conv2d(cin, ch, k, s, 1), BatchNorm2d(ch),
                       nn.ReLU()]
            cin = ch
        self.conv = nn.Sequential(*layers)
        self.linear = nn.Linear(64 * (hw[0] // 4) * (hw[1] // 4), output_dim)

    def forward(self, x):
        x = self.conv(x)
        return torch.tanh(self.linear(x.reshape(x.shape[0], -1)))


def affine_grid(theta: torch.Tensor, size_hw: tuple[int, int]
                ) -> torch.Tensor:
    """AffineGridGen (:183-196): theta (N, 2, 3) -> the normalized sampling
    grid (N, H, W, 2) of ``F.affine_grid(align_corners=False)``."""
    n = theta.shape[0]
    return F.affine_grid(theta, (n, 1, *size_hw), align_corners=False)


def _tps_l_inverse(grid_size: int) -> tuple[np.ndarray, np.ndarray]:
    """compute_L_inverse (:255-270) of the regular control grid."""
    ax = np.linspace(-1, 1, grid_size)
    py, px = np.meshgrid(ax, ax)
    px = px.reshape(-1, 1)
    py = py.reshape(-1, 1)
    n = grid_size * grid_size
    d2 = (px - px.T) ** 2 + (py - py.T) ** 2
    d2[d2 == 0] = 1.0
    k = d2 * np.log(d2)
    p = np.concatenate([np.ones((n, 1)), px, py], axis=1)
    l_mat = np.block([[k, p], [p.T, np.zeros((3, 3))]])
    return np.linalg.inv(l_mat).astype(np.float32), \
        np.concatenate([px, py], axis=1).astype(np.float32)


def tps_grid(theta: torch.Tensor, size_hw: tuple[int, int],
             grid_size: int = 3) -> torch.Tensor:
    """TpsGridGen (:198-290): theta (N, 2 grid_size^2) control-point
    offsets -> the normalized sampling grid (N, H, W, 2)."""
    h, w = size_hw
    dev, dt = theta.device, theta.dtype
    li, ctrl = (torch.as_tensor(a, device=dev, dtype=dt)
                for a in _tps_l_inverse(grid_size))
    n = grid_size * grid_size
    qx = theta[:, :n] + ctrl[:, 0]
    qy = theta[:, n:] + ctrl[:, 1]
    wx, wy = qx @ li[:n, :n].T, qy @ li[:n, :n].T
    ax, ay = qx @ li[n:, :n].T, qy @ li[n:, :n].T      # (N, 3)
    gy, gx = torch.meshgrid(torch.linspace(-1, 1, h, device=dev, dtype=dt),
                            torch.linspace(-1, 1, w, device=dev, dtype=dt),
                            indexing="ij")
    d2 = (gx[..., None] - ctrl[:, 0]) ** 2 + (gy[..., None] - ctrl[:, 1]) ** 2
    d2 = torch.where(d2 == 0, torch.ones_like(d2), d2)
    u = d2 * torch.log(d2)                              # (H, W, n)

    def surface(a, wts):
        return (a[:, 0, None, None] + a[:, 1, None, None] * gx
                + a[:, 2, None, None] * gy
                + torch.einsum("hwj,nj->nhw", u, wts))

    return torch.stack([surface(ax, wx), surface(ay, wy)], dim=-1)


class GMM(nn.Module):
    """Geometric Matching Module (:599-623): forward(input_a, input_b) ->
    (the sampling grid (N, H, W, 2), theta)."""

    def __init__(self, input_nc_a: int = 22, input_nc_b: int = 1,
                 fine_height: int = 256, fine_width: int = 192,
                 grid_size: int = 3):
        super().__init__()
        self.size = (fine_height, fine_width)
        self.grid_size = grid_size
        hw = (fine_height // 16, fine_width // 16)
        self.extractionA = FeatureExtraction(input_nc_a)
        self.extractionB = FeatureExtraction(input_nc_b)
        self.regression = FeatureRegression(hw[0] * hw[1], hw,
                                            2 * grid_size ** 2)

    def forward(self, input_a, input_b):
        corr = feature_correlation(
            feature_l2_norm(self.extractionA(input_a)),
            feature_l2_norm(self.extractionB(input_b)))
        theta = self.regression(corr)
        return tps_grid(theta, self.size, self.grid_size), theta
