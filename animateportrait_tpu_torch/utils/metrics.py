"""Image quality metrics with the reference's semantics. Port of
``animateportrait_tpu/utils/metrics.py``: the reference
(Module2/intrinsic_flow_models/modules.py:560-589) maps [-1, 1] images to
uint8 levels and calls skimage's compare_psnr / compare_ssim
(multichannel), whose defaults for uint8 are a 7x7 uniform window with
the unbiased covariance correction, data_range 255, borders cropped and
channels averaged. Images are NCHW here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def to_uint8_space(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] floats -> quantized [0, 255] floats (modules.py:563-565)."""
    return torch.round(torch.clamp((x + 1.0) * 127.5, 0, 255))


def _uniform_valid(x: torch.Tensor, win: int) -> torch.Tensor:
    """Mean over the win x win VALID windows of each plane."""
    return F.avg_pool2d(x, win, stride=1)


def ssim(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 255.0,
         win_size: int = 7) -> torch.Tensor:
    """Mean structural similarity per batch item, channels averaged:
    skimage.metrics.structural_similarity(multichannel=True) with its
    defaults. img*: (N, C, H, W) in [0, data_range]."""
    img1 = img1.float()
    img2 = img2.float()
    np_ = win_size * win_size
    cov_norm = np_ / (np_ - 1.0)
    ux = _uniform_valid(img1, win_size)
    uy = _uniform_valid(img2, win_size)
    uxx = _uniform_valid(img1 * img1, win_size)
    uyy = _uniform_valid(img2 * img2, win_size)
    uxy = _uniform_valid(img1 * img2, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    a1 = 2.0 * ux * uy + c1
    a2 = 2.0 * vxy + c2
    b1 = ux * ux + uy * uy + c1
    b2 = vx + vy + c2
    return torch.mean((a1 * a2) / (b1 * b2), dim=(1, 2, 3))


def ssim_ref(fake: torch.Tensor, real: torch.Tensor,
             mask: torch.Tensor | None = None) -> torch.Tensor:
    """modules.SSIM forward: [-1, 1] inputs -> scalar mean SSIM."""
    a = to_uint8_space(fake)
    b = to_uint8_space(real)
    if mask is not None:
        a = a * mask
        b = b * mask
    return torch.mean(ssim(a, b))


def psnr_ref(fake: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """modules.PSNR forward: [-1, 1] inputs -> scalar mean PSNR (dB)."""
    a = to_uint8_space(fake)
    b = to_uint8_space(real)
    mse = torch.mean(torch.square(a - b), dim=(1, 2, 3))
    return torch.mean(10.0 * torch.log10(
        255.0 ** 2 / torch.clamp(mse, min=1e-12)))
