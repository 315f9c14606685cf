"""Image warping, NCHW. Port of ``animateportrait_tpu/ops/warp.py``.

The JAX ``grid_sample`` reproduces ``F.grid_sample`` (both corner
conventions, zeros or border padding), so the port calls that operator
directly; the TPU gather workarounds (``_aug4``, ``_gather_chunk``) have no
counterpart. ``F.grid_sample``'s nearest mode is the JAX ``grid_sample``'s
too: both round half to even and, under zeros padding, zero a sample whose
rounded index lies outside the image. What stays is the reference's
flow-warp quirk, and the pixel-coordinate samplers: ``sample_bilinear``
(``dense_image_warp``, the face crops), ``sample_bicubic`` (the
MobileFaceNet crop) and ``sample_nearest``. They index in pixels, as the
JAX functions do, so no round trip through normalized coordinates moves a
sample; they are plain gathers that autograd differentiates (with respect
to the image, and for the first two the coordinates).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _gather(img: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor
            ) -> torch.Tensor:
    """img (N, C, H, W) at integer pixels (rows, cols) of shape (N, *S),
    which must lie in the image -> (N, C, *S)."""
    n, c, h, w = img.shape
    idx = (rows * w + cols).reshape(n, 1, -1).expand(n, c, -1)
    return img.reshape(n, c, h * w).gather(2, idx).reshape(
        n, c, *rows.shape[1:])


def sample_bilinear(img: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor
                    ) -> torch.Tensor:
    """Bilinear samples of ``img`` (N, C, H, W) at float pixel coordinates
    ``iy``, ``ix`` of shape (N, *S) -> (N, C, *S), with the JAX function's
    border padding: the base index clamped to [-1, H-1] (resp. W) and each
    tap to the image, which is ``F.grid_sample``'s border padding."""
    _, _, h, w = img.shape
    y0 = torch.floor(iy)
    x0 = torch.floor(ix)
    wy = (iy - y0).unsqueeze(1)
    wx = (ix - x0).unsqueeze(1)
    y0i = y0.long().clamp(-1, h - 1)
    x0i = x0.long().clamp(-1, w - 1)

    def tap(dy, dx):
        return _gather(img, (y0i + dy).clamp(0, h - 1),
                       (x0i + dx).clamp(0, w - 1))

    top = tap(0, 0) * (1 - wx) + tap(0, 1) * wx
    bot = tap(1, 0) * (1 - wx) + tap(1, 1) * wx
    return top * (1 - wy) + bot * wy


def sample_bicubic(img: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor
                   ) -> torch.Tensor:
    """Bicubic samples of ``img`` (N, C, H, W) at float pixel coordinates
    (N, *S) -> (N, C, *S): torch's kernel (a = -0.75) with the JAX
    function's border handling, the base index clamped to [-1, H-1] and
    each of the 4 x 4 taps to the image. (Per-tap clamping alone differs
    only more than 1 px outside the image.)"""
    _, _, h, w = img.shape
    a = -0.75
    y0 = torch.floor(iy)
    x0 = torch.floor(ix)
    ty = (iy - y0).unsqueeze(1)
    tx = (ix - x0).unsqueeze(1)

    def cubic(t):
        t2, t3 = t * t, t * t * t
        return (a * (t3 - 2 * t2 + t),
                (a + 2) * t3 - (a + 3) * t2 + 1,
                -(a + 2) * t3 + (2 * a + 3) * t2 - a * t,
                a * (t2 - t3))

    wy, wx = cubic(ty), cubic(tx)
    gy = y0.long().clamp(-1, h - 1)
    gx = x0.long().clamp(-1, w - 1)
    out = 0.0
    for jy in range(4):
        r = (gy + jy - 1).clamp(0, h - 1)
        for jx in range(4):
            c = (gx + jx - 1).clamp(0, w - 1)
            out = out + wy[jy] * wx[jx] * _gather(img, r, c)
    return out


def sample_nearest(img: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
                   padding_mode: str = "zeros") -> torch.Tensor:
    """Nearest samples of ``img`` (N, C, H, W) at float pixel coordinates
    (N, *S) -> (N, C, *S), as the JAX function: each coordinate rounded
    half to even, the index clamped to the image; under ``"zeros"``
    padding a sample whose rounded index lies outside the image is 0,
    under ``"border"`` it is the clamped pixel."""
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unsupported padding_mode: {padding_mode}")
    _, _, h, w = img.shape
    yn = torch.round(iy).long()
    xn = torch.round(ix).long()
    out = _gather(img, yn.clamp(0, h - 1), xn.clamp(0, w - 1))
    if padding_mode == "zeros":
        inb = (yn >= 0) & (yn <= h - 1) & (xn >= 0) & (xn <= w - 1)
        out = out * inb.unsqueeze(1).to(out.dtype)
    return out


def dense_image_warp(image: torch.Tensor, flow: torch.Tensor
                     ) -> torch.Tensor:
    """Warp ``image`` (N, C, H, W) by a per-pixel backward flow (N, H, W, 2)
    in (dy, dx) order: ``out[n, :, j, i] = image[n, :, j - dy, i - dx]``,
    bilinear with border clamping (the reference's
    Module2/models/sparse_image_warp.py:220-268)."""
    _, _, h, w = image.shape
    gy = torch.arange(h, dtype=image.dtype, device=image.device)[None, :,
                                                                 None]
    gx = torch.arange(w, dtype=image.dtype, device=image.device)[None, None,
                                                                 :]
    return sample_bilinear(image, gy - flow[..., 0], gx - flow[..., 1])


def grid_sample_features(x: torch.Tensor, grid: torch.Tensor,
                         **kw) -> torch.Tensor:
    """``F.grid_sample`` of features ``x`` at an fp32 ``grid``, in x's
    dtype. A bf16 ``x`` is widened and sampled in fp32, and the samples are
    rounded to bf16 once: the JAX sampler gathers the bf16 features and
    lerps them in bf16 with its fp32 weights rounded to bf16, and
    ``F.grid_sample`` refuses a bf16 input with an fp32 grid."""
    if x.dtype == grid.dtype:
        return F.grid_sample(x, grid, **kw)
    return F.grid_sample(x.to(grid.dtype), grid, **kw).to(x.dtype)


def warp_acc_flow(x: torch.Tensor, flow: torch.Tensor,
                  mask: torch.Tensor | None = None,
                  mask_value: float = -1.0) -> torch.Tensor:
    """Warp by a pixel-space flow (N, 2, H, W) in (dx, dy) order, with the
    reference quirk (Module2/intrinsic_flow_models/modules.py:596-625):
    the grid ``pixel + flow`` is normalized with the align_corners=True
    formula ``2 g / (size - 1) - 1`` and then sampled with
    align_corners=False, zeros padding. Where ``mask`` (N, 1, H, W) is
    <= 0.5 the output is ``mask_value``. The grid is built in the flow's
    dtype (fp32: in bf16, gx + flow ~200 would be off by up to half a
    pixel), whatever x's is."""
    _, _, h, w = x.shape
    gx = torch.arange(w, dtype=flow.dtype, device=x.device)[None, None, :]
    gy = torch.arange(h, dtype=flow.dtype, device=x.device)[None, :, None]
    nx = 2.0 * (gx + flow[:, 0]) / max(w - 1, 1) - 1.0
    ny = 2.0 * (gy + flow[:, 1]) / max(h - 1, 1) - 1.0
    out = grid_sample_features(x, torch.stack([nx, ny], dim=-1),
                               mode="bilinear", padding_mode="zeros",
                               align_corners=False)
    if mask is not None:
        out = torch.where(mask > 0.5, out, torch.full_like(out, mask_value))
    return out
