"""Image warping, NCHW. Port of ``animateportrait_tpu/ops/warp.py``.

The JAX ``grid_sample`` reproduces ``F.grid_sample`` (both corner
conventions, zeros or border padding), so the port calls that operator
directly; the TPU gather workarounds (``_aug4``, ``_gather_chunk``) have no
counterpart. What stays is the reference's flow-warp quirk.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def warp_acc_flow(x: torch.Tensor, flow: torch.Tensor,
                  mask: torch.Tensor | None = None,
                  mask_value: float = -1.0) -> torch.Tensor:
    """Warp by a pixel-space flow (N, 2, H, W) in (dx, dy) order, with the
    reference quirk (Module2/intrinsic_flow_models/modules.py:596-625):
    the grid ``pixel + flow`` is normalized with the align_corners=True
    formula ``2 g / (size - 1) - 1`` and then sampled with
    align_corners=False, zeros padding. Where ``mask`` (N, 1, H, W) is
    <= 0.5 the output is ``mask_value``."""
    _, _, h, w = x.shape
    gx = torch.arange(w, dtype=x.dtype, device=x.device)[None, None, :]
    gy = torch.arange(h, dtype=x.dtype, device=x.device)[None, :, None]
    nx = 2.0 * (gx + flow[:, 0]) / max(w - 1, 1) - 1.0
    ny = 2.0 * (gy + flow[:, 1]) / max(h - 1, 1) - 1.0
    out = F.grid_sample(x, torch.stack([nx, ny], dim=-1), mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    if mask is not None:
        out = torch.where(mask > 0.5, out, torch.full_like(out, mask_value))
    return out
