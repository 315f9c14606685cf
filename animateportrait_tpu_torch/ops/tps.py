"""The renderer's motion grid: host Delaunay + dense barycentric evaluation.
Port of the ``motion_mode="linear"`` path of ``animateportrait_tpu/ops/tps.py``.

``linear_motion_grid`` reproduces scipy ``griddata(method='linear')`` —
the reference's ``cal_motion256`` (umlvdfw_test_dataset.py:67-81) — given
the host triangulation of the same control points. Each pixel takes the
triangle that maximizes its minimum barycentric coordinate; where fp ties
make several triangles maximal (pixels on a shared edge) their
interpolants are averaged, as in the JAX package. The TPU form contracted
a one-hot over triangles on the matrix unit; here the same selection is a
masked sum over the triangle axis.
"""
from __future__ import annotations

import numpy as np
import torch


def ref_edge_anchors_yx(size: int = 256) -> np.ndarray:
    """The reference's 8 border anchors, duplicates included, (y, x),
    scaled from its hardcoded 255 to ``size - 1``."""
    m = float(size - 1)
    return np.array([[0, 0], [m, m], [0, m], [m, 0],
                     [0, m], [m, 0], [m, m], [m, m]], np.float64)


def delaunay_simplices(dest_yx: np.ndarray, pad_to: int = 160) -> np.ndarray:
    """Qhull Delaunay simplices of the control points, (pad_to, 3) int64,
    padded by repeating the first simplex (harmless for the max-min
    containment test). Qhull merges the duplicated anchors as griddata
    does."""
    from scipy.spatial import Delaunay

    tri = Delaunay(np.asarray(dest_yx, np.float64)).simplices
    if tri.shape[0] > pad_to:
        raise ValueError(f"{tri.shape[0]} simplices > pad_to={pad_to}")
    pad = np.broadcast_to(tri[:1], (pad_to - tri.shape[0], 3))
    return np.concatenate([tri, pad], 0).astype(np.int64)


def triangulate_frames(lm_xy: np.ndarray, size: int) -> np.ndarray:
    """Per-frame simplices of [landmarks (y, x); the 8 anchors].
    lm_xy: (T, 68, 2) in (x, y); returns (T, pad_to, 3)."""
    anch = ref_edge_anchors_yx(size)
    return np.stack([
        delaunay_simplices(np.concatenate([f[:, ::-1], anch], 0))
        for f in np.asarray(lm_xy)])


def linear_motion_grid(lm_src: torch.Tensor, lm_dst: torch.Tensor,
                       simplices: torch.Tensor, size: int = 256
                       ) -> torch.Tensor:
    """Backward warp grid (b, size, size, 2), (x, y) order, normalized as
    ``map / ((size-1)/2) - 1``.

    lm_src, lm_dst: (b, 68, 2) landmarks (x, y) in pixels; simplices:
    (b, T, 3) triangulations of [lm_dst (y, x); anchors].
    """
    b = lm_src.shape[0]
    dev = lm_src.device
    anchors = torch.as_tensor(ref_edge_anchors_yx(size), dtype=torch.float32,
                              device=dev).expand(b, 8, 2)
    src = torch.cat([lm_src.flip(-1).float(), anchors], dim=1)  # (b,76,2)
    dst = torch.cat([lm_dst.flip(-1).float(), anchors], dim=1)
    tri = simplices.long()
    bidx = torch.arange(b, device=dev)[:, None, None]
    d = dst[bidx, tri]                         # (b, T, 3, 2) dest vertices
    s = src[bidx, tri]                         # (b, T, 3, 2) source vertices
    e1 = d[:, :, 1] - d[:, :, 0]
    e2 = d[:, :, 2] - d[:, :, 0]
    det = e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]
    degen = torch.abs(det) < 1e-9              # merged-duplicate triangles
    det = torch.where(degen, torch.ones_like(det), det)
    i00 = (e2[..., 1] / det)[..., None]
    i01 = (-e2[..., 0] / det)[..., None]
    i10 = (-e1[..., 1] / det)[..., None]
    i11 = (e1[..., 0] / det)[..., None]

    g = torch.arange(size, dtype=torch.float32, device=dev)
    py = g[:, None].expand(size, size).reshape(1, 1, -1)
    px = g[None, :].expand(size, size).reshape(1, 1, -1)
    # barycentric coordinates in the form relative to vertex 0: the
    # absolute-coordinate form cancels catastrophically in fp32
    rel_y = py - d[:, :, 0, 0, None]           # (b, T, hw)
    rel_x = px - d[:, :, 0, 1, None]
    l1 = i00 * rel_y + i01 * rel_x
    l2 = i10 * rel_y + i11 * rel_x
    l0 = 1.0 - l1 - l2
    minb = torch.minimum(l0, torch.minimum(l1, l2))
    minb = torch.where(degen[..., None], torch.full_like(minb, -torch.inf),
                       minb)
    best = torch.max(minb, dim=1, keepdim=True).values
    sel = (minb >= best).float()
    sel = sel / sel.sum(dim=1, keepdim=True)
    out = []
    for j in range(2):                         # y, then x
        v = (l0 * s[:, :, 0, j, None] + l1 * s[:, :, 1, j, None]
             + l2 * s[:, :, 2, j, None])
        out.append((sel * v).sum(dim=1))       # (b, hw)
    grid = torch.stack([out[1], out[0]], dim=-1).reshape(b, size, size, 2)
    return grid / ((size - 1) / 2.0) - 1.0
