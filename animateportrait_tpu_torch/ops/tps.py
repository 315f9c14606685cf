"""Motion grids and TPS warps. Port of ``animateportrait_tpu/ops/tps.py``.

The renderer's motion grid: host Delaunay + dense barycentric evaluation
(the ``motion_mode="linear"`` path).

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

from animateportrait_tpu_torch.ops.warp import dense_image_warp
from animateportrait_tpu_torch.utils.device import device_constant

_EPS = 1e-10


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
    anchors = device_constant(
        f"ref_edge_anchors_yx_{size}",
        lambda: ref_edge_anchors_yx(size).astype(np.float32),
        dev).expand(b, 8, 2)
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


# --- polyharmonic splines (the training step's TPS warps) -----------------
#
# The reference's sparse_image_warp (Module2/models/sparse_image_warp.py:
# 36-217). As in the JAX package: squared distances by explicit differences
# (the matmul form cancels in fp32 and the log amplifies it), control points
# normalized to unit scale before the (n+3)^2 solve, and a 1e-6 ridge, which
# keep the fp32 solve stable where coincident landmarks (a closed mouth)
# make the pixel-scale system singular.


def _phi(r2: torch.Tensor, order: int) -> torch.Tensor:
    """Polyharmonic radial basis on squared distances ``r2``."""
    if order == 1:
        return torch.sqrt(torch.clamp(r2, min=_EPS))
    if order == 2:
        return 0.5 * r2 * torch.log(torch.clamp(r2, min=_EPS))
    if order == 4:
        return 0.5 * r2 * r2 * torch.log(torch.clamp(r2, min=_EPS))
    r2 = torch.clamp(r2, min=_EPS)
    if order % 2 == 0:
        return 0.5 * torch.pow(r2, 0.5 * order) * torch.log(r2)
    return torch.pow(r2, 0.5 * order)


def _cross_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared distances between rows of x (..., n, d) and y (..., m, d)."""
    diff = x[..., :, None, :] - y[..., None, :, :]
    return torch.sum(diff * diff, dim=-1)


def solve_spline(train_points: torch.Tensor, train_values: torch.Tensor,
                 order: int = 2, regularization_weight: float = 0.0
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fit a polyharmonic spline, batched: points (b, n, d), values
    (b, n, k) -> RBF weights (b, n, k) and affine weights (b, d+1, k)."""
    b, n, d = train_points.shape
    k = train_values.shape[-1]
    c = train_points.float()
    f = train_values.float()
    matrix_a = _phi(_cross_sqdist(c, c), order)
    if regularization_weight > 0.0:
        matrix_a = matrix_a + regularization_weight * torch.eye(
            n, dtype=c.dtype, device=c.device)
    matrix_b = torch.cat([c, torch.ones_like(c[..., :1])], dim=2)
    left = torch.cat([matrix_a, matrix_b.transpose(1, 2)], dim=1)
    right = torch.cat([matrix_b, c.new_zeros((b, d + 1, d + 1))], dim=1)
    lhs = torch.cat([left, right], dim=2)
    rhs = torch.cat([f, f.new_zeros((b, d + 1, k))], dim=1)
    # the LU solve of ``torch.linalg.solve`` without its check of the
    # result, which reads it on the host: the step's CUDA graph takes it
    sol = torch.linalg.solve_ex(lhs, rhs).result
    return sol[:, :n], sol[:, n:]


def apply_spline(query_points: torch.Tensor, train_points: torch.Tensor,
                 w: torch.Tensor, v: torch.Tensor, order: int = 2
                 ) -> torch.Tensor:
    """Evaluate a fitted spline at ``query_points`` (b, m, d) -> (b, m, k)."""
    q = query_points.float()
    rbf = torch.matmul(_phi(_cross_sqdist(q, train_points.float()), order), w)
    qp = torch.cat([q, torch.ones_like(q[..., :1])], dim=-1)
    return rbf + torch.matmul(qp, v)


def interpolate_spline(train_points: torch.Tensor,
                       train_values: torch.Tensor,
                       query_points: torch.Tensor, order: int = 2,
                       regularization_weight: float = 1e-6) -> torch.Tensor:
    """Fit and evaluate, on coordinates normalized to unit scale."""
    tp = train_points.float()
    center = tp.mean(dim=1, keepdim=True)
    scale = torch.clamp(tp.std(dim=(1, 2), keepdim=True, correction=0),
                        min=1e-3)
    tpn = (tp - center) / scale
    qpn = (query_points.float() - center) / scale
    w, v = solve_spline(tpn, train_values, order, regularization_weight)
    return apply_spline(qpn, tpn, w, v, order)


def sparse_image_warp(image: torch.Tensor,
                      source_control_points: torch.Tensor,
                      dest_control_points: torch.Tensor, order: int = 2
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Warp ``image`` (N, C, H, W) so the dest control points show the
    source content; control points (N, n, 2) in (y, x) pixels. Returns
    (warped image (N, C, H, W), dense flows (N, H, W, 2) in (dy, dx))."""
    n, _, h, w = image.shape
    dev = image.device
    flows = dest_control_points - source_control_points
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    grid = torch.stack([gy, gx], dim=-1).reshape(1, h * w, 2).expand(
        n, h * w, 2)
    flat = interpolate_spline(dest_control_points.float(), flows.float(),
                              grid, order)
    dense = flat.reshape(n, h, w, 2)
    return dense_image_warp(image, dense), dense


def tps_edge_anchors(size: int) -> np.ndarray:
    """The 4 corners and 4 edge midpoints that pin a TPS motion grid at the
    border, (y, x) (the reference's duplicated griddata anchors would make
    the spline system singular)."""
    m = float(size - 1)
    h = m / 2.0
    return np.array([[0, 0], [m, m], [0, m], [m, 0], [0, h], [h, 0], [m, h],
                     [h, m]], np.float32)


def motion_grid_from_landmarks(lm_src: torch.Tensor, lm_dst: torch.Tensor,
                               size: int = 256) -> torch.Tensor:
    """Backward warp grid (b, size, size, 2), (x, y) order, normalized as
    ``map / ((size-1)/2) - 1``, from a TPS of the dst -> src landmark
    correspondence; lm_src, lm_dst (b, 68, 2) in (x, y) pixels."""
    b = lm_src.shape[0]
    dev = lm_src.device
    anchors = device_constant(f"tps_edge_anchors_{size}",
                              lambda: tps_edge_anchors(size), dev).expand(
        b, 8, 2)
    dest = torch.cat([lm_dst.flip(-1).float(), anchors], dim=1)
    source = torch.cat([lm_src.flip(-1).float(), anchors], dim=1)
    g = torch.arange(size, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(g, g, indexing="ij")
    query = torch.stack([gy, gx], dim=-1).reshape(1, size * size, 2).expand(
        b, size * size, 2)
    mapped = interpolate_spline(dest, source, query, order=2).reshape(
        b, size, size, 2)
    grid = torch.stack([mapped[..., 1], mapped[..., 0]], dim=-1)
    return grid / ((size - 1) / 2.0) - 1.0
