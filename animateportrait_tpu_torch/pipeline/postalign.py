"""Post-render stabilization: track one feature point, counter-shift frames.
Port of ``animateportrait_tpu/pipeline/postalign.py`` (reference:
``Module1/util/postalign.py``), which stabilizes a rendered talking-head
video by (1) picking the strongest Shi-Tomasi corner in a mask region
(``goodFeaturesToTrack``, keeping p0[0:1]), (2) tracking it with pyramidal
Lucas-Kanade (winSize 15, maxLevel 2, 10 iterations / eps 0.03), and (3)
shifting every frame by (first position - current position) with a
reflect boundary (``scipy.ndimage.shift(mode='reflect')``).

All three stages run on tensors of one device: the min-eigenvalue corner
response, an iterative LK with Scharr derivatives and bilinear sampling,
and a bilinear reflect shift of every frame at once. The small filters
(3x3 Scharr and box, the 5-tap pyramid) are sums of shifted planes in
fp32, not convolutions: the card's convolutions may run in TF32, and the
elementwise sums give the same values on the card and the host. The LK
windows, their sums and the tracked point are float64 (``_track``), so
the card and the host track alike over a whole clip. ``postalign_video``
builds every frame's pyramid and derivatives in one batch, tracks the
point from frame to frame with no host synchronization (each LK level
runs its ``iters`` iterations and freezes the flow once a step is below
``eps``, which gives what stopping would; on the card one frame's LK is a
CUDA graph, replayed for each frame), and shifts all frames in one batch.
"""
from __future__ import annotations

import numpy as np
import torch

from animateportrait_tpu_torch.utils.device import (
    DEFAULT_DEVICE, resolve_device)


def rgb_to_gray(frame: torch.Tensor) -> torch.Tensor:
    """ITU-R BT.601 luma, matching cv2.cvtColor COLOR_RGB2GRAY."""
    return (0.299 * frame[..., 0] + 0.587 * frame[..., 1]
            + 0.114 * frame[..., 2])


def _conv2_same(img: torch.Tensor, kern: np.ndarray) -> torch.Tensor:
    """Correlation of (..., H, W) with a small kernel, reflect-101 border
    (cv2's default; numpy's and torch's "reflect"), as a sum of shifted
    planes in the order of the kernel's rows and columns."""
    kh, kw = kern.shape
    h, w = img.shape[-2:]
    lead = img.shape[:-2]
    x = img.reshape(-1, 1, h, w)
    x = torch.nn.functional.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2),
                                mode="reflect").reshape(*lead, h + kh - 1,
                                                        w + kw - 1)
    out = None
    for i in range(kh):
        for j in range(kw):
            term = float(kern[i, j]) * x[..., i:i + h, j:j + w]
            out = term if out is None else out + term
    return out


def scharr_derivatives(gray: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """3x3 Scharr dx/dy (OpenCV's LK derivative filter, /32 normalized)."""
    d = np.array([-1.0, 0.0, 1.0])
    s = np.array([3.0, 10.0, 3.0]) / 32.0
    return _conv2_same(gray, np.outer(s, d)), _conv2_same(gray, np.outer(d, s))


def corner_response(gray: torch.Tensor, block: int = 3) -> torch.Tensor:
    """Shi-Tomasi min-eigenvalue response (cv2.goodFeaturesToTrack's
    score): lambda_min of the blockSize-summed structure tensor."""
    ix, iy = scharr_derivatives(gray)
    k = np.ones((block, block))
    sxx = _conv2_same(ix * ix, k)
    syy = _conv2_same(iy * iy, k)
    sxy = _conv2_same(ix * iy, k)
    tr = (sxx + syy) * 0.5
    det = torch.sqrt(torch.square((sxx - syy) * 0.5) + torch.square(sxy))
    return tr - det


def good_feature(gray: torch.Tensor, mask: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """(x, y) of the strongest corner inside ``mask`` (p0[0:1] of the
    reference's goodFeaturesToTrack call): the first maximum in raster
    order."""
    resp = corner_response(gray)
    if mask is not None:
        resp = torch.where(mask > 0, resp, torch.full_like(resp, -np.inf))
    idx = torch.argmax(resp.reshape(-1))
    w = gray.shape[-1]
    return torch.stack([idx % w, idx // w]).to(torch.float32)


def _pyr_down(gray: torch.Tensor) -> torch.Tensor:
    """cv2.pyrDown: 5-tap [1,4,6,4,1]/16 gaussian then 2x decimate."""
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    g = _conv2_same(_conv2_same(gray, k[None, :]), k[:, None])
    return g[..., ::2, ::2]


def _sample_window(img: torch.Tensor, center: torch.Tensor, half: int
                   ) -> torch.Tensor:
    """Bilinear (2*half+1)^2 window around a float center, clamped, in the
    center's dtype."""
    n = 2 * half + 1
    offs = torch.arange(n, dtype=center.dtype, device=img.device) - half
    xs = center[0] + offs[None, :]
    ys = center[1] + offs[:, None]
    h, w = img.shape
    x0 = torch.clamp(torch.floor(xs), 0, w - 2)
    y0 = torch.clamp(torch.floor(ys), 0, h - 2)
    fx = torch.clamp(xs - x0, 0.0, 1.0).expand(n, n)
    fy = torch.clamp(ys - y0, 0.0, 1.0).expand(n, n)
    x0 = x0.to(torch.int64).expand(n, n)
    y0 = y0.to(torch.int64).expand(n, n)
    v00 = img[y0, x0].to(center.dtype)
    v01 = img[y0, x0 + 1].to(center.dtype)
    v10 = img[y0 + 1, x0].to(center.dtype)
    v11 = img[y0 + 1, x0 + 1].to(center.dtype)
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def _lk_level(prev, nxt, ix, iy, pt_prev, guess, half, iters, eps):
    """Iterative LK at one pyramid level; returns the refined flow. Each
    of the ``iters`` iterations keeps the flow once its step is below
    ``eps`` (the same flow gives the same step again), so no iteration
    waits for the device to decide whether to stop."""
    tpl = _sample_window(prev, pt_prev, half)
    gx = _sample_window(ix, pt_prev, half)
    gy = _sample_window(iy, pt_prev, half)
    gxx = torch.sum(gx * gx)
    gxy = torch.sum(gx * gy)
    gyy = torch.sum(gy * gy)
    det = gxx * gyy - gxy * gxy
    ok = det != 0
    zero = torch.zeros_like(det)
    inv = [torch.where(ok, v / det, zero) for v in (gyy, -gxy, gxx)]
    flow = guess
    for _ in range(iters):
        cur = _sample_window(nxt, pt_prev + flow, half)
        diff = cur - tpl
        b0 = torch.sum(diff * gx)
        b1 = torch.sum(diff * gy)
        delta = -torch.stack([inv[0] * b0 + inv[1] * b1,
                              inv[1] * b0 + inv[2] * b1])
        small = torch.sum(torch.square(delta)) < eps * eps
        flow = torch.where(small, flow, flow + delta)
    return flow


def _pyramid(gray: torch.Tensor, levels: int) -> list[torch.Tensor]:
    out = [gray.to(torch.float32)]
    for _ in range(levels - 1):
        out.append(_pyr_down(out[-1]))
    return out


def _track(prevs, nexts, derivs, pt, win, iters, eps):
    """Pyramidal LK of ``pt`` (float64) from the ``prevs`` to the ``nexts``
    pyramid, with each prev level's Scharr derivatives ``derivs``. The
    windows, their sums and the flow are float64: fp32 sums in another
    order (the card's against the host's) move a step across the ``eps``
    threshold now and then, and a tracked point then drifts from frame to
    frame by up to a few eps."""
    half = win // 2
    flow = torch.zeros(2, dtype=pt.dtype, device=pt.device)
    for lvl in range(len(prevs) - 1, -1, -1):
        ix, iy = derivs[lvl]
        flow = _lk_level(prevs[lvl], nexts[lvl], ix, iy, pt / (2 ** lvl),
                         flow, half, iters, eps)
        if lvl > 0:
            flow = flow * 2.0
    return pt + flow


def track_point(prev_gray: torch.Tensor, next_gray: torch.Tensor,
                pt: torch.Tensor, win: int = 15, levels: int = 3,
                iters: int = 10, eps: float = 0.03) -> torch.Tensor:
    """Pyramidal LK: position (float32) of ``pt`` (x, y) in ``next_gray``.

    Mirrors cv2.calcOpticalFlowPyrLK(winSize=(15,15), maxLevel=2,
    criteria=(COUNT|EPS, 10, 0.03)) for a single point.
    """
    prevs = _pyramid(prev_gray, levels)
    nexts = _pyramid(next_gray, levels)
    derivs = [scharr_derivatives(p) for p in prevs]
    return _track(prevs, nexts, derivs, pt.to(torch.float64), win, iters,
                  eps).to(torch.float32)


def shift_reflect(img: torch.Tensor, shift_yx: torch.Tensor) -> torch.Tensor:
    """Sub-pixel image shift with reflect boundary, bilinear resampling:
    ``scipy.ndimage.shift(img, [dy, dx, 0], order=1, mode='reflect')``.
    ``img`` (H, W[, C]), or a batch (N, H, W[, C]) with ``shift_yx``
    (N, 2)."""
    batched = shift_yx.ndim == 2
    x = img if batched else img[None]
    s = shift_yx if batched else shift_yx[None]
    h, w = x.shape[1], x.shape[2]
    dev = x.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None] - s[:, :1]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None] - s[:, 1:]

    def fold(i, n):
        # scipy 'reflect' boundary (d c b a | a b c d | d c b a): period 2n
        j = torch.remainder(i, 2 * n)
        return torch.where(j >= n, 2 * n - 1 - j, j)

    def gather_axis(coords, n):
        c0 = torch.floor(coords).to(torch.int64)
        return fold(c0, n), fold(c0 + 1, n), coords - c0

    y0, y1, fy = gather_axis(ys, h)
    x0, x1, fx = gather_axis(xs, w)
    t = torch.arange(x.shape[0], device=dev)[:, None, None]
    extra = (None,) * (x.ndim - 3)
    fy = fy[(slice(None), slice(None), None) + extra]
    fx = fx[(slice(None), None, slice(None)) + extra]
    y0, y1 = y0[:, :, None], y1[:, :, None]
    x0, x1 = x0[:, None, :], x1[:, None, :]
    v00, v01 = x[t, y0, x0], x[t, y0, x1]
    v10, v11 = x[t, y1, x0], x[t, y1, x1]
    out = (v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx
           + v10 * fy * (1 - fx) + v11 * fy * fx)
    if not img.dtype.is_floating_point:
        out = out.to(img.dtype)
    return out if batched else out[0]


def _frame_tracker(pyr, derivs, dev: torch.device):
    """``track(i, pt)``: ``pt`` tracked from frame ``i`` to frame ``i + 1``
    of the batched pyramid ``pyr`` (with its derivatives ``derivs``). On
    the card the ~1000 small kernels of one frame's LK run as one captured
    CUDA graph, replayed for each frame (the frame's index and the point
    are copied into the graph's inputs); on the CPU, eagerly."""
    def track_eager(i, pt):
        return _track([p[i] for p in pyr], [p[i + 1] for p in pyr],
                      [(ix[i], iy[i]) for ix, iy in derivs], pt, 15, 10, 0.03)

    if dev.type != "cuda":
        return track_eager
    idx = torch.zeros(1, dtype=torch.int64, device=dev)
    pt_in = torch.zeros(2, dtype=torch.float64, device=dev)

    def body():
        sel = [(p.index_select(0, idx)[0], p.index_select(0, idx + 1)[0])
               for p in pyr]
        grads = [(ix.index_select(0, idx)[0], iy.index_select(0, idx)[0])
                 for ix, iy in derivs]
        return _track([a for a, _ in sel], [b for _, b in sel], grads,
                      pt_in, 15, 10, 0.03)

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        body()                              # warm-up before the capture
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = body()

    def track_graph(i, pt):
        idx.fill_(i)
        pt_in.copy_(pt)
        graph.replay()
        return out.clone()

    return track_graph


def postalign_video(frames: np.ndarray,
                    mask_region: tuple[int, int] = (-50, 128),
                    device: torch.device | str = DEFAULT_DEVICE,
                    return_points: bool = False):
    """Stabilize a rendered clip the way the reference script does.

    frames: (T, H, W, 3) uint8/float RGB. The corner is picked in
    frames[1] inside rows[mask_region[0]:], cols[mask_region[1]:]; frames
    [2:] are tracked against their predecessor and counter-shifted to the
    first tracked position. Returns the stabilized frames[2:] (the script
    writes exactly those), rounded and clipped to uint8 for a uint8 clip;
    with ``return_points`` also the (T - 2, 2) tracked (x, y) positions.
    """
    frames = np.asarray(frames)
    t, h, w = frames.shape[:3]
    if t < 3:
        return (frames[2:], np.zeros((0, 2), np.float32)) \
            if return_points else frames[2:]
    dev = resolve_device(device)
    x = torch.as_tensor(frames, device=dev).to(torch.float32)
    grays = rgb_to_gray(x)
    mask = torch.zeros((h, w), dtype=torch.float32, device=dev)
    mask[mask_region[0]:, mask_region[1]:] = 1.0
    pt = good_feature(grays[1], mask)

    # every frame's pyramid and the derivatives of every level, in batches
    pyr = _pyramid(grays, 3)
    derivs = [scharr_derivatives(p) for p in pyr]
    track = _frame_tracker(pyr, derivs, dev)
    pt = pt.to(torch.float64)
    ori = torch.full((2,), np.nan, dtype=torch.float64, device=dev)
    points = []
    for i in range(1, t - 1):
        new_pt = track(i, pt)
        ori = torch.where(torch.any(torch.isnan(ori)), new_pt, ori)
        points.append(torch.stack([ori[1] - new_pt[1], ori[0] - new_pt[0]]))
        points.append(new_pt)
        pt = new_pt
    shifts = torch.stack(points[0::2]).to(torch.float32)
    out = shift_reflect(x[2:], shifts)
    if frames.dtype == np.uint8:
        out = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    out = out.cpu().numpy()
    if return_points:
        return out, torch.stack(points[1::2]).cpu().numpy()
    return out
