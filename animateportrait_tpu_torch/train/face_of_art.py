"""The face_of_art heatmap-net trainer and its artistic augmentation. Port
of ``animateportrait_tpu/train/face_of_art.py`` (the reference's
Module1/thirdparty/face_of_art/{deformation_functions,menpo_functions,
data_loading_functions,deep_heatmaps_model_fusion_net}.py):

- the geometric artistic deformation of 68-point landmarks: host numpy,
  the JAX package's code kept as a copy, the same draws from the same
  ``np.random.Generator``;
- the augmentation stack texture -> geometric -> basic: the geometric
  warp through ``ops/tps.py:sparse_image_warp`` on a device; the basic
  one's rotation through ``utils/image.py:warp_affine`` (OpenCV 5.0's
  ``warpAffine``, byte-equal) and its resize through
  ``resize_linear_float``;
- the approximate gaussian ground-truth maps at full and quarter
  resolution, fp32 (the JAX package's steps);
- ``FOATrainer``: the L2 primary / fusion / upsample step, with the
  ``reg`` term over every non-bias leaf, and ``optax.adam`` (or SGD with
  momentum) under a staircase exponential decay: the same optimizer with
  ``StepLR(lr_step, gamma)`` stepped after each update;
- ``nme_norm_eyes``, ``evaluate_foa`` and ``train_foa`` (checkpoints
  through ``io/checkpoint.py``).

Maps and images are NCHW on the net's side; the host-side items are (S, S,
3) images and (68, 2) (y, x) landmarks. No kernel of the port lies on
this path.
"""
from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np
import torch

from animateportrait_tpu_torch.data.umlvd_ifw import FLIP_REMAP
from animateportrait_tpu_torch.models.face_of_art import (
    ArtisticHeatmapNet, heatmaps_to_landmarks_yx)
from animateportrait_tpu_torch.train.optim import adam
from animateportrait_tpu_torch.utils.device import (
    DEFAULT_DEVICE, resolve_device)
from animateportrait_tpu_torch.utils.image import (
    read_image, resize_linear_float, rotation_matrix_2d, warp_affine)


# ibug-68 part index groups (menpo_functions.py:12-20)
JAW = np.arange(0, 17)
LBROW = np.arange(17, 22)
RBROW = np.arange(22, 27)
NOSE = np.arange(27, 36)
LEYE = np.arange(36, 42)
REYE = np.arange(42, 48)
MOUTH = np.arange(48, 68)


# --------------------------------------------------------------------
# geometric artistic deformation (deformation_functions.py)
# all landmark arrays are (68, 2) in menpo (y, x) pixel order
# --------------------------------------------------------------------

def deform_part(lms: np.ndarray, inds: np.ndarray, scale_y: float = 1.0,
                scale_x: float = 1.0, shift_ver: float = 0.0,
                shift_horiz: float = 0.0) -> np.ndarray:
    """Scale a part about its own mean, then translate it
    (deformation_functions.py:4-20)."""
    part = lms[inds].astype(np.float64)
    mean = part.mean(0)
    part = (part - mean) * np.array([scale_y, scale_x]) + mean
    part = part + np.array([shift_ver, shift_horiz])
    out = lms.copy()
    out[inds] = part
    return out


def _part_bounds(lms: np.ndarray) -> np.ndarray:
    """[[x_min, x_max], [y_min, y_max]] of a point set
    (deformation_functions.py:363-366)."""
    ymin, xmin = lms.min(0)
    ymax, xmax = lms.max(0)
    return np.array([[xmin, xmax], [ymin, ymax]])


def check_deformation_spatial_errors(def_lms: np.ndarray,
                                     inds: np.ndarray,
                                     pad: int = 0) -> bool:
    """True when any *other* landmark falls strictly inside the
    (rounded, pad-shrunk) bounding box of the deformed part
    (deformation_functions.py:369-386)."""
    part = def_lms[inds]
    others = np.round(np.delete(def_lms, inds, axis=0).reshape(-1, 2))
    b = np.round(_part_bounds(part))
    b[:, 0] += pad
    b[:, 1] -= pad
    in_y = (others[:, 0] > b[1, 0]) & (others[:, 0] < b[1, 1])
    in_x = (others[:, 1] > b[0, 0]) & (others[:, 1] < b[0, 1])
    return bool(np.any(in_y & in_x))


def _scale_about_mean(lms, inds, rng, lo, x_lim, y_lim, cap,
                      err_ind_groups, pad, scale_x_range=None):
    """Shared scale machinery: draw (scale_y, scale_x) so the scaled
    part stays inside the [y_lim, x_lim] = (min, max) corridors, apply,
    and revert on a spatial-error check. ``scale_x_range`` overrides the
    corridor-derived x cap (the nose draws scale_x ~ U(0.7, 1.5)
    outright, deformation_functions.py:131)."""
    part = lms[inds]
    mean = part.mean(0)
    rel = part - mean
    ry0, rx0 = rel.min(0)
    ry1, rx1 = rel.max(0)
    smax_y = min((y_lim[0] - mean[0]) / ry0, (y_lim[1] - mean[0]) / ry1)
    if cap is not None:
        smax_y = min(smax_y, cap)
    scale_y = rng.uniform(lo, smax_y)
    if scale_x_range is not None:
        scale_x = rng.uniform(*scale_x_range)
    else:
        smax_x = min((x_lim[0] - mean[1]) / rx0,
                     (x_lim[1] - mean[1]) / rx1)
        if cap is not None:
            smax_x = min(smax_x, cap)
        scale_x = rng.uniform(lo, smax_x)
    out = deform_part(lms, inds, scale_y=scale_y, scale_x=scale_x)
    if any(check_deformation_spatial_errors(out, g, pad=pad)
           for g in err_ind_groups):
        return lms.copy()
    return out


def _shift_within(lms, inds, rng, x_lim, y_lim, err_ind_groups, pad,
                  x_bound_rows=None):
    """Shared shift machinery: draw a translation keeping the part's
    bounds inside the corridors, apply, revert on error.
    ``x_bound_rows`` restricts which rows define the part's x extent
    (the nose uses only its 4 bridge points — the reference's
    2-vector-bound quirk at deformation_functions.py:150-156 reduces to
    exactly this, since the [0]-component of its uniform draw is
    multiplied away in deform_part)."""
    part = lms[inds]
    mean = part.mean(0)
    rel = part - mean
    ry0, ry1 = rel[:, 0].min(), rel[:, 0].max()
    xr = rel if x_bound_rows is None else rel[x_bound_rows]
    rx0, rx1 = xr[:, 1].min(), xr[:, 1].max()
    shift_x = rng.uniform(x_lim[0] - (mean[1] + rx0),
                          x_lim[1] - (mean[1] + rx1))
    shift_y = rng.uniform(y_lim[0] - (mean[0] + ry0),
                          y_lim[1] - (mean[0] + ry1))
    out = deform_part(lms, inds, shift_ver=shift_y, shift_horiz=shift_x)
    if any(check_deformation_spatial_errors(out, g, pad=pad)
           for g in err_ind_groups):
        return lms.copy()
    return out


def deform_mouth(lms: np.ndarray, rng: np.random.Generator,
                 p_scale: float = 0.0, p_shift: float = 0.0,
                 pad: int = 5) -> np.ndarray:
    """deformation_functions.py:23-95."""
    jaw_mid = lms[JAW[4:-4]]
    x_max = (lms[MOUTH, 1].max()
             + (jaw_mid[:, 1].max() - lms[MOUTH, 1].max()) * 0.5 - pad)
    x_min = (jaw_mid[:, 1].min()
             + (lms[MOUTH, 1].min() - jaw_mid[:, 1].min()) * 0.5 + pad)
    y_min = (lms[NOSE, 0].max()
             + (lms[MOUTH, 0].min() - lms[NOSE, 0].max()) * 0.5)
    max_jaw = min(lms[JAW, 0].max(), lms[8, 0])
    y_max = max_jaw - (max_jaw - lms[MOUTH, 0].max()) * 0.5 - pad

    scale_draw = rng.random()
    out = lms.copy()
    if p_scale > 0.5 and scale_draw > 0.5:
        out = _scale_about_mean(out, MOUTH, rng, 0.7, (x_min, x_max),
                                (y_min, y_max), 1.2, [MOUTH], pad)
    if p_shift > 0.5 and (rng.random() > 0.5 or not scale_draw):
        out = _shift_within(out, MOUTH, rng, (x_min, x_max),
                            (y_min, y_max), [MOUTH], pad)
    return out


def deform_nose(lms: np.ndarray, rng: np.random.Generator,
                p_scale: float = 0.0, p_shift: float = 0.0,
                pad: int = 5) -> np.ndarray:
    """deformation_functions.py:98-170. Bridge = nose[:4]; error checks
    split bridge/base; y_max keeps the reference's degenerate
    ``+ (...) * 0`` term (:115)."""
    bridge, base = NOSE[:4], NOSE[4:]
    x_max = (lms[bridge, 1].max()
             + (lms[REYE, 1].min() - lms[bridge, 1].max()) * 0.5 - pad)
    x_min = (lms[LEYE, 1].max()
             + (lms[bridge, 1].min() - lms[LEYE, 1].max()) * 0.5 + pad)
    max_brows = lms[21:23, 0].max()
    y_min = (lms[NOSE, 0].min()
             + (max_brows - lms[NOSE, 0].min()) * 0.5)
    y_max = lms[NOSE, 0].max() - pad

    scale_draw = rng.random()
    out = lms.copy()
    if p_scale > 0.5 and scale_draw > 0.5:
        out = _scale_about_mean(out, NOSE, rng, 0.7, None,
                                (y_min, y_max), None, [bridge, base],
                                pad, scale_x_range=(0.7, 1.5))
    if p_shift > 0.5 and (rng.random() > 0.5 or not scale_draw):
        out = _shift_within(out, NOSE, rng, (x_min, x_max),
                            (y_min, y_max), [bridge, base], pad,
                            x_bound_rows=slice(0, 4))
    return out


def deform_eyes(lms: np.ndarray, rng: np.random.Generator,
                p_scale: float = 0.0, p_shift: float = 0.0,
                pad: int = 10) -> np.ndarray:
    """deformation_functions.py:172-303: both eye+brow groups scale by
    one shared factor (the min of the two sides' corridors, capped at
    1.5); shifts are drawn per side."""
    right = np.hstack([RBROW, REYE])
    left = np.hstack([LBROW, LEYE])

    def corridors(part_inds, side):
        if side == "right":
            x_max = (lms[part_inds, 1].max()
                     + (lms[16, 1] - lms[part_inds, 1].max()) * 0.5 - pad)
            x_min = (lms[NOSE[:4], 1].max()
                     + (lms[part_inds, 1].min()
                        - lms[NOSE[:4], 1].max()) * 0.5 + pad)
        else:
            x_max = (lms[part_inds, 1].max()
                     + (lms[NOSE[:4], 1].min()
                        - lms[part_inds, 1].max()) * 0.5 - pad)
            x_min = (lms[0, 1]
                     + (lms[part_inds, 1].min() - lms[0, 1]) * 0.5 + pad)
        y_max = (lms[part_inds, 0].max()
                 + (lms[33, 0] - lms[part_inds, 0].max()) * 0.25 - pad)
        y_min = 2 * pad
        return (x_min, x_max), (y_min, y_max)

    (xr, yr) = corridors(right, "right")
    (xl, yl) = corridors(left, "left")

    def side_caps(part_inds, x_lim, y_lim):
        part = lms[part_inds]
        mean = part.mean(0)
        rel = part - mean
        ry0, rx0 = rel.min(0)
        ry1, rx1 = rel.max(0)
        sy = min((y_lim[0] - mean[0]) / ry0,
                 (y_lim[1] - mean[0]) / ry1, 1.5)
        sx = min((x_lim[0] - mean[1]) / rx0,
                 (x_lim[1] - mean[1]) / rx1, 1.5)
        return sy, sx

    scale_draw = rng.random()
    out = lms.copy()
    if p_scale > 0.5 and scale_draw > 0.5:
        sy_r, sx_r = side_caps(right, xr, yr)
        sy_l, sx_l = side_caps(left, xl, yl)
        scale_y = rng.uniform(0.8, min(sy_l, sy_r))
        scale_x = rng.uniform(0.8, min(sx_l, sx_r))
        cand = deform_part(out, right, scale_y=scale_y, scale_x=scale_x)
        cand = deform_part(cand, left, scale_y=scale_y, scale_x=scale_x)
        err = (check_deformation_spatial_errors(cand, right, pad=pad)
               or check_deformation_spatial_errors(cand, left, pad=pad))
        out = out if err else cand

    if p_shift > 0.5 and (rng.random() > 0.5 or not scale_draw):
        # post-scale y floor (deformation_functions.py:261-262)
        yr2 = (max(0.8 * out[right, 0].min(), pad), yr[1])
        yl2 = (max(0.8 * out[left, 0].min(), pad), yl[1])
        out = _shift_within(out, right, rng, xr, yr2, [right], pad)
        out = _shift_within(out, left, rng, xl, yl2, [left], pad)
    return out


def deform_scale_face(lms: np.ndarray, rng: np.random.Generator,
                      p_scale: float = 0.0, pad: int = 5,
                      image_size: int = 256) -> np.ndarray:
    """Whole-face scale / aspect change (deformation_functions.py:306-350).
    Error rule differs from the parts: any coordinate out of the canvas,
    or two landmarks landing on the same integer pixel."""
    if not p_scale > 0.5:
        return lms.copy()
    all_inds = np.arange(68)
    x_max = (lms[:, 1].max()
             + (image_size - lms[:, 1].max()) * 0.5 - pad)
    x_min = lms[:, 1].min() * 0.5 + pad
    y_min = 2 * pad
    y_max = (lms[:, 0].max()
             + (image_size - lms[:, 0].max()) * 0.5 - pad)

    mean = lms.mean(0)
    rel = lms - mean
    ry0, rx0 = rel.min(0)
    ry1, rx1 = rel.max(0)
    smax_y = min((y_min - mean[0]) / ry0, (y_max - mean[0]) / ry1, 1.2)
    smax_x = min((x_min - mean[1]) / rx0, (x_max - mean[1]) / rx1, 1.2)
    out = deform_part(lms, all_inds, scale_y=rng.uniform(0.6, smax_y),
                      scale_x=rng.uniform(0.6, smax_x))
    oob = np.sum(out >= image_size) + np.sum(out < 0)
    dup = len(np.unique(out.astype(int), axis=0)) != len(out)
    return lms.copy() if (oob or dup) else out


def deform_face_geometric_style(lms: np.ndarray,
                                rng: np.random.Generator,
                                p_scale: float = 0.0,
                                p_shift: float = 0.0) -> np.ndarray:
    """Full geometric-style chain, all pads forced to 0
    (deformation_functions.py:353-360)."""
    out = deform_scale_face(lms.copy(), rng, p_scale=p_scale, pad=0)
    out = deform_nose(out, rng, p_scale=p_scale, p_shift=p_shift, pad=0)
    out = deform_mouth(out, rng, p_scale=p_scale, p_shift=p_shift, pad=0)
    out = deform_eyes(out, rng, p_scale=p_scale, p_shift=p_shift, pad=0)
    return out


# --------------------------------------------------------------------
# image-space augmentation (menpo_functions.py:158-238)
# images are (H, W, C) float in [0, 1]; landmarks (68, 2) (y, x)
# --------------------------------------------------------------------

def warp_image_tps(image: np.ndarray, lms_yx: np.ndarray,
                   new_lms_yx: np.ndarray,
                   device: torch.device | str = DEFAULT_DEVICE
                   ) -> np.ndarray:
    """Warp so the content at ``lms_yx`` appears at ``new_lms_yx``: menpo's
    ``ThinPlateSplines(new, old)`` + ``warp_to_shape`` with zero fill
    (menpo_functions.py:228-238), the r^2 log r spline of
    ``ops/tps.py:sparse_image_warp`` on ``device``."""
    from animateportrait_tpu_torch.ops.tps import sparse_image_warp

    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    warped, _ = sparse_image_warp(t(image).permute(2, 0, 1)[None],
                                  t(lms_yx)[None], t(new_lms_yx)[None])
    return warped[0].permute(1, 2, 0).cpu().numpy()


def augment_geom(image: np.ndarray, lms_yx: np.ndarray,
                 rng: np.random.Generator, p_geom: float,
                 device: torch.device | str = DEFAULT_DEVICE
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Geometric artistic augmentation: deform the landmarks, TPS-warp the
    image to them (menpo_functions.py:217-225); ``p_geom`` binarized per
    item (:263-264). A singular spline system keeps the original item;
    any other failure raises."""
    p = 1.0 * (rng.random() < p_geom)
    if not p > 0.5:
        return image, lms_yx
    new_lms = deform_face_geometric_style(lms_yx.copy(), rng,
                                          p_scale=p, p_shift=p)
    try:
        return warp_image_tps(image, lms_yx, new_lms, device), new_lms
    except torch.linalg.LinAlgError:
        return image, lms_yx


def augment_texture(image: np.ndarray, img_path: str, img_dir_ns: str,
                    rng: np.random.Generator, p_texture: float
                    ) -> np.ndarray:
    """Texture-style augmentation: a pre-stylized copy ``<stem>_ns*`` from
    ``img_dir_ns`` in place of the image (menpo_functions.py:202-215)."""
    p = 1.0 * (rng.random() < p_texture)
    if not p > 0.5 or not img_dir_ns:
        return image
    stem = os.path.basename(img_path).split(".")[0]
    variants = sorted(glob.glob(os.path.join(img_dir_ns, stem + "_ns*")))
    if not variants:
        return image
    pick = variants[int(rng.integers(0, len(variants)))]
    return read_image(pick)[:, :, ::-1].astype(np.float32) / 255.0


def augment_basic(image: np.ndarray, lms_yx: np.ndarray,
                  rng: np.random.Generator, image_size: int = 256,
                  crop_size: int | None = None, angle_range: float = 30.0,
                  flip: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """Basic augmentation: random crop -> random flip -> random rotation
    with canvas expansion -> resize back (menpo_functions.py:158-201).
    ``crop_size`` defaults to the reference's 256 -> 248 margin scaled to
    ``image_size``."""
    if crop_size is None:
        crop_size = image_size - 8

    img = np.asarray(image, np.float32)
    lms = np.asarray(lms_yx, np.float64).copy()

    y0, x0 = rng.integers(0, image_size - crop_size, 2)
    img = img[y0:y0 + crop_size, x0:x0 + crop_size]
    lms -= np.array([y0, x0])

    if flip and rng.random() > 0.5:
        img = img[:, ::-1]
        lms[:, 1] = img.shape[1] - lms[:, 1]
        lms = lms[FLIP_REMAP]

    angle = 2.0 * angle_range * rng.random() - angle_range
    h, w = img.shape[:2]
    m = rotation_matrix_2d(((w - 1) / 2.0, (h - 1) / 2.0), angle, 1.0)
    cos_a, sin_a = abs(m[0, 0]), abs(m[0, 1])
    nw = int(h * sin_a + w * cos_a)
    nh = int(h * cos_a + w * sin_a)
    m[0, 2] += nw / 2.0 - (w - 1) / 2.0
    m[1, 2] += nh / 2.0 - (h - 1) / 2.0
    img = warp_affine(img, m, (nw, nh))
    pts_xy = lms[:, ::-1]
    pts_xy = pts_xy @ m[:, :2].T + m[:, 2]
    lms = pts_xy[:, ::-1]

    sy, sx = image_size / img.shape[0], image_size / img.shape[1]
    img = resize_linear_float(img, (image_size, image_size))
    lms *= np.array([sy, sx])
    return np.ascontiguousarray(img), lms


def augment_foa_item(image: np.ndarray, lms_yx: np.ndarray,
                     rng: np.random.Generator, img_path: str = "",
                     img_dir_ns: str = "", p_texture: float = 0.0,
                     p_geom: float = 0.0, basic: bool = True,
                     image_size: int = 256,
                     device: torch.device | str = DEFAULT_DEVICE
                     ) -> tuple[np.ndarray, np.ndarray]:
    """One training item through the reference's augmentation order:
    texture -> geometric -> basic (menpo_functions.py:279-283)."""
    if p_texture > 0:
        image = augment_texture(image, img_path, img_dir_ns, rng,
                                p_texture)
    if p_geom > 0:
        image, lms_yx = augment_geom(image, lms_yx, rng, p_geom, device)
    if basic:
        image, lms_yx = augment_basic(image, lms_yx, rng,
                                      image_size=image_size)
    return image, lms_yx


# --------------------------------------------------------------------
# GT heatmaps (data_loading_functions.py:31-160)
# --------------------------------------------------------------------

def approx_gaussian_heatmaps(lms_yx, size: int, sigma: float = 6.0,
                             win_mult: float = 3.33335) -> torch.Tensor:
    """(..., 68, 2) landmarks, cast to fp32 and then to int -> (..., 68,
    size, size) windowed gaussians of amplitude (8/3) sigma ("same as in
    ECT"), fp32: the reference's clipped patch paste
    (create_approx_heat_maps_alloc_once) as one masked evaluation."""
    win = int(win_mult * sigma)
    lms = torch.as_tensor(np.asarray(lms_yx, np.float32))
    lm = torch.clamp(lms, max=float(size - 1)).to(torch.int32)
    r = torch.arange(size, dtype=torch.int32)
    dy = r - lm[..., 0:1]
    dx = r - lm[..., 1:2]
    amp = (8.0 / 3.0) / np.sqrt(2.0 * np.pi)

    def g(d):
        return torch.exp(-0.5 * torch.square(d.float() / sigma)) \
            * (torch.abs(d) <= win)

    return amp * g(dy)[..., :, None] * g(dx)[..., None, :]


def make_foa_targets(lms_yx: np.ndarray, image_size: int = 256,
                     sigma: float = 6.0, win_mult: float = 3.33335
                     ) -> tuple[np.ndarray, np.ndarray]:
    """(maps_small (68, S/4, S/4), maps (68, S, S)) of one item: the small
    maps at landmarks / 4 with sigma / 4
    (load_images_landmarks_approx_maps_alloc_once:126-154)."""
    lms = np.asarray(lms_yx, np.float64)
    large = approx_gaussian_heatmaps(lms, image_size, sigma, win_mult)
    small = approx_gaussian_heatmaps(lms / 4.0, image_size // 4,
                                     sigma / 4.0, win_mult)
    return small.numpy(), large.numpy()


# --------------------------------------------------------------------
# training step (deep_heatmaps_model_fusion_net.py:338-494)
# --------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FOATrainConfig:
    lr: float = 1e-3
    lr_step: int = 100000          # staircase exponential decay
    gamma: float = 0.1
    adam: bool = True
    momentum: float = 0.95
    l_weight_primary: float = 1.0
    l_weight_fusion: float = 1.0
    l_weight_upsample: float = 3.0
    reg: float = 0.0               # L2 on non-bias weights
    num_landmarks: int = 68


def seeded_foa_net(cfg: FOATrainConfig, seed: int) -> ArtisticHeatmapNet:
    """The net with torch's default init drawn under ``seed`` on the CPU
    (the deconv bilinear, as the reference initializes it)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return ArtisticHeatmapNet(cfg.num_landmarks)


class FOATrainer:
    """The net and its optimizer: ``step(images (N, 3, S, S), maps_small
    (N, 68, S/4, S/4), maps (N, 68, S, S))`` runs one forward, the
    backward, the update and the schedule's step, leaves the gradients in
    ``.grad`` and returns the losses (``l2_primary``, ``l2_fusion``,
    ``l2_upsample``, ``total``)."""

    def __init__(self, cfg: FOATrainConfig,
                 model: ArtisticHeatmapNet | None = None,
                 device: torch.device | str = DEFAULT_DEVICE):
        self.cfg = cfg
        self.device = resolve_device(device)
        model = model if model is not None else seeded_foa_net(cfg, 0)
        self.model = model.to(self.device).train()
        params = self.model.parameters()
        self.opt = (adam(params, cfg.lr) if cfg.adam else
                    torch.optim.SGD(params, lr=cfg.lr,
                                    momentum=cfg.momentum))
        self.sched = torch.optim.lr_scheduler.StepLR(self.opt, cfg.lr_step,
                                                     cfg.gamma)
        self.steps = 0

    def losses(self, images, maps_small, maps) -> dict[str, torch.Tensor]:
        cfg = self.cfg
        primary, fusion, up = self.model(images)
        l2_primary = torch.mean(torch.square(primary - maps_small))
        l2_fusion = torch.mean(torch.square(fusion - maps_small))
        l2_upsample = torch.mean(torch.square(up - maps))
        total = 1000.0 * (cfg.l_weight_primary * l2_primary
                          + cfg.l_weight_fusion * l2_fusion
                          + cfg.l_weight_upsample * l2_upsample)
        if cfg.reg > 0:
            # tf.nn.l2_loss (sum(x^2) / 2) over every non-bias variable
            total = total + cfg.reg * sum(
                0.5 * torch.sum(torch.square(p))
                for n, p in self.model.named_parameters()
                if not n.endswith("bias"))
        return {"l2_primary": l2_primary, "l2_fusion": l2_fusion,
                "l2_upsample": l2_upsample, "total": total}

    def step(self, images, maps_small, maps) -> dict[str, torch.Tensor]:
        self.opt.zero_grad(set_to_none=True)
        m = self.losses(images, maps_small, maps)
        m["total"].backward()
        self.opt.step()
        self.sched.step()
        self.steps += 1
        return {k: v.detach() for k, v in m.items()}

    def state_dict(self) -> dict:
        return {"step": self.steps, "model": self.model.state_dict(),
                "opt": self.opt.state_dict(),
                "sched": self.sched.state_dict()}

    def load_state_dict(self, obj: dict) -> "FOATrainer":
        self.model.load_state_dict(obj["model"])
        self.opt.load_state_dict(obj["opt"])
        self.sched.load_state_dict(obj["sched"])
        self.steps = int(obj["step"])
        return self


# --------------------------------------------------------------------
# NME eval + training driver
# (deep_heatmaps_model_fusion_net.py:340-361,495-720;
#  train_heatmaps_network.py)
# --------------------------------------------------------------------

def nme_norm_eyes(pred_yx: np.ndarray, gt_yx: np.ndarray) -> np.ndarray:
    """Per-image mean landmark error over the ground truth's inter-pupil
    distance (the eye centres of points 36-41 and 42-47;
    deep_heatmaps_model_fusion_net.py:340-361)."""
    pred = np.asarray(pred_yx, np.float64)
    gt = np.asarray(gt_yx, np.float64)
    err = np.mean(np.sqrt(np.sum((pred - gt) ** 2, axis=2)), axis=1)
    p1 = gt[:, 42:48].mean(1)
    p2 = gt[:, 36:42].mean(1)
    eye_dist = np.sqrt(np.sum((p1 - p2) ** 2, axis=1))
    return err / eye_dist


@torch.no_grad()
def evaluate_foa(model: ArtisticHeatmapNet, images: np.ndarray,
                 lms_yx: np.ndarray, batch_size: int = 4) -> float:
    """The mean NME of the argmax of the upsampled maps on a validation set
    (the reference's valid_nme_loss, :384-385); images (N, S, S, 3), on the
    model's device."""
    dev = next(model.parameters()).device
    nmes = []
    for s in range(0, len(images), batch_size):
        x = torch.from_numpy(np.ascontiguousarray(
            images[s:s + batch_size], np.float32)).to(dev).permute(0, 3, 1, 2)
        pred = heatmaps_to_landmarks_yx(model(x)[2]).cpu().numpy()
        nmes.append(nme_norm_eyes(pred, lms_yx[s:s + batch_size]))
    return float(np.concatenate(nmes).mean())


def train_foa(items, cfg: FOATrainConfig | None = None,
              train_iter: int = 1000, batch_size: int = 4,
              image_size: int = 256, sigma: float = 6.0,
              img_dir_ns: str = "", p_texture: float = 0.0,
              p_geom: float = 0.0, augment: bool = True,
              valid_items=None, log_valid_every: int = 5,
              print_every: int = 100, save_every: int = 20000,
              checkpoint_dir: str | None = None, seed: int = 0,
              trainer: FOATrainer | None = None, log_fn=print,
              device: torch.device | str = DEFAULT_DEVICE) -> FOATrainer:
    """The reference's training loop (train_heatmaps_network.py +
    DeepHeatmapsModel.train :495-720): a reshuffle and augmentation per
    epoch, a staircase-lr step per batch, loss prints, the validation NME
    every ``log_valid_every`` epochs and checkpoints (``trainer.
    state_dict()`` through ``io/checkpoint.py:CheckpointManager``).
    ``items`` are ``data/face_of_art.load_foa_image_list``'s (or anything
    with .image/.lms/.path). Without ``trainer`` the net takes torch's
    default init under ``seed``. Returns the trainer."""
    from animateportrait_tpu_torch.data.face_of_art import foa_epoch_batches

    if len(items) < batch_size:
        # the epochs drop the incomplete tail batch: an undersized list
        # would give no batch and the loop would never advance
        raise ValueError(
            f"need at least batch_size={batch_size} items, got "
            f"{len(items)}")
    cfg = cfg or FOATrainConfig()
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if trainer is None:
        trainer = FOATrainer(cfg, seeded_foa_net(cfg, seed), device=dev)
    mgr = None
    if checkpoint_dir:
        from animateportrait_tpu_torch.io.checkpoint import CheckpointManager

        mgr = CheckpointManager(checkpoint_dir)

    def t(a):
        return torch.from_numpy(a).to(dev)

    step = trainer.steps
    epoch = 0
    while step < train_iter:
        for imgs, smalls, larges, _ in foa_epoch_batches(
                items, batch_size, rng, img_dir_ns=img_dir_ns,
                p_texture=p_texture, p_geom=p_geom, augment=augment,
                image_size=image_size, sigma=sigma, device=dev):
            losses = trainer.step(t(imgs), t(smalls), t(larges))
            step = trainer.steps
            if print_every and step % print_every == 0:
                log_fn(
                    f"epoch: [{epoch}] step: [{step}/{train_iter}] "
                    f"primary: [{float(losses['l2_primary']):.6f}] "
                    f"fusion: [{float(losses['l2_fusion']):.6f}] "
                    f"upsample: [{float(losses['l2_upsample']):.6f}] "
                    f"total: [{float(losses['total']):.6f}]")
            if mgr is not None and save_every and step % save_every == 0:
                mgr.save(step, trainer.state_dict(), force=True)
            if step >= train_iter:
                break
        epoch += 1
        if valid_items and log_valid_every and \
                epoch % log_valid_every == 0:
            vi = np.stack([v.image for v in valid_items])
            vl = np.stack([v.lms for v in valid_items])
            log_fn(f"epoch: [{epoch}] valid NME: "
                   f"[{evaluate_foa(trainer.model, vi, vl):.6f}]")
    if mgr is not None and step not in mgr.all_steps():
        mgr.save(step, trainer.state_dict(), force=True)
    return trainer
