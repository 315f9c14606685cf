"""The artistic-portrait landmark detector ("Face of Art"), NCHW. Port of
``animateportrait_tpu/models/face_of_art.py`` (the reference's
Module1/thirdparty/face_of_art/, TF1), its three stages as in
predict_landmarks.py:1-70:

1. estimation: ``ArtisticHeatmapNet``, the multi-scale fusion heatmap CNN
   (deep_heatmaps_model_fusion_net.py:233-330). Every conv is TF ``SAME``
   (a dilated 5x5 at rate 3 spans 13 pixels: symmetric padding 6); the
   pools are TF ``SAME`` 2x2 max pools, ``MaxPool2d(2, 2, ceil_mode=True)``
   (an odd side gets its last row and column alone); the 8x8 stride-4
   ``SAME`` transposed conv is ``ConvTranspose2d(kernel 8, stride 4,
   padding 2)`` (the dilated input padded by 5 on each side, as JAX does),
   its weight TF's (h, w, out, in) kernel transposed to (in, out, h, w),
   bilinear at init;
2. correction: the part-based PDM (per-part Procrustes PCA shape models,
   or the reference's shipped menpofit models through
   ``io/menpo_pickle.py``);
3. tuning: the evidence-weighted PDM projection and the ECT-style CLM
   loop.

Stages 2-3 are host numpy, the JAX package's code kept as a copy.
``predict_artistic_landmarks`` runs the net on its device and the
correction on the host. Landmarks are menpo's (y, x) in this module;
``predict_artistic_landmarks`` returns (x, y). No kernel of the port lies
on this path.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

N_LANDMARKS = 68

PART_INDS = {
    "jaw": np.arange(0, 17),
    "l_brow": np.arange(17, 22),
    "r_brow": np.arange(22, 27),
    "nose": np.arange(27, 36),
    "l_eye": np.arange(36, 42),
    "r_eye": np.arange(42, 48),
    "mouth": np.arange(48, 68),
}
# selected PC counts (pdm_clm_functions.py:139-146)
PART_PCS = {"jaw": 7, "nose": 5, "l_eye": 3, "r_eye": 3, "l_brow": 2,
            "r_brow": 2, "mouth": 7}

# (scope, out channels, kernel, dilation) of every conv + ReLU, in the
# order the net runs them; in channels follow from the concatenations
_FSN2 = ((1, 3, 1), (2, 3, 2), (3, 3, 4), (4, 5, 3))


def _same_conv(cin: int, cout: int, k: int, d: int = 1) -> nn.Conv2d:
    """A stride-1 TF ``SAME`` conv of odd size: symmetric padding."""
    return nn.Conv2d(cin, cout, k, padding=d * (k // 2), dilation=d)


def _pool(x: torch.Tensor) -> torch.Tensor:
    """tf.layers.max_pooling2d(2, 2, 'same')."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def bilinear_upsample_kernel(kernel: int, channels: int) -> np.ndarray:
    """deconv2d_bilinear_upsampling_initializer (ops.py:55-85): the
    per-channel bilinear kernel, (h, w, out, in), diagonal."""
    factor = (kernel + 1) // 2
    center = factor - 1.0 if kernel % 2 == 1 else factor - 0.5
    og = np.ogrid[:kernel, :kernel]
    filt = (1 - abs(og[0] - center) / factor) * \
        (1 - abs(og[1] - center) / factor)
    w = np.zeros((kernel, kernel, channels, channels), np.float32)
    for c in range(channels):
        w[:, :, c, c] = filt
    return w


class ArtisticHeatmapNet(nn.Module):
    """heatmaps_network: forward(images (N, 3, S, S)) -> (primary (N, 68,
    S/4, S/4), fusion (same), upsampled (N, 68, S, S)). Module names are
    the TF scopes (``conv_1``, ``conv_4_2``, ``conv_fsn_2_4``,
    ``deconv_1``, ...)."""

    def __init__(self, num_landmarks: int = N_LANDMARKS):
        super().__init__()
        nl = num_landmarks
        self.conv_1 = _same_conv(3, 128, 5)
        self.conv_2 = _same_conv(128, 128, 5)
        self.conv_3 = _same_conv(128, 128, 5)
        for d in (1, 2, 3, 4):
            self.add_module(f"conv_4_{d}", _same_conv(128, 128, 3, d))
        for d in (1, 2, 3, 4):
            self.add_module(f"conv_5_{d}", _same_conv(512, 256, 3, d))
        self.conv_6 = _same_conv(1024, 512, 1)
        self.conv_7 = _same_conv(512, 256, 1)
        self.conv_8 = _same_conv(256, nl, 1)
        for d in (1, 2, 3):
            self.add_module(f"conv_fsn_1_{d}", _same_conv(384, 64, 3, d))
        for i, k, d in _FSN2:
            self.add_module(f"conv_fsn_2_{i}", _same_conv(192, 64, k, d))
        for i, k, d in _FSN2:
            self.add_module(f"conv_fsn_3_{i}", _same_conv(256, 128, k, d))
        self.conv_fsn_4 = _same_conv(512, 256, 1)
        self.conv_fsn_5 = _same_conv(256, nl, 1)
        self.deconv_1 = nn.ConvTranspose2d(nl, nl, 8, 4, padding=2)
        with torch.no_grad():
            self.deconv_1.weight.copy_(torch.from_numpy(
                bilinear_upsample_kernel(8, nl).transpose(3, 2, 0, 1)))
            self.deconv_1.bias.zero_()

    def _bank(self, x, names):
        return torch.cat([F.relu(getattr(self, n)(x)) for n in names], 1)

    def forward(self, x):
        l1 = _pool(F.relu(self.conv_1(x)))
        l2 = _pool(F.relu(self.conv_2(l1)))
        l3 = F.relu(self.conv_3(l2))
        l4 = self._bank(l3, [f"conv_4_{d}" for d in (1, 2, 3, 4)])
        l5 = self._bank(l4, [f"conv_5_{d}" for d in (1, 2, 3, 4)])
        l7 = F.relu(self.conv_7(F.relu(self.conv_6(l5))))
        primary = self.conv_8(l7)
        f0 = torch.cat([l3, l7], 1)
        f1 = self._bank(f0, [f"conv_fsn_1_{d}" for d in (1, 2, 3)])
        f2 = self._bank(f1, [f"conv_fsn_2_{i}" for i in (1, 2, 3, 4)])
        f3 = self._bank(f2, [f"conv_fsn_3_{i}" for i in (1, 2, 3, 4)])
        fusion = self.conv_fsn_5(F.relu(self.conv_fsn_4(f3)))
        return primary, fusion, self.deconv_1(fusion)


def heatmaps_to_landmarks_yx(hm: torch.Tensor) -> torch.Tensor:
    """The argmax of each map, menpo (y, x): (N, C, H, W) -> (N, C, 2)."""
    n, c, h, w = hm.shape
    idx = torch.argmax(hm.reshape(n, c, h * w), dim=2)
    return torch.stack([idx // w, idx % w], dim=-1).float()


TF_SCOPES = (["conv_1", "conv_2", "conv_3", "conv_6", "conv_7", "conv_8",
              "conv_fsn_4", "conv_fsn_5"]
             + [f"conv_4_{d}" for d in (1, 2, 3, 4)]
             + [f"conv_5_{d}" for d in (1, 2, 3, 4)]
             + [f"conv_fsn_1_{d}" for d in (1, 2, 3)]
             + [f"conv_fsn_2_{d}" for d in (1, 2, 3, 4)]
             + [f"conv_fsn_3_{d}" for d in (1, 2, 3, 4)])


def foa_state_dict(var_dict: dict) -> dict[str, torch.Tensor]:
    """The reference's TF checkpoint variables
    ('heatmaps_network/<scope>/conv/kernel', ...) -> the port's state dict:
    conv kernels HWIO -> OIHW, the deconv's (h, w, out, in) -> (in, out, h,
    w); the counterpart of the JAX package's ``load_foa_params``."""
    def t(a, axes):
        return torch.from_numpy(np.ascontiguousarray(
            np.transpose(np.asarray(a, np.float32), axes)))

    sd = {}
    for scope in TF_SCOPES:
        base = f"heatmaps_network/{scope}/conv/"
        sd[f"{scope}.weight"] = t(var_dict[base + "kernel"], (3, 2, 0, 1))
        sd[f"{scope}.bias"] = t(var_dict[base + "bias"], (0,))
    base = "heatmaps_network/deconv_1/deconv/"
    sd["deconv_1.weight"] = t(var_dict[base + "kernel"], (3, 2, 0, 1))
    sd["deconv_1.bias"] = t(var_dict[base + "bias"], (0,))
    return sd


# ---------------------------------------------------------------------------
# PDM correction stage (host-side numpy, like the reference's menpo use)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PDM:
    """Point distribution model: Procrustes-aligned PCA shape space."""

    mean: np.ndarray          # (P, 2), centered reference frame
    components: np.ndarray    # (n_pc, 2P) orthonormal rows
    eigenvalues: np.ndarray   # (n_pc,)


def _similarity(src: np.ndarray, dst: np.ndarray
                ) -> tuple[float, np.ndarray, np.ndarray]:
    """Least-squares similarity (s, R, t) with s*R@src + t ~= dst."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / len(src)
    u, s, vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(u @ vt))
    diag = np.diag([1.0, d])
    r = u @ diag @ vt
    var = (sc ** 2).sum() / len(src)
    scale = np.trace(np.diag(s) @ diag) / var
    t = mu_d - scale * r @ mu_s
    return float(scale), r, t


def train_pdm(shapes: np.ndarray, n_components: int) -> PDM:
    """Generalized Procrustes alignment + PCA over (M, P, 2) shapes."""
    shapes = np.asarray(shapes, np.float64)
    aligned = shapes - shapes.mean(axis=1, keepdims=True)
    mean = aligned[0]
    for _ in range(5):
        out = []
        for s in aligned:
            sc, r, t = _similarity(s, mean)
            out.append(sc * s @ r.T + t)
        aligned = np.stack(out)
        mean = aligned.mean(0)
        mean -= mean.mean(0)
        mean /= np.linalg.norm(mean)
    flat = (aligned - mean).reshape(len(shapes), -1)
    _, svals, vt = np.linalg.svd(flat, full_matrices=False)
    n_components = min(n_components, vt.shape[0])
    return PDM(mean=mean,
               components=vt[:n_components],
               eigenvalues=(svals[:n_components] ** 2) / len(shapes))


def pdm_correct(init_shape: np.ndarray, pdm: PDM,
                weights: np.ndarray | None = None,
                rho: float = 20.0) -> np.ndarray:
    """OrthoPDM.set_target equivalent (pdm_clm_functions.py:83-121).

    Similarity-aligns the model frame onto ``init_shape`` (y, x), projects
    the residual onto the shape basis — plainly, or with per-coordinate
    evidence ``weights`` and the reference's rho/eigenvalue Tikhonov prior
    (weighted_pdm_transform :92-110) — and reconstructs.
    """
    scale, r, t = _similarity(pdm.mean, init_shape)
    inv = (init_shape - t) @ r / scale
    resid = (inv - pdm.mean).ravel()
    if weights is None:
        b = pdm.components @ resid
    else:
        j = pdm.components.T  # (2P, n_pc)
        jwj = j.T @ (weights[:, None] * j)
        prior = np.diag(rho / np.maximum(pdm.eigenvalues, 1e-12))
        b = np.linalg.solve(jwj + prior, j.T @ (weights * resid))
    recon = pdm.mean + (pdm.components.T @ b).reshape(-1, 2)
    return scale * recon @ r.T + t


def calculate_evidence(patches: np.ndarray, rate: float = 0.25,
                       offset: float = 20.0) -> np.ndarray:
    """pdm_clm_functions.py:22-61: per-(y,x)-coordinate confidence of
    each landmark's heatmap patch. patches: (P, 1, h, w) -> (2P,)."""
    n_points, _, hh, ww = patches.shape
    out = np.zeros(2 * n_points)
    for i in range(n_points):
        resp = np.maximum(patches[i, 0], 0.0)
        yw = resp.sum(axis=1)
        xw = resp.sum(axis=0)
        yc = np.arange(hh)
        xc = np.arange(ww)
        tot = resp.sum()
        if tot <= 0:
            var_y = var_x = np.finfo(float).eps
        else:
            my = np.average(yc, weights=yw)
            mx = np.average(xc, weights=xw)
            var_y = max(np.average((yc - my) ** 2, weights=yw),
                        np.finfo(float).eps)
            var_x = max(np.average((xc - mx) ** 2, weights=xw),
                        np.finfo(float).eps)
        w_y = tot / np.sqrt(var_y)
        w_x = tot / np.sqrt(var_x)
        out[2 * i] = 1.0 / (1.0 + np.exp(-rate * (w_y - offset)))
        out[2 * i + 1] = 1.0 / (1.0 + np.exp(-rate * (w_x - offset)))
    return out


def get_patches_around_landmarks(heatmaps: np.ndarray,
                                 points_yx: np.ndarray,
                                 patch_size: int = 30,
                                 image_shape: int = 256) -> np.ndarray:
    """pdm_clm_functions.py:64-81: (H, W, P) maps + (P, 2) points ->
    (P, 1, patch, patch) zero-padded response patches."""
    pad = image_shape // 2
    p = points_yx.shape[0]
    padded = np.zeros((2 * image_shape, 2 * image_shape, p))
    padded[pad:pad + image_shape, pad:pad + image_shape, :] = heatmaps
    r_off = patch_size // 2
    l_off = patch_size - r_off
    patches = []
    for i in range(p):
        y = int(np.around(points_yx[i, 0] + 1 + pad))
        x = int(np.around(points_yx[i, 1] + 1 + pad))
        patches.append(padded[y - r_off:y + l_off,
                              x - r_off:x + l_off, i])
    return np.asarray(patches)[:, None]


def feature_based_pdm_correct(lms_init_yx: np.ndarray,
                              pdms: dict[str, PDM],
                              heatmaps: np.ndarray | None = None
                              ) -> np.ndarray:
    """Part-based correction (pdm_clm_functions.py:124-170): each facial
    part is corrected by its own PDM; with ``heatmaps`` the projection is
    evidence-weighted (the tuning stage's update)."""
    new = np.array(lms_init_yx, np.float64)
    patches = None
    if heatmaps is not None:
        patches = get_patches_around_landmarks(
            heatmaps, lms_init_yx, image_shape=heatmaps.shape[0])
        evidence = calculate_evidence(patches, rate=0.5, offset=10.0)
    for part, inds in PART_INDS.items():
        pdm = pdms.get(part)
        if pdm is None:
            continue
        w = None
        if heatmaps is not None:
            w = np.stack([evidence[2 * inds], evidence[2 * inds + 1]],
                         axis=1).ravel()
        new[inds] = pdm_correct(lms_init_yx[inds], pdm, weights=w)
    return new


def pdm_correct_reference(init_shape_yx: np.ndarray, rpdm) -> np.ndarray:
    """Exact menpofit ``OrthoPDM.set_target`` on a shipped model
    (``pdm_correct``, pdm_clm_functions.py:83-88).

    menpo linearizes the global similarity as 4 extra basis rows
    (scale/rotation/translation of a fixed shape is linear in 4 params)
    and keeps the joint [similarity; shape] basis orthonormal, so
    set_target is a one-shot projection — verified to reproduce the
    stored fitting state in the shipped pickles to ~1e-14.
    """
    x = np.asarray(init_shape_yx, np.float64).ravel()
    b = rpdm.basis @ (x - rpdm.mean)
    return (rpdm.mean + rpdm.basis.T @ b).reshape(-1, 2)


def weighted_pdm_correct_reference(init_shape_yx: np.ndarray, rpdm,
                                   weights: np.ndarray,
                                   rho: float = 20.0) -> np.ndarray:
    """Exact ``weighted_pdm_transform`` (pdm_clm_functions.py:91-110) on
    a shipped model: Tikhonov-regularized weighted projection with zero
    prior on the 4 similarity parameters and rho/eigenvalue on the shape
    parameters, solved jointly."""
    x = np.asarray(init_shape_yx, np.float64).ravel()
    w = np.asarray(weights, np.float64)
    j = rpdm.basis.T                              # (2P, 4 + n_pc)
    prior = np.concatenate([np.zeros(rpdm.n_sim),
                            rho / np.maximum(rpdm.eigenvalues, 1e-300)])
    resid = x - rpdm.mean
    jwj = j.T @ (w[:, None] * j)
    p = np.linalg.solve(jwj + np.diag(prior), j.T @ (w * resid))
    return (rpdm.mean + j @ p).reshape(-1, 2)


def feature_based_pdm_correct_reference(lms_init_yx: np.ndarray,
                                        rpdms: dict,
                                        heatmaps: np.ndarray | None = None
                                        ) -> np.ndarray:
    """``feature_based_pdm_corr`` (pdm_clm_functions.py:124-170) on the
    shipped per-part models: plain set_target per part, or the
    evidence-weighted transform when ``heatmaps`` are given (the w_pdm
    path, rate=0.5/offset=10 as at :92)."""
    lms_init_yx = np.asarray(lms_init_yx, np.float64)
    new = lms_init_yx.copy()
    evidence = None
    if heatmaps is not None:
        patches = get_patches_around_landmarks(
            heatmaps, lms_init_yx, image_shape=heatmaps.shape[0])
        evidence = calculate_evidence(patches, rate=0.5, offset=10.0)
    for part, inds in PART_INDS.items():
        rpdm = rpdms.get(part)
        if rpdm is None:
            continue
        if evidence is None:
            new[inds] = pdm_correct_reference(lms_init_yx[inds], rpdm)
        else:
            w = np.stack([evidence[2 * inds], evidence[2 * inds + 1]],
                         axis=1).ravel()
            new[inds] = weighted_pdm_correct_reference(
                lms_init_yx[inds], rpdm, w)
    return new


def clm_correct_reference(heatmaps: np.ndarray, lms_init_yx: np.ndarray,
                          clm_pdm, opt: dict | None = None) -> np.ndarray:
    """ECT-style CLM tuning on the shipped ``clm_models`` shape model
    (``clm_correct``, pdm_clm_functions.py:172-203).

    The reference delegates to the ECT fork's
    ``GradientDescentCLMFitter.fit_from_shape`` with the response maps
    attached as ``image.rspmap_data``; the fork itself is not shipped, so
    this implements its documented regularized-mean-shift loop (Zhang et
    al., ECT) with the pickle's own option values: ``numIter`` rounds of
    (1) Gaussian-kernel mean-shift of each landmark over its response
    patch (``kernel_covariance``), (2) evidence weighting
    (``sigRate``/``sigOffset`` via calculate_evidence), (3) the same
    joint weighted Tikhonov PDM solve as weighted_pdm_transform with
    ``rho2`` — all on the shipped 30-PC shape model.
    """
    opt = dict(opt or {})
    n_iter = int(opt.get("numIter", 5))
    kcov = float(opt.get("kernel_covariance", 10))
    rate = float(opt.get("sigRate", 0.25))
    offset = float(opt.get("sigOffset", 25))
    rho2 = float(opt.get("rho2", 20))
    patch = 30
    cur = np.asarray(lms_init_yx, np.float64).copy()
    img = heatmaps.shape[0]
    for _ in range(n_iter):
        patches = get_patches_around_landmarks(
            heatmaps, cur, patch_size=patch, image_shape=img)
        evidence = calculate_evidence(patches, rate=rate, offset=offset)
        # Gaussian-kernel mean shift over each landmark's patch
        r_off = patch // 2
        grid = np.arange(patch, dtype=np.float64)
        targets = np.empty_like(cur)
        for i in range(cur.shape[0]):
            resp = np.maximum(patches[i, 0], 0.0)
            # get_patches_around_landmarks cuts the patch centered at
            # round(pt + 1) (the ECT "+1", pdm_clm_functions.py:76-77),
            # so patch row r sits at image row round(cur) + 1 + r - r_off
            ys = np.around(cur[i, 0]) + 1 + grid - r_off
            xs = np.around(cur[i, 1]) + 1 + grid - r_off
            ky = np.exp(-0.5 * (ys - cur[i, 0]) ** 2 / kcov)
            kx = np.exp(-0.5 * (xs - cur[i, 1]) ** 2 / kcov)
            kern = resp * ky[:, None] * kx[None, :]
            tot = kern.sum()
            if tot <= 1e-12:
                targets[i] = cur[i]
                continue
            targets[i, 0] = (kern.sum(1) @ ys) / tot
            targets[i, 1] = (kern.sum(0) @ xs) / tot
        cur = weighted_pdm_correct_reference(targets, clm_pdm, evidence,
                                             rho=rho2)
    return cur


@torch.no_grad()
def predict_artistic_landmarks(image: np.ndarray, model: ArtisticHeatmapNet,
                               pdms: dict | None = None) -> np.ndarray:
    """The three stages (predict_landmarks.py:50-70): heatmaps on the
    model's device, then (with ``pdms``) the part-PDM correction and the
    evidence-weighted tuning on the host. image (S, S, 3) in [0, 1];
    returns (68, 2) (x, y)."""
    dev = next(model.parameters()).device
    x = torch.from_numpy(np.ascontiguousarray(image, np.float32)).to(
        dev).permute(2, 0, 1)[None]
    _, _, up = model(x)
    hm = up[0].permute(1, 2, 0).cpu().numpy()
    lms_yx = heatmaps_to_landmarks_yx(up)[0].cpu().numpy()
    if pdms:
        # shipped menpofit models (exact menpo math) or self-trained PDMs
        ref = any(hasattr(p, "basis") for p in pdms.values())
        correct = (feature_based_pdm_correct_reference if ref
                   else feature_based_pdm_correct)
        lms_yx = correct(lms_yx, pdms)
        lms_yx = correct(lms_yx, pdms, heatmaps=hm)
    return lms_yx[:, ::-1].copy()
