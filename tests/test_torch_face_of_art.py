"""The port's face_of_art family (``models/face_of_art.py``,
``train/face_of_art.py``, ``data/face_of_art.py``, ``io/menpo_pickle.py``
and ``utils/image.py:warp_affine``) against the JAX package, cv2 and
scipy on the same inputs:

- ``ArtisticHeatmapNet`` with random weights, the deconv's too (a flip or
  transpose of its kernel shows), at an odd size (TF ``SAME`` pooling):
  each output within 1e-4 of its scale; the converters through the
  reference's TF variable names and ``load_foa_params``: exact;
- the host numpy stages (deformations with the same Generator draws, PDM
  training and correction, evidence, patches, the CLM loop, ``.pts`` /
  ``.mat`` / crops, ``nme_norm_eyes``): exact, or 1e-10 in float64;
- ``warp_affine`` against ``cv2.warpAffine`` and ``augment_basic``
  against the JAX package's (which calls cv2): byte-equal;
- the approximate heatmaps (fp32 in both: within 1e-6 of their
  amplitude), the data layer's items and augmented batches (the fp32 TPS
  warp within 2e-3);
- ``FOATrainer`` against ``build_foa_train_step`` for three steps with
  ``lr_step`` 2 (the decay inside the test), Adam with the ``reg`` term and
  SGD with momentum: losses within rtol 1e-4 at every step, the first
  step's gradients by ``grad_parity`` with the port's float64 step, the
  parameters within 1e-4 of their scale after the first Adam step (where
  its float64 gradient is not rounding noise), and after the three SGD
  steps within 1e-4 of the port's float64 three-step run and, by
  ``grad_parity``'s float64 rule at 1e-4, of JAX's (whose XLA CPU step is
  not repeatable on a loaded machine);
- ``evaluate_foa``, ``predict_artistic_landmarks`` with trained PDMs,
  ``train_foa`` with checkpoints, and the convergence runner's ``foa``
  row at 3 steps against the JAX tool's (rtol 1e-2);
- the menpo reader on pickles of menpo-named stub classes the test writes:
  the JAX package's reader's numbers, and the stored target rebuilt from
  the stored weights within 1e-12."""
import copy
import os
import pickle
import sys
import types

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from animateportrait_tpu.data import face_of_art as jdata
from animateportrait_tpu.models import face_of_art as jfoa
from animateportrait_tpu.train import face_of_art as jtrain
from animateportrait_tpu.utils.smoke import random_variables
from animateportrait_tpu_torch.data import face_of_art as tdata
from animateportrait_tpu_torch.io import from_jax
from animateportrait_tpu_torch.models import face_of_art as tfoa
from animateportrait_tpu_torch.train import face_of_art as ttrain
from animateportrait_tpu_torch.utils.image import (
    rotation_matrix_2d, warp_affine, write_png)
from animateportrait_tpu_torch.utils.smoke import grad_parity
from torch_port_helpers import adam_grads, maxdiff, nchw, nhwc

K = jax.random.key(0)


def _face_lms(size=256):
    from animateportrait_tpu_torch.utils.assets import std_face_landmarks
    lm = std_face_landmarks().reshape(68, 3)[:, :2]
    lm = lm - lm.min(0)
    lm = lm / lm.max() * (0.55 * size) + 0.22 * size
    return lm[:, ::-1].copy()


def _net_pair(nl=68, size=33, seed=0):
    jm = jfoa.ArtisticHeatmapNet(num_landmarks=nl)
    v = random_variables(lambda: jm.init(K, jnp.zeros((1, size, size, 3))),
                         seed=seed)
    tm = tfoa.ArtisticHeatmapNet(nl)
    tm.load_state_dict(from_jax.artistic_heatmap_state_dict(v), strict=True)
    return jm, v, tm


def _tf_vars(sd: dict) -> dict:
    """The reference's TF variables of a port state dict."""
    out = {}
    for k, t in sd.items():
        scope, leaf = k.rsplit(".", 1)
        kind = "deconv" if scope == "deconv_1" else "conv"
        a = t.numpy()
        out[f"heatmaps_network/{scope}/{kind}/"
            f"{'kernel' if leaf == 'weight' else 'bias'}"] = \
            a.transpose(2, 3, 1, 0) if a.ndim == 4 else a
    return out


def test_heatmap_net_matches_jax_with_random_deconv():
    jm, v, tm = _net_pair(nl=6, size=33)
    kernel = np.asarray(v["params"]["deconv_1"]["kernel"])
    assert not np.allclose(kernel, kernel.transpose(1, 0, 3, 2))
    x = np.random.default_rng(1).uniform(0, 1, (2, 33, 33, 3)).astype(
        np.float32)
    refs = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        gots = tm(nchw(x))
    assert gots[0].shape == (2, 6, 9, 9) and gots[2].shape == (2, 6, 36, 36)
    for g, r in zip(gots, refs):
        r = np.asarray(r)
        assert maxdiff(nhwc(g), r) <= 1e-4 * float(np.abs(r).max())


def test_converters_round_trip_through_tf_names():
    """from_jax -> the reference's TF variables -> ``foa_state_dict`` is the
    same state dict, and ``load_foa_params`` gives back the same JAX
    variables."""
    _, v, tm = _net_pair(nl=4, size=16)
    sd = from_jax.artistic_heatmap_state_dict(v)
    tf_vars = _tf_vars(sd)
    sd2 = tfoa.foa_state_dict(tf_vars)
    assert sd2.keys() == sd.keys()
    for k in sd:
        assert torch.equal(sd[k], sd2[k]), k
    back = jfoa.load_foa_params(tf_vars)
    flat_v = jax.tree_util.tree_flatten_with_path(v)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_v) == len(flat_b)
    for path, a in flat_v:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(a))


def test_init_deconv_is_bilinear_and_decode_matches():
    tm = tfoa.ArtisticHeatmapNet(2)
    w = tm.deconv_1.weight.detach().numpy().transpose(2, 3, 1, 0)
    assert np.array_equal(w, jfoa.bilinear_upsample_kernel(8, 2))
    hm = np.random.default_rng(2).standard_normal((3, 16, 12, 5)).astype(
        np.float32)
    ref = np.asarray(jfoa.heatmaps_to_landmarks_yx(jnp.asarray(hm)))
    assert np.array_equal(tfoa.heatmaps_to_landmarks_yx(nchw(hm)).numpy(),
                          ref)


def _ellipse_shapes(n=30, pts=10, seed=0):
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi, pts, endpoint=False)
    out = []
    for _ in range(n):
        a, b = rng.uniform(0.8, 1.2, 2)
        s = np.stack([a * np.cos(ang), b * np.sin(ang)], 1)
        out.append(s * rng.uniform(20, 40) + rng.uniform(50, 200, 2))
    return np.stack(out)


def test_pdm_clm_stages_match_jax():
    """train_pdm, pdm_correct (plain and weighted), the part-based
    correction with and without heatmaps, evidence and patches, and the
    shipped-model forms on a synthetic ``ReferencePDM``: the same numpy
    steps, equal to 1e-10."""
    from animateportrait_tpu.io.menpo_pickle import ReferencePDM as JRef
    from animateportrait_tpu_torch.io.menpo_pickle import ReferencePDM
    rng = np.random.default_rng(2)
    shapes = _ellipse_shapes()
    pa, pb = jfoa.train_pdm(shapes, 3), tfoa.train_pdm(shapes, 3)
    for f in ("mean", "components", "eigenvalues"):
        assert maxdiff(getattr(pa, f), getattr(pb, f)) <= 1e-10
    noisy = shapes[0] + rng.normal(0, 3, shapes[0].shape)
    w = rng.uniform(0, 1, 20)
    assert maxdiff(tfoa.pdm_correct(noisy, pb), jfoa.pdm_correct(noisy, pa)) \
        <= 1e-10
    assert maxdiff(tfoa.pdm_correct(noisy, pb, weights=w),
                   jfoa.pdm_correct(noisy, pa, weights=w)) <= 1e-10
    base = rng.uniform(40, 216, (68, 2))
    faces = base[None] + rng.normal(0, 2.0, (30, 68, 2))
    pdms_j = {p: jfoa.train_pdm(faces[:, i], 3)
              for p, i in jfoa.PART_INDS.items()}
    pdms_t = {p: tfoa.train_pdm(faces[:, i], 3)
              for p, i in tfoa.PART_INDS.items()}
    hm = rng.uniform(0, 1, (256, 256, 68))
    start = faces[0] + rng.normal(0, 4, (68, 2))
    for kw in ({}, {"heatmaps": hm}):
        assert maxdiff(tfoa.feature_based_pdm_correct(start, pdms_t, **kw),
                       jfoa.feature_based_pdm_correct(start, pdms_j, **kw)) \
            <= 1e-10
    patches = tfoa.get_patches_around_landmarks(hm, start)
    assert np.array_equal(patches,
                          jfoa.get_patches_around_landmarks(hm, start))
    assert np.array_equal(tfoa.calculate_evidence(patches),
                          jfoa.calculate_evidence(patches))
    # a shipped-style model: 4 similarity rows + 5 shape rows, orthonormal
    q, _ = np.linalg.qr(rng.standard_normal((136, 9)))
    mean = base.ravel()
    kw = dict(mean=mean, basis=q.T, eigenvalues=rng.uniform(1, 5, 5))
    rj, rt = JRef(**kw), ReferencePDM(**kw)
    opt = dict(numIter=3, kernel_covariance=10, sigOffset=25, sigRate=0.25,
               rho2=20)
    assert maxdiff(tfoa.clm_correct_reference(hm, start, rt, opt),
                   jfoa.clm_correct_reference(hm, start, rj, opt)) <= 1e-10
    parts_j = {p: JRef(mean=base[i].ravel(), basis=np.linalg.qr(
        rng.standard_normal((2 * len(i), 6)))[0].T,
        eigenvalues=np.ones(2)) for p, i in jfoa.PART_INDS.items()}
    parts_t = {p: ReferencePDM(mean=r.mean, basis=r.basis,
                               eigenvalues=r.eigenvalues)
               for p, r in parts_j.items()}
    for kw in ({}, {"heatmaps": hm}):
        assert maxdiff(
            tfoa.feature_based_pdm_correct_reference(start, parts_t, **kw),
            jfoa.feature_based_pdm_correct_reference(start, parts_j, **kw)) \
            <= 1e-10


def test_predict_artistic_landmarks_matches_jax():
    """The three stages with PDMs from ``train_pdm``: the net's argmax
    landmarks and the corrected ones equal the JAX package's."""
    jm, v, tm = _net_pair(nl=68, size=32, seed=3)
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
    faces = rng.uniform(4, 28, (68, 2))[None] + rng.normal(0, 0.5,
                                                           (20, 68, 2))
    pdms = {p: tfoa.train_pdm(faces[:, i], 3)
            for p, i in tfoa.PART_INDS.items()}
    jpdms = {p: jfoa.train_pdm(faces[:, i], 3)
             for p, i in jfoa.PART_INDS.items()}
    for pt, pj in ((None, None), (pdms, jpdms)):
        want = jfoa.predict_artistic_landmarks(img, v, pj, model=jm)
        got = tfoa.predict_artistic_landmarks(img, tm, pt)
        assert maxdiff(got, want) <= 1e-10


# --- the menpo reader ---------------------------------------------------

def _menpo_modules():
    """Modules named as menpo's, holding stub classes, so that pickle
    writes ``menpo.shape.pdm.OrthoPDM`` etc. as class references."""
    names = {"menpo": [], "menpo.shape": [], "menpo.shape.pdm": ["OrthoPDM"],
             "menpo.model": [], "menpo.model.pca": ["PCAModel"],
             "menpo.shape.pointcloud": ["PointCloud"],
             "menpofit": [], "menpofit.modelinstance": ["_SimilarityModel"],
             "menpofit.clm": [], "menpofit.clm.base": ["CLM"]}
    mods = {}
    for name, classes in names.items():
        m = types.ModuleType(name)
        for c in classes:
            cls = type(c, (), {})
            cls.__module__ = name
            cls.__qualname__ = c
            setattr(m, c, cls)
        mods[name] = m
    return mods


def _write_menpo_pickles(tmp_path, monkeypatch, rng):
    mods = _menpo_modules()
    for name, m in mods.items():
        monkeypatch.setitem(sys.modules, name, m)

    def obj(mod, cls, **attrs):
        o = getattr(mods[mod], cls)()
        o.__dict__.update(attrs)
        return o

    def pdm(n_pts, n_pc):
        basis, _ = np.linalg.qr(rng.standard_normal((2 * n_pts, 4 + n_pc)))
        mean = rng.uniform(0, 100, 2 * n_pts)
        sim_w = rng.standard_normal(4)
        w = rng.standard_normal(n_pc + 2)      # two inactive components
        comps = np.vstack([basis.T[4:], rng.standard_normal((2, 2 * n_pts))])
        target = (mean + basis.T[:4].T @ sim_w + comps[:n_pc].T @ w[:n_pc]
                  ).reshape(-1, 2)
        return obj("menpo.shape.pdm", "OrthoPDM",
                   model=obj("menpo.model.pca", "PCAModel", _mean=mean,
                             _components=comps,
                             _eigenvalues=rng.uniform(1, 9, n_pc + 2),
                             _n_active_components=n_pc),
                   similarity_model=obj("menpofit.modelinstance",
                                        "_SimilarityModel",
                                        _components=basis.T[:4]),
                   _target=obj("menpo.shape.pointcloud", "PointCloud",
                               points=target),
                   _weights=w[:n_pc], similarity_weights=sim_w)

    paths = {}
    for part, pc in (("jaw", 7), ("l_brow", 2), ("r_brow", 2), ("nose", 5),
                     ("l_eye", 3), ("r_eye", 3), ("mouth", 7)):
        p = tmp_path / f"basic_{part}_{pc}"
        with open(p, "wb") as f:
            pickle.dump(pdm(len(tfoa.PART_INDS[part]), pc), f, protocol=2)
        paths[part] = str(p)
    clm = obj("menpofit.clm.base", "CLM", shape_models=[pdm(68, 30)],
              opt={"numIter": 2, "kernel_covariance": 3})
    with open(tmp_path / "basic_all", "wb") as f:
        pickle.dump(clm, f, protocol=2)
    return paths, str(tmp_path / "basic_all")


def test_menpo_reader_on_menpo_named_pickles(tmp_path, monkeypatch):
    from animateportrait_tpu.io import menpo_pickle as jm
    from animateportrait_tpu_torch.io import menpo_pickle as tm
    rng = np.random.default_rng(5)
    paths, clm_path = _write_menpo_pickles(tmp_path, monkeypatch, rng)
    monkeypatch.undo()          # the readers must not need the modules
    assert "menpo" not in sys.modules
    parts_t = tm.load_reference_part_pdms(str(tmp_path), "basic")
    parts_j = jm.load_reference_part_pdms(str(tmp_path), "basic")
    for part in paths:
        a, b = parts_t[part], parts_j[part]
        for f in ("mean", "basis", "eigenvalues", "stored_target",
                  "stored_weights", "stored_sim_weights"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), (part, f)
        assert a.n_shape == b.n_shape and a.n_points == b.n_points
        sim, shape = a.basis[:a.n_sim], a.basis[a.n_sim:]
        rec = a.mean + sim.T @ a.stored_sim_weights \
            + shape.T @ a.stored_weights
        assert maxdiff(rec.reshape(-1, 2), a.stored_target) <= 1e-12
    (ct, ot), (cj, oj) = (tm.load_reference_clm(clm_path),
                          jm.load_reference_clm(clm_path))
    assert ot == oj and ct.n_shape == 30
    assert np.array_equal(ct.basis, cj.basis)
    rec = ct.mean + ct.basis.T @ np.concatenate(
        [ct.stored_sim_weights, ct.stored_weights])
    assert maxdiff(rec.reshape(-1, 2), ct.stored_target) <= 1e-12


# --- augmentation, targets and data ------------------------------------

def _outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:          # an empty corridor: rng.uniform refuses
        return ("ValueError", str(e))


def test_deformations_match_jax_draw_for_draw():
    """The chain and each part's deformation with the same Generator: the
    same landmarks (or the same refusal of an empty corridor), and the
    Generator left at the same state."""
    lms = _face_lms()
    for seed in range(6):
        for p in (0.0, 1.0):
            a = ttrain.deform_face_geometric_style(
                lms, np.random.default_rng(seed), p, p)
            b = jtrain.deform_face_geometric_style(
                lms, np.random.default_rng(seed), p, p)
            assert np.array_equal(a, b)
        for fn in ("deform_mouth", "deform_nose", "deform_eyes",
                   "deform_scale_face"):
            ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
            kw = (1.0,) if fn == "deform_scale_face" else (1.0, 1.0)
            a = _outcome(getattr(ttrain, fn), lms, ra, *kw)
            b = _outcome(getattr(jtrain, fn), lms, rb, *kw)
            assert type(a) is type(b)
            assert (a == b) if isinstance(a, tuple) else np.array_equal(a, b)
            assert ra.random() == rb.random()


@pytest.mark.parametrize("case", range(6))
def test_warp_affine_is_cv2_warp_affine(case):
    """Rotations with canvas expansion as augment_basic makes them, on
    float32 images of 1 and 3 channels and widths on and off the vector
    loop's 16 columns: byte-equal, and the matrix is
    ``getRotationMatrix2D``'s."""
    rng = np.random.default_rng(case)
    h, w = [(248, 248), (40, 37), (17, 90), (9, 5), (101, 64), (64, 31)][case]
    shape = (h, w, 3) if case % 2 == 0 else (h, w)
    img = rng.uniform(0, 1, shape).astype(np.float32)
    angle = float(rng.uniform(-30, 30))
    m = cv2.getRotationMatrix2D(((w - 1) / 2.0, (h - 1) / 2.0), angle, 1.0)
    assert np.array_equal(
        rotation_matrix_2d(((w - 1) / 2.0, (h - 1) / 2.0), angle, 1.0), m)
    nw = int(h * abs(m[0, 1]) + w * abs(m[0, 0]))
    nh = int(h * abs(m[0, 0]) + w * abs(m[0, 1]))
    m[0, 2] += nw / 2.0 - (w - 1) / 2.0
    m[1, 2] += nh / 2.0 - (h - 1) / 2.0
    assert np.array_equal(warp_affine(img, m, (nw, nh)),
                          cv2.warpAffine(img, m, (nw, nh)))


def test_augment_basic_is_the_jax_packages():
    """Crop, flip, rotation and resize with the same Generator: the image
    byte-equal to the JAX package's (cv2's), the landmarks exact."""
    img = np.random.default_rng(7).uniform(0, 1, (64, 64, 3)).astype(
        np.float32)
    lms = _face_lms(64)
    for seed in range(4):
        a = ttrain.augment_basic(img, lms, np.random.default_rng(seed),
                                 image_size=64)
        b = jtrain.augment_basic(img, lms, np.random.default_rng(seed),
                                 image_size=64)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_augment_geom_warps_and_refuses_to_hide_failures(monkeypatch):
    """The TPS warp within 2e-3 of the JAX package's (each solves the
    76-point r^2 log r system by an fp32 LU of its own), the landmarks
    exact; a singular system keeps the item; any other error raises."""
    img = np.random.default_rng(8).uniform(0, 1, (48, 48, 3)).astype(
        np.float32)
    lms = _face_lms(48)
    a = ttrain.augment_geom(img, lms, np.random.default_rng(1), 1.0, "cpu")
    b = jtrain.augment_geom(img, lms, np.random.default_rng(1), 1.0)
    assert np.array_equal(a[1], b[1])
    assert maxdiff(a[0], b[0]) <= 2e-3

    def singular(*args, **kw):
        raise torch.linalg.LinAlgError("singular")

    def broken(*args, **kw):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(ttrain, "warp_image_tps", singular)
    out = ttrain.augment_geom(img, lms, np.random.default_rng(1), 1.0, "cpu")
    assert out[0] is img and out[1] is lms
    monkeypatch.setattr(ttrain, "warp_image_tps", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        ttrain.augment_geom(img, lms, np.random.default_rng(1), 1.0, "cpu")


def test_approx_heatmaps_and_targets_match_jax():
    lms = _face_lms(64) + np.random.default_rng(9).uniform(-1, 1, (68, 2))
    lms[0] = [-3.0, 70.0]                       # off the canvas
    small, large = ttrain.make_foa_targets(lms, 64, sigma=4.0)
    js, jl = jtrain.make_foa_targets(lms, 64, sigma=4.0)
    amp = (8.0 / 3.0) / np.sqrt(2 * np.pi)
    assert maxdiff(small.transpose(1, 2, 0), js) <= 1e-6 * amp
    assert maxdiff(large.transpose(1, 2, 0), jl) <= 1e-6 * amp


def _write_foa_dir(root, n=3, size=80, jpeg=True):
    """ibug-style photos (PNG, and a baseline JPEG) with ``.pts`` files."""
    from animateportrait_tpu_torch.utils.jpeg import encode_jpeg
    rng = np.random.default_rng(10)
    out = []
    for i in range(n):
        lms = _face_lms(size) + rng.uniform(-2, 2, (68, 2))
        img = (rng.uniform(0, 255, (size, size + 6, 3))).astype(np.uint8)
        if jpeg and i == 1:
            with open(os.path.join(root, f"im{i}.jpg"), "wb") as f:
                f.write(encode_jpeg(img))
        else:
            write_png(os.path.join(root, f"im{i}.png"), img[:, :, ::-1])
        with open(os.path.join(root, f"im{i}.pts"), "w") as f:
            f.write("version: 1\nn_points: 68\n{\n")
            f.writelines(f"{x + 1:.6f} {y + 1:.6f}\n" for y, x in lms)
            f.write("}\n")
        out.append(lms)
    return out


def test_data_layer_matches_jax(tmp_path):
    """``.pts``, 300-W ``.mat`` boxes, margins, crops and the item list
    over PNG and JPEG photos (``read_image`` for ``cv2.imread``,
    ``resize_linear_float`` for ``cv2.resize``): exact."""
    from scipy.io import savemat
    lms = _write_foa_dir(str(tmp_path))
    assert np.array_equal(tdata.load_pts(str(tmp_path / "im0.pts")),
                          jdata.load_pts(str(tmp_path / "im0.pts")))
    assert maxdiff(tdata.load_pts(str(tmp_path / "im0.pts")), lms[0]) \
        <= 1e-5
    rec = np.zeros((1, 2), object)
    for i, name in enumerate(("im0.png", "im1.jpg")):
        box = np.array([[10.0 + i, 12.0, 60.0, 70.0 + i]])
        rec[0, i] = np.array([[(np.array([name]), box + 1, box + 2)]],
                             dtype=[("name", object), ("bb_detector", object),
                                    ("bb_ground_truth", object)])
    savemat(tmp_path / "bounding_boxes_test.mat", {"bounding_boxes": rec})
    mats = [str(tmp_path / "bounding_boxes_test.mat")]
    bt, bj = tdata.load_bb_files(mats), jdata.load_bb_files(mats)
    assert bt.keys() == bj.keys() == {"im0.png", "im1.jpg"}
    for k in bt:
        for a, b in zip(bt[k], bj[k]):
            assert np.array_equal(a, b)
    bb = np.array([[10.0, 20.0, 50.0, 40.0]])
    for hw in ((200, 200), (45, 52)):
        assert np.array_equal(tdata.center_margin_bb(bb, hw),
                              jdata.center_margin_bb(bb, hw))
    img = np.random.default_rng(11).uniform(0, 1, (70, 90, 3)).astype(
        np.float32)
    for box in (None, bb):
        a = tdata.crop_to_face_image(img, lms[0], bb=box, image_size=64)
        b = jdata.crop_to_face_image(img, lms[0], bb=box, image_size=64)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    for d in (None, bt):
        it, ij = (mod.load_foa_image_list(str(tmp_path), bb_dictionary=d,
                                          image_size=64)
                  for mod in (tdata, jdata))
        assert [i.path for i in it] == [i.path for i in ij]
        for a, b in zip(it, ij):
            assert np.array_equal(a.image, b.image)
            assert np.array_equal(a.lms, b.lms)


def test_epoch_batches_match_jax(tmp_path):
    """One augmented epoch (geometric p 0.5, basic on) from the same
    Generator: landmarks exact, images within 2e-3 (the fp32 TPS solve, as
    in ``augment_geom``'s test), maps within 1e-6 of their amplitude; NCHW
    against the JAX package's NHWC."""
    _write_foa_dir(str(tmp_path), n=4)
    items = tdata.load_foa_image_list(str(tmp_path), image_size=64)
    got = list(tdata.foa_epoch_batches(items, 2, np.random.default_rng(0),
                                       p_geom=0.5, image_size=64, sigma=4.0,
                                       device="cpu"))
    want = list(jdata.foa_epoch_batches(items, 2, np.random.default_rng(0),
                                        p_geom=0.5, image_size=64,
                                        sigma=4.0))
    assert len(got) == len(want) == 2
    for (gi, gs, gl, glm), (wi, ws, wl, wlm) in zip(got, want):
        assert gi.shape == (2, 3, 64, 64) and gs.shape == (2, 68, 16, 16)
        assert np.array_equal(glm, wlm)
        assert maxdiff(gi.transpose(0, 2, 3, 1), wi) <= 2e-3
        assert maxdiff(gs.transpose(0, 2, 3, 1), ws) <= 1e-6
        assert maxdiff(gl.transpose(0, 2, 3, 1), wl) <= 1e-6


def test_nme_and_evaluate_foa_match_jax():
    lms = _face_lms(32)
    gt = np.stack([lms, lms + 1.0])
    pred = gt + np.random.default_rng(12).normal(0, 2, gt.shape)
    assert np.array_equal(ttrain.nme_norm_eyes(pred, gt),
                          jtrain.nme_norm_eyes(pred, gt))
    jm, v, tm = _net_pair(nl=68, size=32, seed=5)
    imgs = np.random.default_rng(13).uniform(0, 1, (3, 32, 32, 3)).astype(
        np.float32)
    lms3 = np.stack([lms, lms + 1, lms - 1])
    state = jtrain.FOATrainState(step=jnp.zeros((), jnp.int32),
                                 params=v["params"], opt=None)
    want = jtrain.evaluate_foa(state, jtrain.FOATrainConfig(), imgs, lms3,
                               batch_size=2)
    assert abs(ttrain.evaluate_foa(tm, imgs, lms3, batch_size=2) - want) \
        <= 1e-12


@pytest.mark.parametrize("opt", ["adam_reg", "sgd"])
def test_foa_train_steps_match_jax(opt):
    """Three steps at lr_step 2 (the rate decays before the third): losses
    within rtol 1e-4 at each, the first step's gradients by ``grad_parity``
    with the port's float64 step (Adam: from its first moment), and the
    parameters after three steps within 1e-4 of their leaf's scale (SGD:
    of the port's float64 run, and of JAX's by ``grad_parity``'s float64
    rule)."""
    size = 32
    kw = dict(lr=1e-3, lr_step=2, gamma=0.5)
    kw.update(dict(reg=1e-3) if opt == "adam_reg" else dict(adam=False))
    cfg, jcfg = ttrain.FOATrainConfig(**kw), jtrain.FOATrainConfig(**kw)
    # torch's default init (the N(0, 0.05^2) test weights blow the
    # 1024-wide fusion banks up to NaN within two steps, in both packages)
    tm = ttrain.seeded_foa_net(cfg, 6)
    v = jfoa.load_foa_params(_tf_vars(tm.state_dict()))
    rng = np.random.default_rng(14)
    imgs = rng.uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    maps = [ttrain.make_foa_targets(_face_lms(size) + rng.uniform(
        -2, 2, (68, 2)), size, sigma=4.0) for _ in range(2)]
    small, large = (np.stack([m[j] for m in maps]) for j in (0, 1))
    state = jtrain.FOATrainState(step=jnp.zeros((), jnp.int32),
                                 params=v["params"],
                                 opt=jtrain._make_tx(jcfg).init(v["params"]))
    jstep = jtrain.build_foa_train_step(jcfg)
    tr = ttrain.FOATrainer(cfg, tm, device="cpu")
    tr64 = ttrain.FOATrainer(cfg, copy.deepcopy(tm).double(), device="cpu")
    args = (nchw(imgs), torch.from_numpy(small), torch.from_numpy(large))
    jargs = (jnp.asarray(imgs), jnp.asarray(small.transpose(0, 2, 3, 1)),
             jnp.asarray(large.transpose(0, 2, 3, 1)))
    for i in range(3):
        state, jl = jstep(state, *jargs)
        m = tr.step(*args)
        for k in ("l2_primary", "l2_fusion", "l2_upsample", "total"):
            assert abs(float(m[k]) - float(jl[k])) <= 1e-4 * abs(
                float(jl[k])), (i, k)
        tr64.step(*(a.double() for a in args))
        if i == 0:
            got = {k: p.grad for k, p in tr.model.named_parameters()}
            g64 = {k: p.grad for k, p in tr64.model.named_parameters()}
            if opt == "sgd":    # the momentum trace after one step is g
                jg = jax.tree_util.tree_leaves(
                    state.opt, is_leaf=lambda s: hasattr(s, "trace"))
                jg = next(s.trace for s in jg if hasattr(s, "trace"))
            else:
                jg = adam_grads(state.opt)
            ref = from_jax.artistic_heatmap_state_dict({"params": jg})
            errs = grad_parity(got, ref, g64, set())
            assert max(errs.values()) <= 1e-3, max(errs, key=errs.get)
            if cfg.adam:
                _params_match(tr.model, state.params, g64)
    assert tr.opt.param_groups[0]["lr"] == pytest.approx(
        1e-3 * 0.5 ** (3 // 2))
    if not cfg.adam:
        # JAX's XLA CPU step is not repeatable on a loaded machine (six
        # pytest-xdist workers: conv_1.bias 1.35-1.37e-4 of its scale from
        # float64 in 7 of 93 runs, where the port's was bit-equal in all):
        # each package's parameters against the port's float64 run
        want = from_jax.artistic_heatmap_state_dict({"params": state.params})
        got = dict(tr.model.named_parameters())
        p64 = dict(tr64.model.named_parameters())
        errs = grad_parity(got, want, p64, set(), bar=1e-4)
        assert max(errs.values()) <= 1e-4, max(errs, key=errs.get)
        errs64 = grad_parity(got, p64, None, set())
        assert max(errs64.values()) <= 1e-4, max(errs64, key=errs64.get)


def _params_match(model, params, g64=None):
    """Each parameter within 1e-4 of its leaf's scale; with ``g64`` (after
    one Adam step, which moves an element by ~lr whatever |g|) only where
    that step's float64 gradient is above 1e-3 of its leaf's largest: below
    (dead ReLUs, 0 up to rounding) fp32 noise picks the sign."""
    after = from_jax.artistic_heatmap_state_dict({"params": params})
    for k, p in model.named_parameters():
        d = (p.detach() - after[k]).abs()
        if g64 is not None:
            d = d[g64[k].abs() >= 1e-3 * g64[k].abs().max()]
        assert float(d.max()) <= 1e-4 * float(after[k].abs().max()), k


def test_train_foa_runs_checkpoints_and_matches_jax(tmp_path):
    """``train_foa`` over two items for 3 steps (batch 2, no augmentation)
    from the same weights and shuffle: the log lines, the validation NME
    within rtol 1e-2 of the JAX driver's (an argmax decode: one landmark
    that lands a pixel apart moves it by ~0.2%), checkpoints that
    restore; an undersized item list raises."""
    _write_foa_dir(str(tmp_path), n=2)
    items = tdata.load_foa_image_list(str(tmp_path), image_size=32)
    jm, v, tm = _net_pair(nl=68, size=32, seed=7)
    cfg = ttrain.FOATrainConfig(lr=1e-4)
    logs, jlogs = [], []
    tr = ttrain.train_foa(
        items, cfg, train_iter=3, batch_size=2, image_size=32, sigma=4.0,
        augment=False, valid_items=items, log_valid_every=1, print_every=1,
        save_every=2, checkpoint_dir=str(tmp_path / "ck"),
        trainer=ttrain.FOATrainer(cfg, tm, device="cpu"),
        log_fn=logs.append, device="cpu")
    jstate = jtrain.FOATrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"],
        opt=jtrain._make_tx(jtrain.FOATrainConfig(lr=1e-4)).init(
            v["params"]))
    jtrain.train_foa(items, jtrain.FOATrainConfig(lr=1e-4), train_iter=3,
                     batch_size=2, image_size=32, sigma=4.0, augment=False,
                     valid_items=items, log_valid_every=1, print_every=1,
                     state=jstate, log_fn=jlogs.append)
    assert tr.steps == 3 and len(logs) == len(jlogs)
    nme = [float(m.split("[")[-1].rstrip("]")) for m in logs if "valid" in m]
    jnme = [float(m.split("[")[-1].rstrip("]")) for m in jlogs
            if "valid" in m]
    np.testing.assert_allclose(nme, jnme, rtol=1e-2)
    from animateportrait_tpu_torch.io.checkpoint import CheckpointManager
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.all_steps() == [2, 3]
    back = ttrain.FOATrainer(cfg, tfoa.ArtisticHeatmapNet(), device="cpu")
    back.load_state_dict(mgr.restore(3, None))
    assert back.steps == 3
    for (k, a), b in zip(tr.model.state_dict().items(),
                         back.model.state_dict().values()):
        assert torch.equal(a, b), k
    with pytest.raises(ValueError, match="batch_size"):
        ttrain.train_foa([object()] * 3, train_iter=10, batch_size=4,
                         device="cpu")


def test_convergence_runner_foa_matches_the_jax_tool(monkeypatch):
    """train/convergence.py's face_of_art run at 3 steps from the JAX
    tool's initial weights: the first NME within rtol 1e-4, the last
    within rtol 1e-2."""
    from animateportrait_tpu_torch.train import convergence
    from torch_port_helpers import jax_tool_run
    (f, l), weights, _ = jax_tool_run("foa", 3, monkeypatch)
    got = convergence.run_foa(3, "cpu", weights)
    np.testing.assert_allclose(got[0], f, rtol=1e-4)
    np.testing.assert_allclose(got[1], l, rtol=1e-2)
