"""The image-translation trainer of the PyTorch port against the JAX
package: the ResUnet in both modes, VGG19's slices, the Gram matrix and
the VGG losses, the GMM and its grids, one trainer step, the weights'
round trips; the landmark drawings byte-equal to the JAX package's
OpenCV drawing, the datasets item for item, the STFT map, and the float
INTER_LINEAR resize byte-equal to cv2's. Bounds are stated per test."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from animateportrait_tpu_torch.io import from_jax
from animateportrait_tpu_torch.models import image_translation as tit
from animateportrait_tpu_torch.train import image_translation as tti
from test_torch_module1 import _check_step, f64_grads
from torch_port_helpers import (
    adam_grads, assert_as_exact_as_jax, f64_run, maxdiff, nchw, nhwc,
    port_stats_match, random_jax_variables)

K = jax.random.key(0)


def _fresh(net, sd):
    """A copy of ``net`` with the state ``sd`` (before a training-mode pass
    moved its statistics)."""
    import copy
    other = copy.deepcopy(net)
    other.load_state_dict(sd)
    return other


def _resunet_vars(ngf=4, num_downs=5, size=32):
    from animateportrait_tpu.models.image_translation import ResUnetGenerator
    return random_jax_variables(lambda: ResUnetGenerator(
        num_downs=num_downs, ngf=ngf).init(K, jnp.zeros((1, size, size, 6))),
        seed=6)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("num_downs", [5, 6])
def test_resunet_matches_jax_and_round_trips(train, num_downs):
    """ngf 4 at 64^2, batch 2: every key of the port's module is written;
    the output within 1e-4 (in training mode, where the inner levels'
    batch statistics are over 2 x 2^2 values or fewer and both packages
    are ~2e-4 from float64: ``assert_as_exact_as_jax``); the statistics
    it leaves within 1e-4 of their scale."""
    from animateportrait_tpu.models.image_translation import ResUnetGenerator
    v = _resunet_vars(num_downs=num_downs, size=64)
    sd = from_jax.resunet_state_dict(v)
    net = tit.ResUnetGenerator(ngf=4, num_downs=num_downs)
    assert set(sd) == set(net.state_dict())
    net.load_state_dict(sd)
    x = np.random.default_rng(1).standard_normal((2, 64, 64, 6)).astype(
        np.float32)
    jm = ResUnetGenerator(num_downs=num_downs, ngf=4)
    if train:
        ref, upd = jm.apply(v, jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
    else:
        ref = jm.apply(v, jnp.asarray(x))
    got = net.train(train)(nchw(x))
    if train:
        assert_as_exact_as_jax(nhwc(got), ref, nhwc(f64_run(
            _fresh(net, sd), nchw(x), train=True)), 1e-4)
    else:
        assert maxdiff(nhwc(got), ref) <= 1e-4
    if train:
        port_stats_match(net, from_jax.resunet_state_dict(
            {"params": v["params"], "batch_stats": upd["batch_stats"]}))


def _vgg():
    from animateportrait_tpu.models.image_translation import Vgg19Features
    v = random_jax_variables(lambda: Vgg19Features().init(
        K, jnp.zeros((1, 32, 32, 3))), seed=7)
    net = tit.Vgg19Features()
    sd = from_jax.vgg19_state_dict(v)
    assert set(sd) == set(net.state_dict())
    net.load_state_dict(sd)
    return v, net.eval()


def test_vgg19_slices_gram_and_losses_match_jax():
    """The 5 slices within 1e-4 of their scale; gram_matrix within 1e-6;
    vgg_loss's perceptual and style terms within rtol 1e-4."""
    from animateportrait_tpu.models import image_translation as jit_
    v, net = _vgg()
    rng = np.random.default_rng(2)
    x, y = (rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
            for _ in range(2))
    ref = jit_.Vgg19Features().apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = net(nchw(x))
    assert len(got) == len(ref) == 5
    for g, r in zip(got, ref):
        assert maxdiff(nhwc(g), r) <= 1e-4 * float(jnp.max(jnp.abs(r)))
    f = rng.standard_normal((2, 6, 5, 4)).astype(np.float32)
    assert maxdiff(tit.gram_matrix(nchw(f)),
                   jit_.gram_matrix(jnp.asarray(f))) <= 1e-6
    lv, ls = jit_.vgg_loss(v, jnp.asarray(x), jnp.asarray(y), style=True)
    gv, gs = tit.vgg_loss(net, nchw(x), nchw(y), style=True)
    np.testing.assert_allclose(float(gv), float(lv), rtol=1e-4)
    np.testing.assert_allclose(float(gs), float(ls), rtol=1e-4)


def test_image_translation_step_matches_jax():
    """One step (ngf 4, num_downs 5, 64^2, batch 4, VGG on: the JAX
    convergence tool's widths but ngf): the loss terms within rtol 1e-4
    and _check_step's bars. At random VGG weights the style term (~2e7)
    takes the difference of near-equal Gram matrices, and the fp32
    gradients are up to ~9% (JAX's) and ~1.4% (the port's) of their scale
    from float64, so those leaves are held to the float64 run."""
    from animateportrait_tpu.train.image_translation import (
        ImageTranslationConfig, ImageTranslationState,
        build_image_translation_train_step)
    cfg = ImageTranslationConfig(num_downs=5, ngf=4, lr=1e-3)
    v = _resunet_vars(size=64)
    vgg_v, vgg = _vgg()
    state = ImageTranslationState(step=jnp.zeros((), jnp.int32),
                                  variables=v,
                                  opt=optax.adam(cfg.lr).init(v["params"]))
    rng = np.random.default_rng(3)
    xin = rng.uniform(-1, 1, (4, 64, 64, 6)).astype(np.float32)
    xout = rng.uniform(-1, 1, (4, 64, 64, 3)).astype(np.float32)
    s1, m = jax.jit(build_image_translation_train_step(cfg, vgg_v))(
        state, jnp.asarray(xin), jnp.asarray(xout))
    tcfg = tti.ImageTranslationConfig(num_downs=5, ngf=4, lr=1e-3)
    net = tti.build_generator(tcfg)
    net.load_state_dict(from_jax.resunet_state_dict(v))

    class _WithVgg(tti.ImageTranslationTrainer):
        def __init__(self, cfg, model, device="cpu"):
            import copy
            super().__init__(cfg, model, copy.deepcopy(vgg).to(
                next(model.parameters()).dtype), device=device)

    batch = (nchw(xin), nchw(xout))
    g64 = f64_grads(_WithVgg, tcfg, net, *batch)
    got = tti.ImageTranslationTrainer(tcfg, net, vgg, device="cpu").step(
        *batch)
    for k in ("l1", "vgg", "style"):
        np.testing.assert_allclose(float(got[k]), float(m[k]), rtol=1e-4)
    _check_step(net, from_jax.resunet_state_dict, s1.variables["params"],
                s1.variables["batch_stats"], adam_grads(s1.opt), m["loss"],
                got["loss"], cfg.lr, grads_f64=g64)


# --- the GMM ---------------------------------------------------------------

def test_gmm_grids_and_correlation_match_jax():
    """feature_l2_norm and feature_correlation within 1e-5, affine_grid and
    tps_grid within 1e-5."""
    from animateportrait_tpu.models import image_translation as jit_
    rng = np.random.default_rng(4)
    fa, fb = (rng.standard_normal((2, 4, 3, 8)).astype(np.float32)
              for _ in range(2))
    na, nb = jit_.feature_l2_norm(jnp.asarray(fa)), \
        jit_.feature_l2_norm(jnp.asarray(fb))
    ta, tb = tit.feature_l2_norm(nchw(fa)), tit.feature_l2_norm(nchw(fb))
    assert maxdiff(nhwc(ta), na) <= 1e-5
    assert maxdiff(nhwc(tit.feature_correlation(ta, tb)),
                   jit_.feature_correlation(na, nb)) <= 1e-5
    theta = rng.normal(0, 0.2, (2, 2, 3)).astype(np.float32)
    theta[:, 0, 0] += 1
    theta[:, 1, 1] += 1
    assert maxdiff(tit.affine_grid(torch.from_numpy(theta), (16, 12)),
                   jit_.affine_grid(jnp.asarray(theta), (16, 12))) <= 1e-5
    off = rng.normal(0, 0.1, (2, 18)).astype(np.float32)
    assert maxdiff(tit.tps_grid(torch.from_numpy(off), (16, 12)),
                   jit_.tps_grid(jnp.asarray(off), (16, 12))) <= 1e-5


@pytest.mark.parametrize("train", [False, True])
def test_gmm_matches_jax_and_round_trips(train):
    """The GMM at its 256 x 192 (inputs of 2 and 1 channels, batch 2): the
    grid and theta within 1e-4; every key of the port's module written;
    the statistics within 1e-4 of their scale in training mode."""
    from animateportrait_tpu.models.image_translation import GMM
    rng = np.random.default_rng(5)
    a = rng.standard_normal((2, 256, 192, 2)).astype(np.float32)
    b = rng.standard_normal((2, 256, 192, 1)).astype(np.float32)
    v = random_jax_variables(lambda: GMM().init(
        K, jnp.zeros((1, 256, 192, 2)), jnp.zeros((1, 256, 192, 1))),
        seed=8)
    sd = from_jax.gmm_state_dict(v)
    net = tit.GMM(input_nc_a=2, input_nc_b=1)
    assert set(sd) == set(net.state_dict())
    net.load_state_dict(sd)
    if train:
        ref, upd = GMM().apply(v, jnp.asarray(a), jnp.asarray(b),
                               train=True, mutable=["batch_stats"])
    else:
        ref = GMM().apply(v, jnp.asarray(a), jnp.asarray(b))
    got = net.train(train)(nchw(a), nchw(b))
    for g, r in zip(got, ref):
        assert maxdiff(g.detach(), r) <= 1e-4
    if train:
        port_stats_match(net, from_jax.gmm_state_dict(
            {"params": v["params"], "batch_stats": upd["batch_stats"]}))


# --- drawings, datasets, the STFT map and the float resize ------------------

def _lms(rng, n=68, size=256, margin=-20):
    from animateportrait_tpu.utils.assets import std_face_landmarks
    base = std_face_landmarks().reshape(68, 3)[:, :2]
    base = (base - base.min(0)) / np.ptp(base) * size * 0.7 + size * 0.15
    if n != 68:
        base = np.concatenate([base, base[: n - 68] + 3], 0)
    # some points past the borders, and non-integers
    return base + rng.uniform(margin, 20, (n, 2))


@pytest.mark.parametrize("size,linewidth", [(256, 2), (512, 2), (256, 3)])
def test_landmark_drawings_equal_opencv(size, linewidth):
    """vis_landmark and vis_landmark_on_img{,98,74} byte-equal to the JAX
    package's cv2 drawing."""
    from animateportrait_tpu.utils import vis as jv
    from animateportrait_tpu_torch.utils import vis as tv
    rng = np.random.default_rng(size + linewidth)
    lm = _lms(rng, size=size)
    assert np.array_equal(tv.vis_landmark(size, size, lm, linewidth),
                          jv.vis_landmark(size, size, lm, linewidth))
    for n, jf, tf in ((68, jv.vis_landmark_on_img, tv.vis_landmark_on_img),
                      (98, jv.vis_landmark_on_img98,
                       tv.vis_landmark_on_img98),
                      (74, jv.vis_landmark_on_img74,
                       tv.vis_landmark_on_img74)):
        lm = _lms(rng, n=n, size=size)
        canvas = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        want = jf(canvas.copy(), lm, linewidth)
        got = tf(canvas.copy(), lm, linewidth)
        assert np.array_equal(got, want), n


def test_landmark_sequence_video_round_trips(tmp_path):
    """The preview AVI's frames are vis_landmark's, RGB, parsed back by
    ``read_avi``, with the audio track."""
    from animateportrait_tpu_torch.utils import vis as tv
    from animateportrait_tpu_torch.utils.video import read_avi
    rng = np.random.default_rng(0)
    fls = np.stack([_lms(rng, size=256) for _ in range(3)])
    wav = (np.sin(np.arange(1600) / 10) * 0.3).astype(np.float32)
    path = tv.landmark_sequence_video(str(tmp_path / "p.avi"), fls, wav,
                                      size=256, fps=25)
    avi = read_avi(path)
    assert len(avi["frames"]) == 3
    for f, lm in zip(avi["frames"], fls):
        assert np.array_equal(f, tv.vis_landmark(256, 256, lm)[:, :, ::-1])


def _frames(rng, n, size):
    return rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)


@pytest.mark.parametrize("n_lm", [68, 98])
def test_image_translation_dataset_matches_jax_exactly(n_lm):
    from animateportrait_tpu.data import image_translation as jd
    from animateportrait_tpu_torch.data import image_translation as td
    rng = np.random.default_rng(n_lm)
    frames = _frames(rng, 5, 256)
    lms = np.stack([_lms(rng, n=n_lm) for _ in range(5)])
    j = jd.ImageTranslationDataset(frames, lms)
    t = td.ImageTranslationDataset(frames, lms)
    a = j.batch([0, 3, 4], np.random.default_rng(1))
    b = t.batch([0, 3, 4], np.random.default_rng(1))
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_with_audio_dataset_and_stft_map_match_jax_exactly():
    """The STFT map exactly; each draw's images exactly and its resized
    audio windows byte-equal (float32 samples, so a float32 map)."""
    from animateportrait_tpu.data import image_translation as jd
    from animateportrait_tpu_torch.data import image_translation as td
    rng = np.random.default_rng(7)
    n = 20
    frames = _frames(rng, n, 64)
    lms = np.stack([_lms(rng, size=64, margin=0) for _ in range(n)])
    wav = (rng.standard_normal(16000 * n // 25 + 640) * 0.1).astype(
        np.float32)
    assert np.array_equal(td.audio_stft_map(wav), jd.audio_stft_map(wav))
    j = jd.ImageTranslationWithAudioDataset(frames, lms, wav, num_frames=3)
    t = td.ImageTranslationWithAudioDataset(frames, lms, wav, num_frames=3)
    for seed in range(3):
        a = j.sample_with_audio(np.random.default_rng(seed))
        b = t.sample_with_audio(np.random.default_rng(seed))
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("shape,out", [((321, 80), (256, 256)),
                                       ((321, 80), (224, 224)),
                                       ((40, 33), (17, 90)),
                                       ((50, 60), (100, 120)),
                                       ((70, 45, 3), (64, 64))])
def test_resize_linear_float_equals_cv2(shape, out):
    """float32 planes and 3-channel images byte-equal to cv2.resize
    (INTER_LINEAR, IPP on as OpenCV runs by default); float64 within 1e-13
    of it."""
    import cv2
    from animateportrait_tpu_torch.utils.image import resize_linear_float
    rng = np.random.default_rng(shape[0] + out[0])
    x = rng.standard_normal(shape).astype(np.float32)
    want = cv2.resize(x, (out[1], out[0]))
    got = resize_linear_float(x, out)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    x64 = x.astype(np.float64)
    assert maxdiff(resize_linear_float(x64, out),
                   cv2.resize(x64, (out[1], out[0]))) <= 1e-13


def test_convergence_runner_matches_the_jax_tool(monkeypatch):
    """train/convergence.py's image-translation run at 3 steps from the
    JAX tool's initial weights: the first L1 within rtol 1e-4, the last
    within rtol 1e-2 (as the content run's test states)."""
    from animateportrait_tpu_torch.train import convergence
    from torch_port_helpers import jax_tool_run
    (f, l), weights, _ = jax_tool_run("imtrans", 3, monkeypatch)
    got = convergence.run_image_translation(3, "cpu", weights)
    np.testing.assert_allclose(got[0], f, rtol=1e-4)
    np.testing.assert_allclose(got[1], l, rtol=1e-2)


def test_show_bboxes_equals_opencv():
    """Boxes (inside, across the borders, degenerate) and 5-point
    landmarks byte-equal to the JAX package's cv2.rectangle/cv2.circle
    drawing, on 40 random images."""
    from animateportrait_tpu.utils import vis as jv
    from animateportrait_tpu_torch.utils import vis as tv
    rng = np.random.default_rng(11)
    for _ in range(40):
        h, w = (int(v) for v in rng.integers(20, 120, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        n = 3
        x1, y1 = rng.uniform(-20, w, n), rng.uniform(-20, h, n)
        boxes = np.stack([x1, y1, x1 + rng.uniform(0, 60, n),
                          y1 + rng.uniform(0, 60, n), rng.random(n)], 1)
        boxes[0, 2:4] = boxes[0, :2]                 # a point
        lms = np.concatenate([rng.uniform(-5, w + 5, (n, 5)),
                              rng.uniform(-5, h + 5, (n, 5))], 1)
        assert np.array_equal(tv.show_bboxes(img, boxes, lms),
                              jv.show_bboxes(img, boxes, lms))
    assert np.array_equal(tv.show_bboxes(img, boxes),
                          jv.show_bboxes(img, boxes))
