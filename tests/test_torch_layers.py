"""Layers and numerical ops of the PyTorch port against the JAX package on
the same inputs (made with numpy from a seed): nn, spectral, f0, filters,
geometry, warp, tps, the landmark dot images and the OpenCV-free resize.
Unless a test says otherwise the bound is max |diff| <= 1e-4 in fp32."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from animateportrait_tpu_torch.io import from_jax
from animateportrait_tpu.utils.smoke import random_variables
from torch_port_helpers import maxdiff, nchw, nhwc

ATOL = 1e-4


def _rng(seed=0):
    return np.random.default_rng(seed)


def test_instance_norm_module_matches_jax():
    from animateportrait_tpu.nn import InstanceNorm as JIN
    from animateportrait_tpu_torch.nn import InstanceNorm2d

    x = _rng().standard_normal((2, 12, 10, 6)).astype(np.float32)
    for relu in (False, True):
        ref = JIN(relu=relu).apply({}, jnp.asarray(x))
        got = nhwc(InstanceNorm2d(relu=relu)(nchw(x)))
        assert maxdiff(got, ref) <= 2e-6   # see test_torch_kernels


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("size", [(16, 16), (4, 4), (5, 7), (256, 256)])
def test_interpolate_bilinear_matches_jax(align_corners, size):
    # the port calls F.interpolate(mode="bilinear") where the JAX package
    # calls its band-matrix interpolate_bilinear
    from animateportrait_tpu.nn import interpolate_bilinear as jinterp

    x = _rng(1).standard_normal((2, 8, 8, 3)).astype(np.float32)
    ref = jinterp(jnp.asarray(x), size, align_corners=align_corners)
    got = nhwc(torch.nn.functional.interpolate(
        nchw(x), size=size, mode="bilinear", align_corners=align_corners))
    assert maxdiff(got, ref) <= 1e-5


def test_conv_transpose_and_reflect_conv_match_jax():
    from animateportrait_tpu.nn import Conv2dReflect, ConvTranspose2dTorch

    x = _rng(2).standard_normal((2, 9, 11, 6)).astype(np.float32)
    v = random_variables(lambda: ConvTranspose2dTorch(4).init(
        jax.random.key(0), jnp.zeros((1, 9, 11, 6))))
    ref = ConvTranspose2dTorch(4).apply(v, jnp.asarray(x))
    convt = torch.nn.ConvTranspose2d(6, 4, 3, 2, 1, output_padding=1)
    sd = {}
    from_jax._conv_transpose(sd, "m", v["params"])
    convt.load_state_dict({k[2:]: t for k, t in sd.items()})
    assert maxdiff(nhwc(convt(nchw(x))), ref) <= 1e-5

    v = random_variables(lambda: Conv2dReflect(5, 7).init(
        jax.random.key(0), jnp.zeros((1, 9, 11, 6))))
    ref = Conv2dReflect(5, 7).apply(v, jnp.asarray(x))
    conv = torch.nn.Sequential(torch.nn.ReflectionPad2d(3),
                               torch.nn.Conv2d(6, 5, 7))
    sd = {}
    from_jax._conv2d(sd, "1", v["params"])
    conv.load_state_dict(sd)
    assert maxdiff(nhwc(conv(nchw(x))), ref) <= 1e-5


def test_lstm_matches_jax():
    from animateportrait_tpu.nn import LSTM as JLSTM

    x = _rng(3).standard_normal((3, 20, 12)).astype(np.float32)
    jl = JLSTM(8, num_layers=2, bidirectional=True)
    v = random_variables(lambda: jl.init(jax.random.key(0), jnp.zeros((1, 4, 12))))
    ref, _ = jl.apply(v, jnp.asarray(x))
    tl = torch.nn.LSTM(12, 8, 2, batch_first=True, bidirectional=True)
    sd = {}
    from_jax._lstm(sd, "", v["params"], 2, bidirectional=True)
    tl.load_state_dict(sd)
    got, _ = tl(torch.from_numpy(x))
    assert maxdiff(got.detach(), ref) <= 1e-5


def test_spectral_helpers_match_jax():
    from animateportrait_tpu.ops import spectral as js
    from animateportrait_tpu_torch.ops import spectral as ts

    np.testing.assert_array_equal(ts.mel_filterbank(), js.mel_filterbank())
    np.testing.assert_array_equal(ts.hann_window(1024), js.hann_window(1024))
    rng = _rng(4)
    logf0 = np.log(rng.uniform(100, 300, 200)).astype(np.float32)
    voiced = rng.uniform(size=200) > 0.3
    ref = js.speaker_normalize_f0(jnp.asarray(logf0), jnp.asarray(voiced))
    got = ts.speaker_normalize_f0(torch.from_numpy(logf0),
                                  torch.from_numpy(voiced))
    assert maxdiff(got, ref) <= 1e-6
    # exact ties of the rounding (x * 255 at .5) must round half to even
    x = np.concatenate([np.asarray(got), [0.5 / 255, 1.5 / 255, -1.0]]
                       ).astype(np.float32)
    np.testing.assert_array_equal(
        ts.quantize_f0_onehot(torch.from_numpy(x)).numpy(),
        np.asarray(js.quantize_f0_onehot(jnp.asarray(x))))


def test_track_f0_matches_jax():
    from animateportrait_tpu.ops.f0 import track_f0 as jtrack
    from animateportrait_tpu_torch.ops.f0 import track_f0
    from animateportrait_tpu_torch.pipeline.audio import (
        condition_signal, normalize_dbfs)
    from animateportrait_tpu_torch.utils.smoke import make_wav

    w = condition_signal(normalize_dbfs(make_wav(1.0, seed=3))).astype(
        np.float32)
    ref_l, ref_v = jtrack(jnp.asarray(w), lo=100.0, hi=600.0)
    got_l, got_v = track_f0(torch.from_numpy(w), lo=100.0, hi=600.0)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
    both = np.asarray(ref_v)
    assert both.sum() > 10
    assert maxdiff(got_l.numpy()[both], np.asarray(ref_l)[both]) <= 1e-4


@pytest.mark.parametrize("window", [5, 15, 31])
def test_savgol_matches_jax(window):
    from animateportrait_tpu.ops.filters import savgol_filter as jsav
    from animateportrait_tpu_torch.ops.filters import savgol_filter

    x = _rng(5).standard_normal((60, 204)).astype(np.float32)
    ref = jsav(jnp.asarray(x), window, 3, axis=0)
    assert maxdiff(savgol_filter(torch.from_numpy(x), window, 3), ref) <= 1e-5


def test_geometry_matches_jax():
    from animateportrait_tpu.ops import geometry as jg
    from animateportrait_tpu.utils import assets
    from animateportrait_tpu_torch.ops import geometry as tg

    rng = _rng(6)
    pts = rng.standard_normal((7, 8, 2)).astype(np.float32)
    assert maxdiff(tg.area_of_signed_polygon(torch.from_numpy(pts)),
                   jg.area_of_signed_polygon(jnp.asarray(pts))) <= 1e-6
    face = assets.std_face_landmarks() * 100 + 256
    for a, b in zip(tg.norm_input_face(face, assets.std_face_landmarks()),
                    jg.norm_input_face(face, assets.std_face_landmarks())):
        np.testing.assert_array_equal(a, b)
    fl = rng.standard_normal((200, 68, 3))
    np.testing.assert_array_equal(
        tg.add_naive_eye(fl, np.random.default_rng(1)),
        jg.add_naive_eye(fl, np.random.default_rng(1)))


@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_and_flow_warp_match_jax(align_corners):
    from animateportrait_tpu.ops import warp as jw
    from animateportrait_tpu_torch.ops import warp as tw

    rng = _rng(7)
    img = rng.standard_normal((2, 16, 20, 5)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (2, 16, 20, 2)).astype(np.float32)
    ref = jw.grid_sample(jnp.asarray(img), jnp.asarray(grid),
                         align_corners=align_corners)
    # the port calls torch's operator, which the JAX sampler reproduces
    got = torch.nn.functional.grid_sample(nchw(img), torch.from_numpy(grid),
                                          align_corners=align_corners)
    assert maxdiff(nhwc(got), ref) <= 1e-5
    flow = rng.uniform(-4, 4, (2, 16, 20, 2)).astype(np.float32)
    mask = rng.uniform(0, 1, (2, 16, 20, 1)).astype(np.float32)
    ref = jw.warp_acc_flow(jnp.asarray(img), jnp.asarray(flow),
                           mask=jnp.asarray(mask))
    got = tw.warp_acc_flow(nchw(img), nchw(flow), mask=nchw(mask))
    assert maxdiff(nhwc(got), ref) <= 1e-5


def test_double_feature_warping_matches_jax():
    from animateportrait_tpu.models.gan import double_feature_warping as jd
    from animateportrait_tpu_torch.models.gan import double_feature_warping

    rng = _rng(8)
    motion = rng.uniform(-1, 1, (2, 32, 32, 2)).astype(np.float32)
    flow = rng.uniform(-3, 3, (2, 32, 32, 2)).astype(np.float32)
    mask = rng.uniform(0, 1, (2, 32, 32, 1)).astype(np.float32)
    for level in (0, 1, 2):
        s = 32 >> level
        x = rng.standard_normal((2, s, s, 4)).astype(np.float32)
        ref = jd(jnp.asarray(x), jnp.asarray(motion), jnp.asarray(flow),
                 jnp.asarray(mask), level)
        got = double_feature_warping(nchw(x), torch.from_numpy(motion),
                                     nchw(flow), nchw(mask), level)
        assert maxdiff(nhwc(got), ref) <= 1e-5, level


def _face(rng, jitter=2.0):
    from animateportrait_tpu.utils import assets

    std = assets.std_face_landmarks()[:, :2] * np.array([1, -1])
    lm = (std - std.mean(0)) / np.ptp(std[:, 0]) * 110 + 128
    return (lm + rng.uniform(-jitter, jitter, lm.shape)).astype(np.float32)


def test_linear_motion_grid_matches_jax():
    from animateportrait_tpu.ops import tps as jt
    from animateportrait_tpu_torch.ops import tps as tt

    rng = _rng(9)
    src = _face(rng)[None]
    dst = np.stack([_face(rng), _face(rng)])
    tri = tt.triangulate_frames(dst, 256)
    np.testing.assert_array_equal(tri, jt.triangulate_frames(dst, 256))
    ref = jt.linear_motion_grid(jnp.asarray(np.repeat(src, 2, 0)),
                                jnp.asarray(dst), jnp.asarray(tri), 256)
    got = tt.linear_motion_grid(torch.from_numpy(src).expand(2, 68, 2),
                                torch.from_numpy(dst), torch.from_numpy(tri),
                                256)
    # < 1e-2 px, the bound the JAX package holds its grid to against
    # scipy griddata (tests/test_composed_parity.py)
    assert maxdiff(got, ref) * 127.5 < 1e-2


def test_landmark_dots_and_disc_table_match_cv2_and_jax():
    from animateportrait_tpu.pipeline.render import (
        _cv2_disc_halfwidths, draw_landmarks, landmark_dot_images as jdots)
    from animateportrait_tpu_torch.pipeline.render import (
        DISC_HALFWIDTHS_R3, landmark_dot_images)

    assert tuple(_cv2_disc_halfwidths(3)) == DISC_HALFWIDTHS_R3  # cv2.circle
    rng = _rng(10)
    lm = np.stack([_face(rng, 30.0), _face(rng, 30.0)])
    lm[0, 0] = [2.5, 3.5]           # half-way coordinates: round half even
    lm[0, 1] = [254.6, 1.2]         # dots clipped at the border
    got = landmark_dot_images(torch.from_numpy(lm), 256)
    np.testing.assert_array_equal(nhwc(got), np.asarray(
        jdots(jnp.asarray(lm), 256)))
    np.testing.assert_array_equal(nhwc(got)[1], draw_landmarks(256, 256,
                                                               lm[1]))


@pytest.mark.parametrize("shape,out", [((440, 440, 3), (512, 512)),
                                       ((512, 512, 3), (256, 256)),
                                       ((37, 53), (91, 20))])
def test_resize_bicubic_matches_cv2(shape, out):
    import cv2

    from animateportrait_tpu_torch.utils.image import resize_bicubic

    img = _rng(11).integers(0, 256, shape).astype(np.uint8)
    got = resize_bicubic(img, out).astype(int)
    ref = cv2.resize(img, (out[1], out[0]),
                     interpolation=cv2.INTER_CUBIC).astype(int)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1      # within one uint8 level
    # and almost everywhere exact: fp32 summation order flips ~1e-5 of an
    # upscale's pixels; downscales are bit-exact
    assert (got != ref).mean() < (1e-4 if out[0] > shape[0] else 1e-12)
