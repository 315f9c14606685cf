"""The last functions of the JAX package that the port lacked, against the
JAX functions on the same seeded inputs, each at the tolerance of the JAX
package's own test of the function where it has one:

- ``ops/spectral.py:mel_spectrogram`` (through K1's wrapper, its plain
  version on the CPU) and ``pipeline/audio.py:extract_mel_and_f0``: atol
  2e-4 (``tests/test_audio_pipeline.py:109-134``);
  ``extract_stft_features``, the same host numpy/scipy: exact;
- ``ops/filters.py:hann_smooth``: atol 1e-5
  (``tests/test_landmark_post.py:212-225``);
- ``ops/geometry.py:close_input_face_mouth``: atol 1e-12
  (``tests/test_geometry_post.py:77``);
- ``ops/warp.py:sample_nearest`` and ``F.grid_sample(mode="nearest")``
  against JAX's ``sample_nearest`` / ``grid_sample(mode="nearest")``,
  at random and at exact .5 coordinates, inside and outside the image:
  exact (``tests/test_warp.py`` allows 2% of ties to differ; none does);
- ``pipeline/render.py:test_window``: exact (``tests/test_render.py:41-43``);
- ``utils/video.py:write_video``: the port's Motion-JPEG AVI read back
  by the port's reader (byte-equal to ``cv2.VideoCapture``) against the
  JAX function's file read by OpenCV: each frame no farther from the
  frames written than JAX's, and gray frames PSNR >= 40 dB from JAX's
  (``tests/test_end2end.py:165-170`` counts frames; the two write
  different JPEG encoders' frames, so no byte equality); the uint8 gray
  frames of that test;
- ``utils/observe.py``: ``Record`` exactly
  (``tests/test_image_translation.py:73``), ``grad_norms`` at atol 1e-6
  (``tests/test_checkpoint.py:51``), ``profile_trace`` (a torch profiler
  trace, no JAX counterpart to compare: the JAX one writes an XProf
  trace) by what its file holds;
- ``entry.py:entry`` at ngf 8 against JAX's ``TridentGeneratorFullIFW`` at
  ngf 8 on converted weights, on the JAX entry's example inputs: PSNR >=
  40 dB (``tests/test_composed_parity.py:281``).
"""
import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from animateportrait_tpu_torch.utils.smoke import make_wav
from torch_port_helpers import nchw, nhwc, psnr

MEL_ATOL = 2e-4
VIDEO_MIN_PSNR = 40.0
ENTRY_MIN_PSNR = 40.0


@pytest.mark.parametrize("lead", [(), (2,)])
def test_mel_spectrogram_matches_jax(lead):
    from animateportrait_tpu.ops.spectral import mel_spectrogram as jmel
    from animateportrait_tpu_torch.ops.spectral import mel_spectrogram

    rng = np.random.default_rng(len(lead))
    x = (0.1 * rng.standard_normal((*lead, 16000 + 77))).astype(np.float32)
    want = np.asarray(jmel(jnp.asarray(x)))
    got = mel_spectrogram(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (*lead, 16077 // 256 + 1, 80)
    np.testing.assert_allclose(got, want, rtol=0, atol=MEL_ATOL)


def test_extract_mel_and_f0_and_stft_features_match_jax():
    from animateportrait_tpu.pipeline import audio as jaudio
    from animateportrait_tpu_torch.pipeline import audio as taudio

    wav = make_wav(0.5, seed=3)
    s, f0 = taudio.extract_mel_and_f0(wav, "F", seed=0, device="cpu")
    js, jf0 = jaudio.extract_mel_and_f0(wav, "F", seed=0)
    np.testing.assert_allclose(s, js, rtol=0, atol=MEL_ATOL)
    np.testing.assert_allclose(f0, jf0, rtol=0, atol=MEL_ATOL)
    assert (f0 >= 0).any()                        # some frames voiced
    for fps in (25, 30):
        got = taudio.extract_stft_features(wav, fps)
        want = jaudio.extract_stft_features(wav, fps)
        assert got.shape[1] == (161 if fps == 25 else 179)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,window_len", [(40, 11), (25, 7)])
def test_hann_smooth_matches_jax(n, window_len):
    from animateportrait_tpu.ops.filters import hann_smooth as jsmooth
    from animateportrait_tpu_torch.ops.filters import hann_smooth

    x = np.random.default_rng(7).standard_normal(n).astype(np.float32)
    got = hann_smooth(torch.from_numpy(x), window_len).numpy()
    want = np.asarray(jsmooth(jnp.asarray(x), window_len))
    assert got.shape == (n + window_len - 1,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_close_input_face_mouth_matches_jax():
    from animateportrait_tpu.ops.geometry import close_input_face_mouth as j
    from animateportrait_tpu_torch.ops.geometry import close_input_face_mouth

    shape = np.random.default_rng(1).uniform(-1, 1, (68, 3))
    got = close_input_face_mouth(shape)
    assert not np.allclose(got, shape)
    np.testing.assert_allclose(got, j(shape), rtol=0, atol=1e-12)
    np.testing.assert_allclose(close_input_face_mouth(shape, 0.3, 0.9),
                               j(shape, 0.3, 0.9), rtol=0, atol=1e-12)


def _nearest_grids(rng, n, h, w, align_corners):
    """Random normalized grids in [-1.3, 1.3], and grids whose pixel
    coordinates are exact halves k + 0.5 for k in [-3, size + 1]."""
    rand = rng.uniform(-1.3, 1.3, (n, 7, 8, 2)).astype(np.float32)
    k = rng.integers(-3, max(h, w) + 2, (n, 7, 8, 2)) + 0.5
    size = np.array([w, h], np.float64)
    half = (k / (size - 1) * 2 - 1 if align_corners
            else (2 * k + 1) / size - 1).astype(np.float32)
    return rand, half


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_nearest_sampling_matches_jax_at_ties(align_corners, padding_mode):
    from animateportrait_tpu.ops import warp as jwarp
    from animateportrait_tpu_torch.ops.warp import sample_nearest

    rng = np.random.default_rng(0)
    n, h, w, c = 2, 9, 11, 3
    img = rng.standard_normal((n, h, w, c)).astype(np.float32)
    timg = nchw(img)
    for grid in _nearest_grids(rng, n, h, w, align_corners):
        want = np.asarray(jwarp.grid_sample(
            jnp.asarray(img), jnp.asarray(grid), mode="nearest",
            padding_mode=padding_mode, align_corners=align_corners))
        got = F.grid_sample(timg, torch.from_numpy(grid), mode="nearest",
                            padding_mode=padding_mode,
                            align_corners=align_corners)
        np.testing.assert_array_equal(nhwc(got), want)
        # the pixel coordinates JAX samples at, through both samplers
        ix = np.array(jwarp._unnormalize(jnp.asarray(grid[..., 0]), w,
                                         align_corners))
        iy = np.array(jwarp._unnormalize(jnp.asarray(grid[..., 1]), h,
                                         align_corners))
        jn = np.asarray(jwarp.sample_nearest(
            jnp.asarray(img), jnp.asarray(iy), jnp.asarray(ix),
            padding_mode))
        tn = sample_nearest(timg, torch.from_numpy(iy),
                            torch.from_numpy(ix), padding_mode)
        np.testing.assert_array_equal(nhwc(tn), jn)
        np.testing.assert_array_equal(jn, want)
    # the exact halves reach both sides of the image
    frac = np.abs(iy - np.floor(iy) - 0.5)
    assert frac.max() < 1e-6 and iy.min() < -1 and iy.max() > h


def test_test_window_matches_jax():
    from animateportrait_tpu.pipeline import render as jrender
    from animateportrait_tpu_torch.pipeline import render as trender

    for size in (256, 512, 300):
        np.testing.assert_array_equal(trender.test_window(size),
                                      jrender.test_window(size))
    np.testing.assert_array_equal(trender.test_window(256),
                                  [38, 217, 51, 230])


def _frames(kind, n=4, size=256):
    """RGB uint8 frames: "preview", the coloured landmark drawings of
    ``landmark_sequence_video`` on a smooth background; "drawing", the
    same in gray, as the drawing renderer's 1-channel frames are; "smooth",
    a smooth gray field."""
    from animateportrait_tpu_torch.utils.vis import vis_landmark

    rng = np.random.default_rng(2)
    base = rng.uniform(0.3, 0.7, (68, 2)) * size
    yy, xx = np.mgrid[:size, :size] / size
    frames = []
    for t in range(n):
        if kind == "smooth":
            f = 128 + 100 * np.sin(4 * xx + t) * np.cos(3 * yy)
            frames.append(np.repeat(f[..., None], 3, -1))
            continue
        lm = base + rng.normal(0, 1.0, base.shape)
        img = vis_landmark(size, size, lm)[:, :, ::-1].astype(np.float64)
        shade = 40 * (1 + np.sin(3 * xx + t))[..., None] * (1 + yy[..., None])
        f = img * 0.7 + shade
        frames.append(f if kind == "preview" else np.repeat(
            f.mean(-1, keepdims=True), 3, -1))
    return np.clip(np.stack(frames), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("kind", ["smooth", "drawing", "preview"])
def test_write_video_matches_jax_through_the_readers(tmp_path, kind):
    """Each frame of the port's file (its reader) no farther from the
    frames written than the JAX function's file (OpenCV's reader); gray
    frames >= 40 dB from JAX's. The JAX file's colour frames lose more
    (its OpenCV FFmpeg encoder: the preview 24-32 dB from its input, the
    port's 0.4-0.8 dB closer), and the two sit 33-38 dB apart there."""
    cv2 = pytest.importorskip("cv2")
    from animateportrait_tpu.utils.video import write_video as jwrite
    from animateportrait_tpu_torch.utils.video import (
        read_video_frames, write_video)

    frames = _frames(kind)
    path = write_video(str(tmp_path / "t.avi"), frames, fps=25)
    got, fps = read_video_frames(path)
    assert fps == 25.0 and got.shape == frames.shape
    jpath = jwrite(str(tmp_path / "j.avi"), frames, fps=25)
    cap = cv2.VideoCapture(jpath)
    want = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        want.append(f)
    cap.release()
    assert len(want) == len(got)
    for g, w, f in zip(got, want, frames[..., ::-1]):         # BGR
        assert psnr(g, f, peak=255.0) >= psnr(w, f, peak=255.0)
        if kind != "preview":
            assert psnr(g, w, peak=255.0) >= VIDEO_MIN_PSNR
    # OpenCV reads the port's file as the port's reader does
    cap = cv2.VideoCapture(path)
    assert abs(cap.get(cv2.CAP_PROP_FPS) - 25.0) < 1e-6
    for g in got:
        ok, f = cap.read()
        assert ok and np.array_equal(f, g)
    assert not cap.read()[0]
    cap.release()


def test_write_video_gray_float_and_mp4_paths(tmp_path):
    """uint8 (T, H, W, 1) frames become 3-channel frames (the JAX test's
    case), [-1, 1] floats take ``frames_to_uint8``, and a ``.mp4`` path is
    written as ``.avi`` and returned."""
    from animateportrait_tpu_torch.utils.jpeg import (
        decode_mjpeg_frame, encode_jpeg)
    from animateportrait_tpu_torch.utils.video import (
        frames_to_uint8, read_video_frames, write_video)

    rng = np.random.default_rng(0)
    gray = rng.integers(0, 255, (4, 64, 64, 1), dtype=np.uint8)
    p = write_video(str(tmp_path / "g.avi"), gray)
    got, fps = read_video_frames(p)
    assert got.shape == (4, 64, 64, 3) and fps == 62.5
    x = rng.uniform(-1, 1, (3, 32, 48, 3)).astype(np.float32)
    p = write_video(str(tmp_path / "f.mp4"), x)
    assert p == str(tmp_path / "f.avi")
    got, _ = read_video_frames(p)
    assert got.shape == (3, 32, 48, 3)
    want = decode_mjpeg_frame(encode_jpeg(np.ascontiguousarray(
        frames_to_uint8(x)[0][:, :, ::-1])))
    np.testing.assert_array_equal(got[0], want)


def test_landmark_sequence_video_without_wav_is_mjpeg(tmp_path):
    """Without a WAV the preview is ``write_video``'s silent Motion-JPEG
    AVI, as in the JAX package: each frame the decode of its drawing's
    quality-95 JPEG."""
    from animateportrait_tpu_torch.utils import vis as tv
    from animateportrait_tpu_torch.utils.jpeg import (
        decode_mjpeg_frame, encode_jpeg)
    from animateportrait_tpu_torch.utils.video import read_avi

    fls = np.random.default_rng(0).uniform(40, 220, (3, 68, 3))
    avi = read_avi(tv.landmark_sequence_video(str(tmp_path / "p.avi"), fls,
                                              size=256))
    assert avi["streams"] == [b"vids"] and len(avi["frames"]) == 3
    for f, lm in zip(avi["frames"], fls):
        bgr = tv.vis_landmark(256, 256, lm[:, :2])
        want = decode_mjpeg_frame(encode_jpeg(bgr))[:, :, ::-1]
        np.testing.assert_array_equal(f, want)


def test_record_matches_jax():
    from animateportrait_tpu.utils.observe import Record as JRecord
    from animateportrait_tpu_torch.utils.observe import Record

    runs = []
    for cls in (JRecord, Record):
        r = cls(["loss", "acc"])
        log = []
        for v, c in ((2.0, 1.0), (4.0, 1.0), (1.5, 2.0)):
            r.add(v, c)
            log.append((r.per("loss"), r.per("acc"),
                        r.is_better("loss", greater=False)))
        r.clean("loss")
        r.add(0.5)
        log.append((r.per("loss"), r.per("acc"), r.is_better("acc", True),
                    r.is_better("loss", False), dict(r.data),
                    dict(r.count)))
        runs.append(log)
    assert runs[0] == runs[1]
    assert runs[1][1][0] == 3.0         # the reference's test: mean of 2, 4


def test_grad_norms_matches_jax():
    from animateportrait_tpu.utils.observe import grad_norms as jnorms
    from animateportrait_tpu_torch.utils.observe import grad_norms

    rng = np.random.default_rng(4)
    g = {"a": np.array([3.0, 4.0], np.float32), "b": np.zeros((2, 2),
                                                              np.float32),
         "c": rng.standard_normal((3, 5)).astype(np.float32)}
    want = jnorms({k: jnp.asarray(v) for k, v in g.items()})
    got = grad_norms({k: torch.from_numpy(v) for k, v in g.items()})
    for k in ("global_norm", "mean_abs"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=0,
                                   atol=1e-6)
    small = grad_norms({"a": torch.tensor([3.0, 4.0]),
                        "b": torch.zeros(2, 2)})
    np.testing.assert_allclose(float(small["global_norm"]), 5.0, atol=1e-6)
    np.testing.assert_allclose(float(small["mean_abs"]), 7 / 6, atol=1e-6)
    # a module's .grad, as the dict of its parameters' gradients
    net = torch.nn.Linear(5, 3)
    net(torch.from_numpy(g["c"])).square().sum().backward()
    by_dict = grad_norms({k: p.grad for k, p in net.named_parameters()})
    by_net = grad_norms(net)
    for k in by_dict:
        assert torch.equal(by_net[k], by_dict[k])


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    from animateportrait_tpu_torch.utils.observe import profile_trace

    net = torch.nn.Conv2d(3, 4, 3)
    with profile_trace(str(tmp_path / "tr")) as path:
        net(torch.ones(1, 3, 16, 16)).sum().backward()
    assert path == str(tmp_path / "tr" / "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::conv2d" in names and "aten::convolution_backward" in names


def test_entry_matches_jax_at_ngf8():
    """The port's entry() at ngf 8 (its example inputs are the JAX
    entry's draws, NCHW) against JAX's TridentGeneratorFullIFW at ngf 8 on
    converted weights."""
    from animateportrait_tpu.models.gan import TridentGeneratorFullIFW
    from animateportrait_tpu.utils.smoke import random_variables
    from animateportrait_tpu_torch.entry import entry
    from animateportrait_tpu_torch.io.from_jax import trident_state_dict

    H = 256
    rng = np.random.default_rng(0)               # __graft_entry__.py:29-35
    args = [rng.uniform(-1, 1, (1, H, H, 3)), rng.uniform(-1, 1, (1, H, H, 1)),
            rng.uniform(-1, 1, (1, H, H, 1)), rng.uniform(-1, 1, (1, H, H, 2)),
            rng.standard_normal((1, H, H, 2)), np.ones((1, H, H, 1))]
    args = [a.astype(np.float32) for a in args]
    fn, targs = entry("cpu", ngf=8)
    assert fn.training is False
    for i, (t, a) in enumerate(zip(targs, args)):
        assert np.array_equal(t.numpy() if i == 3 else nhwc(t), a), i
    model = TridentGeneratorFullIFW(output_nc=1, ngf=8, n_blocks=9, div=3,
                                    disp=3)
    jargs = [jnp.asarray(a) for a in args]
    v = random_variables(lambda: model.init(jax.random.key(0), *jargs))
    want = np.asarray(jax.jit(model.apply)(v, *jargs))
    fn.load_state_dict(trident_state_dict(v, n_blocks=9, div=3, disp=3))
    with torch.inference_mode():
        got = nhwc(fn(*targs))
    assert got.shape == want.shape == (1, H, H, 1)
    assert psnr(got, want) >= ENTRY_MIN_PSNR
