"""The path a user takes with their own photo, against the JAX package on
the CPU at small widths: a JPEG read by each package its own way
(``cv2.imread`` there, ``utils/image.py:read_image`` here, EXIF rotation
included), the 68 source landmarks from FAN3D and its depth net through
each package's ``FaceAlignment3D`` and landmark hook, and the renderer's
``motion_mode="tps"`` grids; then the landmark post passes
``centerize_face`` and ``no_y_rotation``, and ``cli.main --device cpu``
with full-size FAN and depth checkpoints and ``--warp_mode tps``."""
import os

import numpy as np
import pytest
import torch

from animateportrait_tpu_torch import cli
from animateportrait_tpu_torch.io import from_jax
from animateportrait_tpu_torch.models import fan3d
from animateportrait_tpu_torch.utils import image, video
from animateportrait_tpu_torch.utils.smoke import (
    make_wav, write_fan_checkpoints, write_mtcnn_weights)
from test_torch_bf16_render import _bf16_twins
from test_torch_cartoon import cartoon_renderers  # noqa: F401
from test_torch_render import renderers, scene  # noqa: F401
from torch_port_helpers import maxdiff, psnr

Image = pytest.importorskip("PIL.Image")
cv2 = pytest.importorskip("cv2")

CS = 256
DEPTH_SMALL = (1, 1, 1, 1)


def _photo_jpeg(path, h=400, w=480, orientation=6):
    """A synthetic photo (colour ramps, a bright oval, seeded noise) as a
    4:2:0 quality-90 JPEG with an EXIF orientation."""
    rng = np.random.default_rng(11)
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    face = ((x - 0.5) ** 2 / 0.08 + (y - 0.42) ** 2 / 0.13) < 1
    rgb = np.stack([90 + 120 * x, 70 + 100 * y,
                    110 + 60 * np.sin(6 * x * y)], -1)
    rgb = rgb + 80 * face[..., None] + rng.normal(0, 6, (h, w, 3))
    exif = Image.Exif()
    exif[0x0112] = orientation
    Image.fromarray(np.clip(rgb, 0, 255).astype(np.uint8)).save(
        path, "JPEG", quality=90, subsampling=2, exif=exif.tobytes())
    return path


def _capture(fn, seen, key):
    def hook(img):
        seen[key] = out = fn(img)
        return out
    return hook


def test_user_photo_slice_matches_jax(tmp_path):
    """JPEG -> stub detection -> FAN3D + depth landmarks -> audio ->
    landmarks -> TPS render: the 68 source landmarks equal, the frames at
    PSNR >= 35 dB (the slice bar)."""
    from animateportrait_tpu.models import fan3d as jf
    from test_torch_fan3d import _depth_pair, _fan_pair
    from test_torch_pipeline import _pipelines
    from animateportrait_tpu_torch.utils.smoke import StubDetector

    jpipe, tpipe = _pipelines()
    fan_v, fan_net = _fan_pair(1, seed=12)
    dep_v, dep_net = _depth_pair(seed=13)
    jhook = jf.make_fan_landmark_fn(
        jf.FaceAlignment3D(fan_v, dep_v, num_modules=1,
                           depth_layers=DEPTH_SMALL), StubDetector())
    seen = {}
    tpipe.landmark_fn = _capture(fan3d.make_fan_landmark_fn(
        fan3d.FaceAlignment3D(fan_net, dep_net, device="cpu"),
        StubDetector()), seen, "port")
    jpipe.renderer.motion_mode = tpipe.renderer.motion_mode = "tps"

    path = _photo_jpeg(str(tmp_path / "me.jpg"))
    ref_img, got_img = cv2.imread(path), image.read_image(path)
    np.testing.assert_array_equal(got_img, ref_img)
    assert got_img.shape == (480, 400, 3)          # rotated by EXIF 6
    wav = make_wav(1.0, seed=2)
    with torch.inference_mode():
        got = tpipe(got_img, wav, rng=np.random.default_rng(5))
    assert list(got.stage_seconds) == ["detect", "align", "fan", "audio",
                                       "landmarks", "render"]

    # The aligned crop goes through the port's bicubic, within one level
    # of cv2's (``utils/image.py:resize_bicubic``), and FAN's argmax can
    # move where such a level meets a near-tie of its heatmaps. So JAX's
    # hook reads the pixels the port's hook read; the rest of the JAX
    # pipeline runs on its own crop.
    def jax_hook_on_port_pixels(aligned):
        assert np.abs(aligned.astype(int)
                      - got.aligned_photo.astype(int)).max() <= 1
        seen["jax"] = jhook(got.aligned_photo)
        return seen["jax"]

    jpipe.landmark_fn = jax_hook_on_port_pixels
    ref = jpipe(ref_img, wav, rng=np.random.default_rng(5))
    np.testing.assert_array_equal(seen["port"][:, :2], seen["jax"][:, :2])
    assert maxdiff(seen["port"][:, 2], seen["jax"][:, 2]) <= 2e-3
    T = ref.frames.shape[0]
    assert got.frames.shape == ref.frames.shape == (T, CS, CS, 1)
    assert maxdiff(got.landmarks, ref.landmarks) <= 0.05
    assert psnr(got.frames, ref.frames, peak=255.0) >= 35.0


@pytest.mark.parametrize("case", ["drawing", "cartoon", "drawing_bf16"])
def test_tps_renderer_matches_jax(request, scene, case):  # noqa: F811
    """``motion_mode="tps"``: the renderer bar, PSNR >= 40 dB, in fp32; in
    bf16 the bf16 tests' bar (b) against JAX's bf16 frames, relative to
    JAX's own bf16 error."""
    jr, tr = request.getfixturevalue(
        "cartoon_renderers" if case == "cartoon" else "renderers")
    photo, a68, tb68 = scene
    tb68 = tb68[:2]
    if case.endswith("bf16"):
        j32 = np.asarray(_tps(jr, photo, a68, tb68))
        jr, tr = _bf16_twins(jr, tr)
    ref = np.asarray(_tps(jr, photo, a68, tb68))
    with torch.no_grad():
        got = _tps(tr, photo, a68, tb68)
        linear = tr(photo, a68, tb68)
    assert got.shape == ref.shape
    assert maxdiff(got, linear) > 0                # another grid
    if case.endswith("bf16"):
        assert psnr(got, ref) >= psnr(ref, j32) - 3.5
    else:
        assert psnr(got, ref) >= 40.0


def _tps(renderer, photo, a68, tb68):
    renderer.motion_mode = "tps"
    try:
        return renderer(photo, a68, tb68)
    finally:
        renderer.motion_mode = "linear"


def _track(seed=0, T=30):
    """A normalized landmark track as the predictor gives it: the
    canonical face through ``norm_input_face``, jittered per frame."""
    from animateportrait_tpu_torch.ops.geometry import norm_input_face
    from animateportrait_tpu_torch.utils import assets

    std = assets.std_face_landmarks()
    shape = std.copy()
    shape[:, :2] = shape[:, :2] * 300 + 256
    face_id = norm_input_face(shape, std)[0].reshape(1, 204).astype(
        np.float32)
    fl = face_id + np.random.default_rng(seed).normal(0, 0.02, (T, 204))
    return fl.astype(np.float32), face_id


def test_landmark_post_passes_match_jax():
    from animateportrait_tpu.pipeline.landmark import LandmarkPredictor as JL
    from animateportrait_tpu_torch.pipeline import landmark

    fl, face_id = _track()
    got = landmark.centerize(fl, face_id)
    np.testing.assert_allclose(got, JL._centerize(fl, face_id), rtol=0,
                               atol=1e-6)
    got = landmark.remove_y_rotation(fl)
    np.testing.assert_allclose(got, JL._remove_y_rotation(None, fl), rtol=0,
                               atol=1e-6)
    assert got.dtype == np.float32 and maxdiff(got, fl) > 1e-3


def test_predictor_applies_the_post_passes():
    """LandmarkPredictor's ``centerize_face`` and ``no_y_rotation`` are the
    post passes on its plain output, in the reference's order."""
    from animateportrait_tpu_torch.models.audio2landmark import (
        Audio2landmarkContent, Audio2landmarkPos)
    from animateportrait_tpu_torch.pipeline import landmark

    torch.manual_seed(0)
    pred = landmark.LandmarkPredictor(Audio2landmarkPos(),
                                      Audio2landmarkContent(), device="cpu")
    rng = np.random.default_rng(1)
    win = rng.standard_normal((24, 18, 80)).astype(np.float32)
    emb = rng.standard_normal(256).astype(np.float32)
    _, face_id = _track()
    with torch.no_grad():
        plain = pred(win, emb, face_id)
        both = pred(win, emb, face_id, centerize_face=True,
                    no_y_rotation=True)
    want = landmark.remove_y_rotation(landmark.centerize(plain, face_id))
    np.testing.assert_array_equal(both, want)


def test_cli_jpeg_fan_depth_tps_on_cpu(tmp_path, capsys):
    """cli.main on a JPEG with a full 4-module FAN and a full (3, 8, 36, 3)
    depth checkpoint in --ckpt_dir and --warp_mode tps: the FAN stage runs,
    no fall back is announced, and the AVI parses back."""
    from animateportrait_tpu_torch.pipeline.audio import load_wav

    photo = _photo_jpeg(str(tmp_path / "me.jpg"), h=200, w=180)
    wav = video.write_wav(str(tmp_path / "clip.wav"), make_wav(0.6, seed=8))
    ckpt = str(tmp_path / "ckpt")
    write_mtcnn_weights(os.path.join(ckpt, "mtcnn"), seed=0)
    write_fan_checkpoints(os.path.join(ckpt, "face_alignment"), seed=3)
    res = cli.main(["--jpg", photo, "--audio", wav, "--exp",
                    "formal/drawing", "--ckpt_dir", ckpt, "--warp_mode",
                    "tps", "--output", str(tmp_path / "out"), "--ngf", "8",
                    "--flow_nf", "4", "--static_ngf", "8", "--frame_batch",
                    "4", "--device", "cpu"])
    err = capsys.readouterr().err
    assert "no face_alignment FAN" not in err
    assert "without the depth net" not in err
    assert list(res.stage_seconds)[:3] == ["detect", "align", "fan"]
    assert res.path == os.path.join(str(tmp_path / "out"), "me-clip",
                                    "output_formal_drawing.avi")
    avi = video.read_avi(res.path)
    T = res.frames
    assert avi["frames"].shape == (T, CS, CS, 3) and avi["fps"] == 62.5
    pcm = np.clip(load_wav(wav) * 32768.0, -32768, 32767).astype(np.int16)
    assert avi["pcm"] == pcm[: T * 256].tobytes()
    np.testing.assert_array_equal(avi["frames"][..., 0],
                                  avi["frames"][..., 2])
