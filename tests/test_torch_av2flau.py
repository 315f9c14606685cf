"""The port's dataset builder (``data/av2flau.py``, with
``utils/video.py:read_video_frames``) and puppet table
(``utils/puppet.py``) against the JAX package's, on the CPU.

- ``read_video_frames`` gives every frame of an AVI byte-equal to
  ``cv2.VideoCapture``, and its fps: a cv2-written Motion-JPEG AVI (as
  ``tests/test_vis_av2flau.py:35``), the committed fixture (whose hashes
  it matches; ``tests/test_torch_cuda.py`` decodes it on the card
  machine too), a raw AVI of the
  port's writer, and each with an empty (dropped) frame chunk, which
  OpenCV skips; ``every`` and ``max_frames`` as the JAX reader.
- ``Av2FlauConverter.convert`` with one ``landmark_fn``: the same frame
  indices and rows as JAX's, the same ``raw_fl3d/fan_<base>_3d.txt``
  bytes, and the registered rows within 2e-3 px of JAX's. JAX registers in
  float32 (its SVD of the 9 anchors and the 68-point product; the points
  are ~50-200 px, whose float32 ulp is 4e-6-1.5e-5), the port in float64;
  a float32 SVD of a 3x3 cross-covariance is good to ~1e-6 relative, which
  moves a rotated point at 200 px by ~1e-4 px.
- Frames skipped only on None and ``NoFaceError``; another error
  propagates (JAX skips a frame on any error; ROADMAP Queue 3).
- ``get_puppet_info``: the named table and the generic branch equal to
  JAX's, for a PNG and for a JPEG with EXIF rotation (which
  ``cv2.imread`` applies).
"""
import json
import hashlib
import os
import shutil
import struct

import numpy as np
import pytest

from animateportrait_tpu.data import av2flau as jav
from animateportrait_tpu_torch.data import av2flau as tav
from animateportrait_tpu_torch.models.fan3d import NoFaceError
from animateportrait_tpu_torch.utils import video

ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "animateportrait_tpu_torch", "assets")


def _circle_lm(size=64):
    theta = np.linspace(0, 2 * np.pi, 68, endpoint=False)
    return np.stack([size / 2 + size / 5 * np.cos(theta),
                     size / 2 + size / 5 * np.sin(theta),
                     np.linspace(-3, 3, 68)], -1)


def _mjpg(path, frames, fps=25):
    import cv2
    h, w = frames.shape[1:3]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), fps, (w, h))
    for f in frames:
        vw.write(f)
    vw.release()
    return path


def _with_empty_chunk(src, dst, at):
    """``src`` with an empty chunk of its video stream before its
    ``at``-th frame, and an ``idx1`` entry for it."""
    data, info, chunks = video._avi(src)
    hdrl = data[12: data.find(b"movi") - 8]
    vid = video._stream_tag(info, b"vids")
    out, k = [], 0
    for tag, start, size in chunks:
        if tag == b"idx1":
            continue
        if tag[:2] == vid and tag[2:] in (b"db", b"dc"):
            if k == at:
                out.append((tag, b""))
            k += 1
        out.append((tag, data[start: start + size]))
    movi, idx, off = b"movi", [], 4
    for tag, payload in out:
        chunk = video._chunk(tag, payload)
        idx.append(tag + struct.pack("<III", 0x10 if payload else 0, off,
                                     len(payload)))
        movi += chunk
        off += len(chunk)
    body = (b"AVI " + hdrl + video._chunk(b"LIST", movi)
            + video._chunk(b"idx1", b"".join(idx)))
    with open(dst, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    return dst


def _clips(tmp_path):
    rng = np.random.default_rng(0)
    noise = rng.integers(0, 255, (12, 64, 64, 3)).astype(np.uint8)
    mj = _mjpg(str(tmp_path / "clip.avi"), noise)
    raw = video.mux_avi(str(tmp_path / "raw.avi"), noise[:5, :48, :40],
                        np.zeros(1600))
    fixture = str(tmp_path / "face_clip_mjpg.avi")
    shutil.copy(os.path.join(ASSETS, "face_clip_mjpg.avi"), fixture)
    clips = {"mjpg": mj, "raw": raw, "fixture": fixture}
    for name, at in (("mjpg", 0), ("raw", 2), ("fixture", 11)):
        clips[f"{name}_dropped"] = _with_empty_chunk(
            clips[name], str(tmp_path / f"{name}_dropped.avi"), at)
    return clips


def test_read_video_frames_is_cv2_videocapture(tmp_path):
    from torch_video_fixtures import cv2_frames
    clips = _clips(tmp_path)
    for name, path in clips.items():
        want, fps = cv2_frames(path)
        got, got_fps = tav.read_video_frames(path)
        assert got.dtype == np.uint8 and len(got) == len(want), name
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert got_fps == fps, name
        for every, most in ((2, 250), (1, 3), (3, 2)):
            ref = jav.read_video_frames(path, most, every)
            sub = tav.read_video_frames(path, most, every)
            np.testing.assert_array_equal(sub[0], ref[0])
            assert sub[1] == ref[1]
    with open(os.path.join(ASSETS, "video_fixtures.json")) as f:
        rec = json.load(f)["face_clip_mjpg.avi"]
    got, fps = tav.read_video_frames(clips["fixture"])
    assert fps == rec["fps"] and len(got) == len(rec["frames"]) == 12
    for a, d in zip(got, rec["frames"]):
        assert hashlib.sha256(a.tobytes()).hexdigest() == d["sha256"]
    # the JAX package's writer's fps (62.5) and a stream rate of 0 (25)
    assert tav.read_video_frames(clips["raw"])[1] == 62.5
    data = bytearray(open(clips["raw"], "rb").read())
    at = data.find(b"strh") + 8 + 24            # dwRate of the video stream
    data[at: at + 4] = b"\0\0\0\0"
    with open(tmp_path / "rate0.avi", "wb") as f:
        f.write(bytes(data))
    assert tav.read_video_frames(str(tmp_path / "rate0.avi"))[1] == 25.0
    with pytest.raises(ValueError, match="no frames"):
        tav.read_video_frames(clips["raw"], max_frames=0)


class _Landmarks:
    """A landmark hook that both converters call once per frame, in
    order: a circle moved by the frame's mean colour, None for the 4th
    frame and no face (``NoFaceError``) for the 6th."""

    def __init__(self):
        self.calls = 0

    def __call__(self, frame):
        self.calls += 1
        if self.calls == 4:
            return None
        if self.calls == 6:
            raise NoFaceError("no face detected for FAN landmarks")
        m = frame.reshape(-1, 3).mean(0)
        lm = _circle_lm(64)
        lm[:, 0] += m[0] / 40.0 + self.calls
        lm[:, 1] += m[1] / 50.0
        lm[:, 2] *= 1 + m[2] / 255.0
        return lm


def test_converter_matches_jax(tmp_path):
    clip = _mjpg(str(tmp_path / "clip.avi"), np.random.default_rng(1)
                 .integers(0, 255, (14, 64, 64, 3)).astype(np.uint8))
    outs = {}
    for key, mod in (("jax", jav), ("port", tav)):
        outs[key] = {}
        for register in (False, True):
            d = tmp_path / f"{key}_{register}"
            fl3d, feats, fps = mod.Av2FlauConverter(_Landmarks()).convert(
                clip, out_dir=str(d), register=register)
            with open(d / "raw_fl3d" / "fan_clip_3d.txt", "rb") as f:
                outs[key][register] = (fl3d, fps, f.read())
            assert feats is None
    (j, jfps, jtxt), (p, pfps, ptxt) = outs["jax"][False], outs["port"][False]
    assert p.shape == (12, 205) and jfps == pfps == 25.0
    np.testing.assert_array_equal(p[:, 0], [0, 1, 2, 4, 6, 7, 8, 9, 10, 11,
                                            12, 13])
    np.testing.assert_array_equal(p, j)
    assert ptxt == jtxt
    (j, _, _), (p, _, ptxt) = outs["jax"][True], outs["port"][True]
    np.testing.assert_array_equal(p[:, 0], j[:, 0])
    np.testing.assert_allclose(p[:, 1:], j[:, 1:], atol=2e-3)
    np.testing.assert_allclose(np.loadtxt(ptxt.decode().splitlines()), p,
                               atol=5e-3 + 1e-9)
    # the registration moved the anchors nearer the canonical T-shape
    from animateportrait_tpu_torch.utils import assets
    idx = list(assets.T_SHAPE_IDX)
    anchor = assets.std_face_landmarks()[idx]
    before = outs["port"][False][0][:, 1:].reshape(-1, 68, 3)[:, idx]
    after = p[:, 1:].reshape(-1, 68, 3)[:, idx]
    assert np.abs(after - anchor).mean() < np.abs(before - anchor).mean()


def test_converter_errors_and_audio(tmp_path):
    clip = _mjpg(str(tmp_path / "clip.avi"), np.random.default_rng(2)
                 .integers(0, 255, (10, 32, 32, 3)).astype(np.uint8))

    def broken(frame):
        raise RuntimeError("CUDA error: an illegal memory access")

    # JAX skips a frame on any error (and then has too few); the port
    # lets the error through
    with pytest.raises(ValueError, match="too short"):
        jav.Av2FlauConverter(broken).convert(clip)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tav.Av2FlauConverter(broken).convert(clip)
    with pytest.raises(ValueError, match=r"too short \(0 frames\)"):
        tav.Av2FlauConverter(lambda f: None).convert(clip)

    from animateportrait_tpu_torch.utils.video import write_wav
    wav = write_wav(str(tmp_path / "a.wav"), np.random.default_rng(3)
                    .uniform(-0.3, 0.3, 8000))
    seen = {}
    for key, mod in (("jax", jav), ("port", tav)):
        def pipeline(w, key=key):
            seen[key] = w
            return "feats"
        _, feats, _ = mod.Av2FlauConverter(
            lambda f: _circle_lm(32), pipeline).convert(clip, wav)
        assert feats == "feats"
    np.testing.assert_array_equal(seen["port"], seen["jax"])


def test_puppet_info_matches_jax(tmp_path):
    import cv2
    from animateportrait_tpu.utils import puppet as jpu
    from animateportrait_tpu_torch.utils import puppet as tpu

    for name in ("wilk_old", "sketch", "onepunch", "cat", "paint", "mulaney",
                 "cartoonM_old", "beer", "color"):
        for a, b in zip(tpu.get_puppet_info(name, str(tmp_path)),
                        jpu.get_puppet_info(name, str(tmp_path))):
            np.testing.assert_array_equal(a, b)
    cv2.imwrite(str(tmp_path / "mypuppet.png"),
                np.zeros((100, 120, 3), np.uint8))
    from PIL import Image
    exif = Image.Exif()
    exif[0x0112] = 6                    # rotate 90 degrees on reading
    Image.fromarray(np.full((60, 100, 3), 90, np.uint8)).save(
        tmp_path / "rotated.jpg", exif=exif)
    assert cv2.imread(str(tmp_path / "rotated.jpg")).shape == (100, 60, 3)
    for name, ss in (("mypuppet", [-0.01, -10.0, -20.0]),
                     ("rotated", [-0.02, 5.0, 7.5])):
        np.savetxt(str(tmp_path / f"{name}_scale_shift.txt"), ss)
        got = tpu.get_puppet_info(name, str(tmp_path))
        want = jpu.get_puppet_info(name, str(tmp_path))
        assert got[0].shape == (1, 24) and got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[2], want[2])
    with pytest.raises(FileNotFoundError):
        tpu.get_puppet_info("nobody", str(tmp_path))
