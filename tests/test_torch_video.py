"""``--video`` without OpenCV or ffmpeg: the port's quality-95 JPEG encoder
against OpenCV's (libjpeg-turbo) byte for byte and through the round trip
``cv2.imread(cv2.imwrite(x))``, the decoder on Motion-JPEG frames without
Huffman tables, ``utils/video.py:read_first_frame`` and
``read_pcm_track`` against ``cv2.VideoCapture`` and the frame's own bytes,
and ``cli.main --video`` against the JAX CLI's ``--video`` on shared
weights."""
import os
import struct

import numpy as np
import pytest
import torch

from animateportrait_tpu_torch.utils import jpeg, video
from animateportrait_tpu_torch.utils.smoke import make_wav
from torch_port_helpers import psnr

cv2 = pytest.importorskip("cv2")

# (height, width): MCU-aligned, odd, one pixel, one row or column, and
# sizes where the luma blocks of the last MCU column or row are dummies
SIZES = [(1, 1), (17, 9), (37, 53), (8, 8), (16, 16), (15, 17), (9, 17),
         (24, 40), (33, 31), (64, 48), (100, 75), (1, 40), (40, 1),
         (255, 257)]


def _photo(h, w, seed=0):
    """Colour ramps with seeded noise, a photo's statistics."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    a = np.stack([90 + 120 * x, 70 + 100 * y, 110 + 60 * np.sin(6 * x * y)],
                 -1) + rng.normal(0, 12, (h, w, 3))
    return np.clip(a, 0, 255).astype(np.uint8)


def _kinds(h, w, seed):
    rng = np.random.default_rng(seed)
    photo = _photo(h, w, seed)
    return {"photo": photo, "noise": rng.integers(0, 256, (h, w, 3), np.uint8),
            "flat": np.full((h, w, 3), (0, 255, 128), np.uint8),
            "gray": photo[:, :, 1].copy(),
            "gray_noise": rng.integers(0, 256, (h, w), np.uint8)}


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_encoder_is_opencv_quality_95(size):
    """decode_jpeg(encode_jpeg(x)) is OpenCV's imwrite + imread of x, and
    the file is the bytes cv2.imencode writes."""
    for kind, img in _kinds(*size, seed=size[0] * 7 + size[1]).items():
        mine = jpeg.encode_jpeg(img)
        ok, ref = cv2.imencode(".jpg", img)
        assert ok
        np.testing.assert_array_equal(
            jpeg.decode_jpeg(mine), cv2.imdecode(ref, cv2.IMREAD_COLOR),
            err_msg=kind)
        assert mine == ref.tobytes(), kind


@pytest.mark.parametrize("quality", [50, 75, 90, 100])
def test_encoder_other_qualities(quality):
    img = _photo(61, 77, quality)
    ok, ref = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert jpeg.encode_jpeg(img, quality) == ref.tobytes()


def test_encoder_round_trip_through_files(tmp_path):
    """cv2.imwrite then cv2.imread of the same frame, as the JAX CLI's
    _split_video does it."""
    img = _photo(256, 320, 3)[:, :, ::-1].copy()
    path = str(tmp_path / "frame.jpg")
    assert cv2.imwrite(path, img)
    np.testing.assert_array_equal(
        jpeg.decode_jpeg(jpeg.encode_jpeg(img)), cv2.imread(path))
    with pytest.raises(ValueError, match="takes"):
        jpeg.encode_jpeg(img.astype(np.float32))


def _strip_dht(data: bytes) -> bytes:
    """The JPEG without its DHT segments, as Motion-JPEG (AVI1) frames
    are stored."""
    out, pos = bytearray(data[:2]), 2
    while True:
        marker, n = data[pos + 1], struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if marker == 0xDA:
            return bytes(out + data[pos:])
        if marker != 0xC4:
            out += data[pos: pos + 2 + n]
        pos += 2 + n


def test_decoder_takes_the_standard_tables_without_dht():
    img = _photo(40, 56, 9)
    ok, ref = cv2.imencode(".jpg", img)
    bare = _strip_dht(ref.tobytes())
    assert b"\xff\xc4" not in bare[:bare.index(b"\xff\xda")]
    np.testing.assert_array_equal(jpeg.decode_jpeg(bare),
                                  cv2.imdecode(ref, cv2.IMREAD_COLOR))


# --- the first frame and the soundtrack ------------------------------------


def _raw_avi(path, frames, wav, sr=16000):
    return video.mux_avi(str(path), frames, wav, sr=sr)


def test_first_frame_of_raw_avi_is_videocaptures(tmp_path):
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (3, 48, 50, 3), np.uint8)
    path = _raw_avi(tmp_path / "r.avi", frames, make_wav(0.2, seed=1))
    cap = cv2.VideoCapture(path)
    ok, want = cap.read()
    cap.release()
    assert ok
    got = video.read_first_frame(path)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, frames[0][:, :, ::-1])


def test_first_frame_of_bottom_up_raw_avi(tmp_path):
    """The same file with a positive biHeight and its rows reversed."""
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, (2, 20, 30, 3), np.uint8)
    path = _raw_avi(tmp_path / "r.avi", frames, np.zeros(1000))
    data = bytearray(open(path, "rb").read())
    strf = data.index(b"strf") + 8
    w, h = struct.unpack("<ii", data[strf + 4: strf + 12])
    data[strf + 8: strf + 12] = struct.pack("<i", -h)
    stride = (w * 3 + 3) & ~3
    pos, end = data.index(b"00db"), data.index(b"idx1")
    while 0 <= pos < end:
        n = struct.unpack("<I", data[pos + 4: pos + 8])[0]
        rows = np.frombuffer(bytes(data[pos + 8: pos + 8 + n]),
                             np.uint8).reshape(-h, stride)
        data[pos + 8: pos + 8 + n] = rows[::-1].tobytes()
        pos = data.find(b"00db", pos + 8 + n)
    bottom_up = tmp_path / "b.avi"
    bottom_up.write_bytes(bytes(data))
    np.testing.assert_array_equal(video.read_first_frame(str(bottom_up)),
                                  frames[0][:, :, ::-1])
    np.testing.assert_array_equal(video.read_avi(str(bottom_up))["frames"],
                                  frames)


def test_first_frame_of_mjpeg_avi(tmp_path):
    """OpenCV's MJPG writer: the port gives libjpeg-turbo's decode of the
    frame's bytes (cv2.imdecode); OpenCV's reader decodes with FFmpeg,
    a few levels off, so against it the bar is PSNR >= 35 dB."""
    img = _photo(256, 320, 3)[:, :, ::-1].copy()
    path = str(tmp_path / "m.avi")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 25,
                         (320, 256))
    for f in (img, img[::-1].copy()):
        vw.write(f)
    vw.release()
    data, info, chunks = video._avi(path)
    assert info["compression"] == b"MJPG"
    tag, start, n = next(c for c in chunks if c[0] == b"00dc" and c[2])
    want = cv2.imdecode(np.frombuffer(data[start: start + n], np.uint8),
                        cv2.IMREAD_COLOR)
    got = video.read_first_frame(path)
    np.testing.assert_array_equal(got, want)
    cap = cv2.VideoCapture(path)
    ok, ffmpeg = cap.read()
    cap.release()
    p = psnr(got, ffmpeg, peak=255.0)
    print(f"MJPEG first frame against cv2.VideoCapture: PSNR {p:.2f} dB, "
          f"max |diff| {np.abs(got.astype(int) - ffmpeg).max()}")
    assert 35.0 <= p < float("inf")


def test_pcm_track_is_what_ffmpeg_passes_through(tmp_path):
    from animateportrait_tpu_torch.pipeline.audio import load_wav

    wav = make_wav(0.5, seed=4)
    frames = np.zeros((20, 8, 8, 3), np.uint8)
    path = _raw_avi(tmp_path / "s.avi", frames, wav)
    got = video.read_pcm_track(path)
    # the muxer stores round(sr / fps) samples per frame: 20 x 256
    pcm = np.clip(wav * 32768.0, -32768, 32767).astype(np.int16)[:20 * 256]
    wav_path = video.write_wav(str(tmp_path / "t.wav"), pcm / 32768.0)
    np.testing.assert_array_equal(got, load_wav(wav_path))
    assert got.shape == (20 * 256,)


def test_refuses_other_tracks_and_containers_by_name(tmp_path):
    frames = np.zeros((4, 8, 8, 3), np.uint8)
    path44 = _raw_avi(tmp_path / "a44.avi", frames, make_wav(0.1), sr=44100)
    with pytest.raises(video.VideoUnsupported, match="44100 Hz.*--audio"):
        video.read_pcm_track(path44)
    np.testing.assert_array_equal(video.read_first_frame(path44), frames[0])
    mp4 = tmp_path / "clip.mp4"
    mp4.write_bytes(struct.pack(">I", 24) + b"ftypisom" + bytes(12))
    for read in (video.read_first_frame, video.read_pcm_track):
        with pytest.raises(video.VideoUnsupported,
                           match="MP4/MOV.*needs ffmpeg.*--jpg"):
            read(str(mp4))
    xvid = bytearray(open(path44, "rb").read())
    at = xvid.index(b"strf") + 8 + 16
    xvid[at: at + 4] = b"XVID"
    (tmp_path / "x.avi").write_bytes(bytes(xvid))
    with pytest.raises(video.VideoUnsupported, match="codec 'XVID'"):
        video.read_first_frame(str(tmp_path / "x.avi"))


# --- cli.main --video against the JAX CLI ----------------------------------


def _recording(pipe, seen, key):
    """A pipeline whose photos are recorded."""
    call = pipe.__call__

    class Rec:
        def __getattr__(self, name):
            return getattr(pipe, name)

        def __call__(self, img, *args, **kwargs):
            seen[key] = np.array(img)
            return call(img, *args, **kwargs)
    return Rec()


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A raw AVI whose first frame is a photo and whose track is 1 s of
    16 kHz speech, and that speech as a WAV."""
    d = tmp_path_factory.mktemp("clip")
    y, x = np.mgrid[0:200, 0:176] / 200
    face = ((x - 0.45) ** 2 / 0.08 + (y - 0.5) ** 2 / 0.13) < 1
    rgb = np.stack([90 + 120 * x, 70 + 100 * y, 110 + 60 * np.sin(6 * x * y)],
                   -1) + 80 * face[..., None]
    rgb = rgb + np.random.default_rng(5).normal(0, 6, rgb.shape)
    first = np.clip(rgb, 0, 255).astype(np.uint8)
    frames = np.stack([first, first[::-1], first[:, ::-1]])
    wav = make_wav(1.0, seed=2)
    avi = _raw_avi(d / "clip.avi", np.concatenate([frames] * 21)[:63], wav)
    wav_path = video.write_wav(str(d / "speech.wav"), wav)
    return d, avi, wav_path, first


def test_cli_video_matches_jax_cli(clip, tmp_path, monkeypatch):
    """The same --video and --audio through both CLIs, on shared weights
    (test_torch_pipeline.py's pair of pipelines): the photo each pipeline
    gets is the same array, the output lands under frame-<audio>/, and the
    frames are >= 35 dB apart (the slice bar)."""
    from animateportrait_tpu import cli as jcli
    from animateportrait_tpu.utils import video as jvideo
    from animateportrait_tpu_torch import cli
    from test_torch_pipeline import _pipelines

    d, avi, wav_path, first = clip
    jpipe, tpipe = _pipelines()
    seen, jax_frames = {}, {}
    monkeypatch.setattr(jcli, "build_pipeline",
                        lambda args: _recording(jpipe, seen, "jax"))
    monkeypatch.setattr(cli, "build_pipeline",
                        lambda args: _recording(tpipe, seen, "port"))

    def keep_frames(path, frames, wav, fps=62.5):
        jax_frames["frames"] = np.array(frames)
        return path
    monkeypatch.setattr(jvideo, "write_video_with_audio", keep_frames)
    argv = ["--video", avi, "--audio", wav_path, "--exp", "formal/drawing"]
    jcli.main(argv + ["--output", str(tmp_path / "jax")])
    res = cli.main(argv + ["--output", str(tmp_path / "port"), "--device",
                           "cpu"])
    np.testing.assert_array_equal(seen["port"], seen["jax"])
    assert seen["port"].shape == first.shape
    assert res.path == str(tmp_path / "port" / "frame-speech" /
                           "output_formal_drawing.avi")
    got = video.read_avi(res.path)["frames"]
    ref = jax_frames["frames"]
    assert got.shape[0] == ref.shape[0] > 0
    assert psnr(got[..., :1], ref, peak=255.0) >= 35.0


def test_cli_video_takes_the_soundtrack(clip, tmp_path, monkeypatch):
    """Without --audio the speech is the clip's 16 kHz track, under the
    name "audio"; the output equals a run with that track as --audio."""
    from animateportrait_tpu_torch import cli
    from test_torch_pipeline import _pipelines

    d, avi, wav_path, first = clip
    _, tpipe = _pipelines()
    monkeypatch.setattr(cli, "build_pipeline", lambda args: tpipe)
    res = cli.main(["--video", avi, "--output", str(tmp_path),
                    "--device", "cpu"])
    assert res.path == str(tmp_path / "frame-audio" /
                           "output_formal_drawing.avi")
    track = video.write_wav(str(tmp_path / "track.wav"),
                            video.read_pcm_track(avi))
    again = cli.main(["--video", avi, "--audio", track, "--output",
                      str(tmp_path / "b"), "--device", "cpu"])
    np.testing.assert_array_equal(video.read_avi(res.path)["frames"],
                                  video.read_avi(again.path)["frames"])


def test_cli_video_refuses_by_name(clip, tmp_path):
    from animateportrait_tpu_torch import cli

    d, avi, wav_path, first = clip
    mp4 = tmp_path / "clip.mp4"
    mp4.write_bytes(struct.pack(">I", 24) + b"ftypmp42" + bytes(12))
    with pytest.raises(SystemExit, match="MP4/MOV.*needs ffmpeg"):
        cli.main(["--video", str(mp4), "--device", "cpu"])
    a44 = _raw_avi(tmp_path / "a44.avi", np.zeros((4, 8, 8, 3), np.uint8),
                   make_wav(0.1), sr=44100)
    with pytest.raises(SystemExit, match="44100 Hz.*--audio"):
        cli.main(["--video", a44, "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main(["--video", avi])
    assert os.path.exists(avi)
