"""Video/audio output without ffmpeg or OpenCV: frames + speech -> one AVI.
Port of ``animateportrait_tpu/utils/video.py``.

The JAX package JPEG-encodes each frame through OpenCV; the port's
``mux_avi`` writes the frames uncompressed, which every reader decodes to
the exact frames:
``00db`` chunks of 24-bit BGR rows (a DIB, ``BI_RGB``), each row padded
to 4 bytes, stored top-down (a negative ``biHeight``):
OpenCV 5.0's FFmpeg reader decodes bottom-up raw frames but corrupts its
heap when it releases them. The container is the JAX one: a
RIFF ``AVI `` with ``hdrl`` (video and audio stream headers), ``movi``
(each frame's chunk followed by its share of 16-bit PCM in ``01wb``,
round(sr / fps) samples) and an ``idx1`` index. A RIFF size is 32 bits,
so about 5.8 minutes of 256x256 frames at 62.5 fps is the limit; a longer
clip raises before anything is written. ``write_video`` writes a silent
Motion-JPEG AVI (``00dc`` chunks of quality-95 JPEGs), as the JAX one does.

``read_first_frame`` and ``read_pcm_track`` read the CLI's ``--video``
without FFmpeg: the first frame of a raw or Motion-JPEG AVI, and its
soundtrack when that is 16 kHz mono 16-bit PCM; ``read_video_frames``
reads every frame, as the dataset builder (``data/av2flau.py``) does.
Other containers (MP4, Matroska, ...) and codecs (H.264, MPEG-4, ...) are
refused by name.
"""
from __future__ import annotations

import os
import struct
import wave

import numpy as np

from animateportrait_tpu_torch.utils import observe

_RIFF_MAX = 2 ** 32 - 1


def frames_to_uint8(frames: np.ndarray) -> np.ndarray:
    """[-1, 1] float frames (T, H, W, C) -> uint8 RGB/gray."""
    x = np.clip((frames + 1.0) * 127.5, 0, 255).astype(np.uint8)
    if x.shape[-1] == 1:
        x = np.repeat(x, 3, axis=-1)
    return x


def _pcm16(wav: np.ndarray) -> bytes:
    return np.clip(np.asarray(wav) * 32768.0, -32768, 32767).astype(
        np.int16).tobytes()


def write_wav(path: str, wav: np.ndarray, sr: int = 16000) -> str:
    """Float samples in [-1, 1) -> 16-bit mono PCM WAV."""
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(_pcm16(wav))
    return path


def _chunk(tag: bytes, payload: bytes) -> bytes:
    pad = b"\x00" if len(payload) % 2 else b""
    return tag + struct.pack("<I", len(payload)) + payload + pad


def _dib(frame: np.ndarray, stride: int) -> bytes:
    """(H, W, 3) RGB uint8 -> top-down BGR rows padded to ``stride``."""
    h, w = frame.shape[:2]
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : w * 3] = frame[:, :, ::-1].reshape(h, w * 3)
    return rows.tobytes()


def _write_avi(path: str, w: int, h: int, fps: float, payloads,
               sizes: list[int], codec: bytes | None = None,
               wav: np.ndarray | None = None, sr: int = 16000) -> str:
    """A RIFF AVI of one video stream and, when ``wav`` is given, a 16-bit
    mono PCM stream, streamed to disk. ``payloads`` yields each frame's
    chunk (``sizes`` are their lengths): top-down 24-bit DIB rows in
    ``00db`` chunks when ``codec`` is None, else ``codec`` (b"MJPG")
    frames in ``00dc`` chunks."""
    n = len(sizes)
    buf = max(sizes, default=0)
    usec_per_frame = int(round(1e6 / fps))
    if codec is None:
        tag_v, handler, height, comp, image = b"00db", b"DIB ", -h, 0, buf
    else:
        tag_v, handler, height = b"00dc", codec, h
        comp, image = int.from_bytes(codec, "little"), w * h * 3
    strh_v = _chunk(b"strh", b"vids" + handler + struct.pack(
        "<IHHIIIIIIII4H", 0, 0, 0, 0, usec_per_frame, 1000000, 0, n,
        buf, 0, 0, 0, 0, w, h))
    strf_v = _chunk(b"strf", struct.pack(
        "<IiiHHIIiiII", 40, w, height, 1, 24, comp, image, 0, 0, 0, 0))
    strls = _chunk(b"LIST", b"strl" + strh_v + strf_v)
    audio = [b""] * n
    if wav is not None:
        pcm = _pcm16(wav)
        bytes_per_frame = int(round(sr / fps)) * 2
        audio = [pcm[i * bytes_per_frame: (i + 1) * bytes_per_frame]
                 for i in range(n)]
        strh_a = _chunk(b"strh", b"auds" + b"\x00" * 4 + struct.pack(
            "<IHHIIIIIIII4H", 0, 0, 0, 0, 1, sr, 0, len(pcm) // 2,
            bytes_per_frame, 0, 2, 0, 0, 0, 0))
        strf_a = _chunk(b"strf", struct.pack("<HHIIHH", 1, 1, sr, sr * 2, 2,
                                             16))
        strls += _chunk(b"LIST", b"strl" + strh_a + strf_a)
    avih = _chunk(b"avih", struct.pack(
        "<14I", usec_per_frame, 0, 0, 0x10, n, 0, 1 if wav is None else 2,
        buf, w, h, 0, 0, 0, 0))
    hdrl = _chunk(b"LIST", b"hdrl" + avih + strls)

    def padded(k):
        return k + k % 2

    movi_size = 4 + sum(8 + padded(k) for k in sizes) + sum(
        8 + padded(len(a)) for a in audio if a)
    n_chunks = n + sum(1 for a in audio if a)
    riff_size = 4 + len(hdrl) + 8 + movi_size + 8 + 16 * n_chunks
    if riff_size > _RIFF_MAX:
        raise ValueError(
            f"{n} frames of {w}x{h} need a RIFF of {riff_size} bytes, over "
            f"the AVI limit of {_RIFF_MAX}; write a shorter clip")

    idx = []
    offset = 4                      # from the 'movi' tag
    with open(path, "wb") as f:
        # traced, the writes' time is counted apart from the packing
        write = observe.timed(f.write, "video.file_write_ns")
        write(b"RIFF" + struct.pack("<I", riff_size) + b"AVI " + hdrl)
        write(b"LIST" + struct.pack("<I", movi_size) + b"movi")
        for frame, a in zip(payloads, audio):
            for tag, payload in ((tag_v, frame), (b"01wb", a)):
                if not payload:
                    continue
                chunk = _chunk(tag, payload)
                write(chunk)
                idx.append(tag + struct.pack("<III", 0x10, offset,
                                             len(payload)))
                offset += len(chunk)
        write(_chunk(b"idx1", b"".join(idx)))
    return path


def mux_avi(path: str, frames: np.ndarray, wav: np.ndarray,
            fps: float = 62.5, sr: int = 16000) -> str:
    """Interleave uncompressed RGB frames (T, H, W, 3) uint8 and 16-bit PCM
    audio into one AVI file, streamed to disk."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[3] != 3:
        raise ValueError(f"mux_avi takes (T, H, W, 3) uint8 frames, got "
                         f"{frames.shape} {frames.dtype}")
    n, h, w = frames.shape[:3]
    stride = (w * 3 + 3) & ~3
    return _write_avi(path, w, h, fps, (_dib(f, stride) for f in frames),
                      [stride * h] * n, wav=wav, sr=sr)


def _rgb_uint8(frames: np.ndarray) -> np.ndarray:
    """[-1, 1] float or uint8 frames, gray or RGB -> (T, H, W, 3) uint8."""
    if frames.dtype != np.uint8:
        frames = frames_to_uint8(frames)
    if frames.shape[-1] == 1:
        frames = np.repeat(frames, 3, axis=-1)
    return frames


def write_video(path: str, frames: np.ndarray, fps: float = 62.5) -> str:
    """Frames ([-1, 1] float or uint8, RGB or gray; (T, H, W, C)) -> a
    silent Motion-JPEG AVI, each frame JPEG-encoded at quality 95
    (``utils/jpeg.py:encode_jpeg``, ``cv2.imencode``'s file). The JAX
    function writes through ``cv2.VideoWriter``: MJPG for an ``.avi`` path,
    MP4 for another when OpenCV has that codec, else the ``.avi``
    fallback. The port writes the ``.avi`` for every path (a ``.mp4``
    becomes ``.avi``) and returns the path it wrote."""
    from animateportrait_tpu_torch.utils.jpeg import encode_jpeg

    root, ext = os.path.splitext(path)
    if ext != ".avi":
        path = root + ".avi"
    frames = _rgb_uint8(np.asarray(frames))
    h, w = frames.shape[1:3]
    jpegs = [encode_jpeg(np.ascontiguousarray(f[:, :, ::-1]))
             for f in frames]
    return _write_avi(path, w, h, fps, jpegs, [len(j) for j in jpegs],
                      codec=b"MJPG")


def write_video_with_audio(path: str, frames: np.ndarray, wav: np.ndarray,
                           fps: float = 62.5, sr: int = 16000) -> str:
    """Frames ([-1, 1] float or uint8, gray or RGB) + audio -> one AVI."""
    with observe.span("video.write"):
        with observe.span("video.rgb"):
            frames = _rgb_uint8(frames)
        with observe.span("video.mux"):
            return mux_avi(path, frames, wav, fps=fps, sr=sr)


# the containers a first frame cannot be read from without FFmpeg, by
# their leading bytes
_NOT_AVI = ((4, b"ftyp", "an MP4/MOV (ISO media) file"),
            (0, b"\x1a\x45\xdf\xa3", "a Matroska/WebM file"),
            (0, b"FLV", "an FLV file"), (0, b"OggS", "an Ogg file"),
            (0, b"\x00\x00\x01\xba", "an MPEG program stream"),
            (0, b"\x30\x26\xb2\x75", "an ASF/WMV file"),
            (0, b"\x47", "an MPEG transport stream"))
_MJPEG = (b"MJPG", b"mjpg")


class VideoUnsupported(ValueError):
    """A video the port cannot read without FFmpeg; the message names its
    container or codec."""


def _refuse(path: str, what: str) -> VideoUnsupported:
    return VideoUnsupported(
        f"{path} is {what}, which needs ffmpeg; the port reads "
        "uncompressed (24-bit RGB) and Motion-JPEG AVI. Pass a photo with "
        "--jpg and the speech with --audio")


def _avi(path: str) -> tuple[bytes, dict, list]:
    """An AVI file's bytes, its headers and its ``movi`` chunks: (data,
    {"streams": [{"type", "handler", "scale", "rate", "format"}], "size"
    (the video's width and DIB height), "compression", "bits", "audio":
    (format tag, channels, rate, bits) or None}, [(tag, start, size)] in
    file order, the chunks of ``rec `` lists included). Anything but a RIFF
    AVI is refused by name."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        for at, magic, what in _NOT_AVI:
            if data[at:at + len(magic)] == magic:
                raise _refuse(path, what)
        raise _refuse(path, "not a RIFF AVI")
    info = {"streams": [], "size": None, "compression": None, "bits": None,
            "audio": None}
    chunks = []

    def walk(lo, hi, in_movi):
        while lo + 8 <= hi:
            tag = data[lo: lo + 4]
            size = struct.unpack("<I", data[lo + 4: lo + 8])[0]
            body = lo + 8
            if tag in (b"LIST", b"RIFF"):
                kind = data[body: body + 4]
                walk(body + 4, min(body + size, hi),
                     in_movi or kind == b"movi")
            elif in_movi:
                chunks.append((tag, body, size))
            elif tag == b"strh":
                fcc, handler = data[body: body + 4], data[body + 4: body + 8]
                scale, rate = struct.unpack("<II", data[body + 20: body + 28])
                info["streams"].append({"type": fcc, "handler": handler,
                                        "scale": scale, "rate": rate})
            elif tag == b"strf" and info["streams"]:
                strm = info["streams"][-1]
                if strm["type"] == b"vids" and info["size"] is None:
                    w, h, _, bits, comp = struct.unpack(
                        "<iiHH4s", data[body + 4: body + 20])
                    info.update(size=(w, h), bits=bits, compression=comp)
                elif strm["type"] == b"auds" and info["audio"] is None:
                    info["audio"] = struct.unpack(
                        "<HHIIHH", data[body: body + 16])
            lo = body + size + size % 2

    walk(12, len(data), False)
    return data, info, chunks


def _stream_tag(info: dict, kind: bytes) -> bytes | None:
    """The two-digit chunk prefix of the first stream of ``kind``."""
    for i, s in enumerate(info["streams"]):
        if s["type"] == kind:
            return b"%02d" % i
    return None


def _dib_frame(body: bytes, w: int, h: int) -> np.ndarray:
    """A 24-bit BI_RGB DIB (rows padded to 4 bytes; bottom-up when the
    height is positive) -> (|h|, w, 3) BGR uint8."""
    rows = np.frombuffer(body, np.uint8)[: ((w * 3 + 3) & ~3) * abs(h)]
    rows = rows.reshape(abs(h), -1)
    if h > 0:
        rows = rows[::-1]
    return np.ascontiguousarray(rows[:, : w * 3].reshape(abs(h), w, 3))


def _frame_reader(path: str, info: dict):
    """The function that turns a video chunk's bytes into a BGR frame,
    for the codecs the port reads; the others are refused by name."""
    from animateportrait_tpu_torch.utils import jpeg

    comp, bits = info["compression"], info["bits"]
    if info["size"] is None:
        raise _refuse(path, "an AVI without a video stream")
    w, h = info["size"]
    if comp in (b"\x00\x00\x00\x00", b"DIB ", b"RGB "):
        if bits != 24:
            raise _refuse(path, f"an uncompressed AVI of {bits}-bit pixels")
        return lambda body: _dib_frame(body, w, h)
    if comp in _MJPEG:
        return jpeg.decode_mjpeg_frame
    name = comp.decode("latin-1").strip("\x00 ") or repr(comp)
    raise _refuse(path, f"an AVI of codec {name!r}")


def read_first_frame(path: str) -> np.ndarray:
    """The first frame of an AVI as ``cv2.VideoCapture(path).read()``
    gives it, (H, W, 3) BGR uint8: raw 24-bit DIB frames (bottom-up or
    top-down) as they are; Motion-JPEG frames as OpenCV's FFmpeg reader
    decodes them (``utils/jpeg.py:decode_mjpeg_frame``: FFmpeg's simple
    IDCT and swscale's YUV -> BGR, byte-equal for 4:2:0, 4:2:2 and gray
    frames of even height). Empty (dropped) frames are skipped.
    Other containers and codecs raise ``VideoUnsupported``, by name."""
    data, info, chunks = _avi(path)
    read = _frame_reader(path, info)
    for body in _video_chunks(data, info, chunks):
        return read(body)
    raise ValueError(f"cannot read a frame from {path}: no video chunk")


def _video_chunks(data: bytes, info: dict, chunks: list):
    """The bytes of each non-empty chunk of the first video stream, in file
    order. An empty chunk (a dropped frame) gives no frame: OpenCV's
    ``VideoCapture`` skips it too, with or without an ``idx1`` index, in
    raw and Motion-JPEG AVIs (measured against OpenCV 5.0)."""
    vid = _stream_tag(info, b"vids")
    for tag, start, size in chunks:
        if tag[:2] == vid and tag[2:] in (b"db", b"dc") and size:
            yield data[start: start + size]


def read_video_frames(path: str, max_frames: int = 250, every: int = 1
                      ) -> tuple[np.ndarray, float]:
    """Up to ``max_frames`` frames of an AVI, every ``every``-th decoded
    one, and its frame rate, as the JAX package's
    ``data/av2flau.py:read_video_frames`` reads them with
    ``cv2.VideoCapture``: (T, H, W, 3) BGR uint8 (decoded as
    ``read_first_frame`` decodes one), and fps = rate / scale of the video
    stream's header, 25.0 when that is 0. Raises ``ValueError`` when no
    frame decodes."""
    data, info, chunks = _avi(path)
    read = _frame_reader(path, info)
    frames = []
    for i, body in enumerate(_video_chunks(data, info, chunks)):
        if len(frames) >= max_frames:
            break
        if i % every == 0:
            frames.append(read(body))
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    vs = info["streams"][int(_stream_tag(info, b"vids"))]
    fps = vs["rate"] / vs["scale"] if vs["rate"] and vs["scale"] else 0.0
    return np.stack(frames), float(fps or 25.0)


def read_pcm_track(path: str, sr: int = 16000) -> np.ndarray:
    """The AVI's soundtrack as ``load_wav`` reads the WAV that ``ffmpeg -i
    path -vn -ar 16000 -ac 1`` writes: float64 in [-1, 1). Only a 16-bit
    mono PCM track at ``sr`` is read, whose samples ffmpeg passes through
    unchanged; any other track (or none) raises ``VideoUnsupported``."""
    data, info, chunks = _avi(path)
    fmt = info["audio"]
    if fmt is None:
        raise VideoUnsupported(f"{path} has no audio stream; pass the "
                               "speech with --audio")
    tag, channels, rate, _, _, bits = fmt
    if (tag, channels, rate, bits) != (1, 1, sr, 16):
        raise VideoUnsupported(
            f"{path}'s soundtrack is format {tag}, {channels} channel(s), "
            f"{rate} Hz, {bits}-bit; without ffmpeg the port reads only "
            f"16-bit mono PCM at {sr} Hz. Pass the speech with --audio")
    aud = _stream_tag(info, b"auds")
    pcm = b"".join(data[start: start + size] for t, start, size in chunks
                   if t[:2] == aud and t[2:] == b"wb")
    return np.frombuffer(pcm[: len(pcm) // 2 * 2], "<i2").astype(
        np.float64) / 32768.0


def read_avi(path: str) -> dict:
    """Parse an uncompressed or Motion-JPEG AVI (``mux_avi`` writes the
    former): {"fps", "size" (width and the DIB height, negative for
    top-down rows), "streams" (fccType per stream), "frames" (T, H, W, 3)
    RGB uint8, "pcm" (bytes of every 01wb chunk, in order), "audio_chunks"
    (list)}."""
    data, info, chunks = _avi(path)
    if struct.unpack("<I", data[4:8])[0] != len(data) - 8:
        raise ValueError(f"{path}: RIFF size does not match the file")
    read = _frame_reader(path, info)
    vid, aud = _stream_tag(info, b"vids"), _stream_tag(info, b"auds")
    frames = [read(body)[:, :, ::-1]
              for body in _video_chunks(data, info, chunks)]
    audio = [data[start: start + size] for tag, start, size in chunks
             if tag[:2] == aud and tag[2:] == b"wb"]
    vs = info["streams"][int(vid)]
    return {"streams": [s["type"] for s in info["streams"]],
            "fps": vs["rate"] / vs["scale"], "size": info["size"],
            "frames": np.stack(frames), "audio_chunks": audio,
            "pcm": b"".join(audio)}
