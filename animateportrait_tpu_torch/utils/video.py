"""Video/audio output without ffmpeg or OpenCV: frames + speech -> one AVI.
Port of ``animateportrait_tpu/utils/video.py``.

The JAX package JPEG-encodes each frame through OpenCV. The port has no
JPEG encoder (no OpenCV, PIL or torchvision), so it writes the frames
uncompressed: ``00db`` chunks of 24-bit BGR rows (a DIB, ``BI_RGB``),
each row padded to 4 bytes, stored top-down (a negative ``biHeight``):
OpenCV 5.0's FFmpeg reader decodes bottom-up raw frames but corrupts its
heap when it releases them. The container is the JAX one: a
RIFF ``AVI `` with ``hdrl`` (video and audio stream headers), ``movi``
(each frame's chunk followed by its share of 16-bit PCM in ``01wb``,
round(sr / fps) samples) and an ``idx1`` index. A RIFF size is 32 bits,
so about 5.8 minutes of 256x256 frames at 62.5 fps is the limit; a longer
clip raises before anything is written.
"""
from __future__ import annotations

import struct
import wave

import numpy as np

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
    frame_bytes = stride * h
    pcm = _pcm16(wav)
    bytes_per_frame = int(round(sr / fps)) * 2
    audio = [pcm[i * bytes_per_frame: (i + 1) * bytes_per_frame]
             for i in range(n)]

    usec_per_frame = int(round(1e6 / fps))
    avih = _chunk(b"avih", struct.pack(
        "<14I", usec_per_frame, 0, 0, 0x10, n, 0, 2, frame_bytes, w, h,
        0, 0, 0, 0))
    strh_v = _chunk(b"strh", b"vids" + b"DIB " + struct.pack(
        "<IHHIIIIIIII4H", 0, 0, 0, 0, usec_per_frame, 1000000, 0, n,
        frame_bytes, 0, 0, 0, 0, w, h))
    strf_v = _chunk(b"strf", struct.pack(
        "<IiiHHIIiiII", 40, w, -h, 1, 24, 0, frame_bytes, 0, 0, 0, 0))
    strh_a = _chunk(b"strh", b"auds" + b"\x00" * 4 + struct.pack(
        "<IHHIIIIIIII4H", 0, 0, 0, 0, 1, sr, 0, len(pcm) // 2,
        bytes_per_frame, 0, 2, 0, 0, 0, 0))
    strf_a = _chunk(b"strf", struct.pack("<HHIIHH", 1, 1, sr, sr * 2, 2, 16))
    hdrl = _chunk(b"LIST", b"hdrl" + avih
                  + _chunk(b"LIST", b"strl" + strh_v + strf_v)
                  + _chunk(b"LIST", b"strl" + strh_a + strf_a))

    def padded(k):
        return k + k % 2

    movi_size = 4 + n * (8 + padded(frame_bytes)) + sum(
        8 + padded(len(a)) for a in audio if a)
    n_chunks = n + sum(1 for a in audio if a)
    riff_size = 4 + len(hdrl) + 8 + movi_size + 8 + 16 * n_chunks
    if riff_size > _RIFF_MAX:
        raise ValueError(
            f"mux_avi: {n} frames of {w}x{h} need a RIFF of {riff_size} "
            f"bytes, over the AVI limit of {_RIFF_MAX}; write a shorter clip")

    idx = []
    offset = 4                      # from the 'movi' tag
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", riff_size) + b"AVI " + hdrl)
        f.write(b"LIST" + struct.pack("<I", movi_size) + b"movi")
        for frame, a in zip(frames, audio):
            for tag, payload in ((b"00db", _dib(frame, stride)), (b"01wb", a)):
                if not payload:
                    continue
                chunk = _chunk(tag, payload)
                f.write(chunk)
                idx.append(tag + struct.pack("<III", 0x10, offset,
                                             len(payload)))
                offset += len(chunk)
        f.write(_chunk(b"idx1", b"".join(idx)))
    return path


def write_video_with_audio(path: str, frames: np.ndarray, wav: np.ndarray,
                           fps: float = 62.5, sr: int = 16000) -> str:
    """Frames ([-1, 1] float or uint8, gray or RGB) + audio -> one AVI."""
    if frames.dtype != np.uint8:
        frames = frames_to_uint8(frames)
    if frames.shape[-1] == 1:
        frames = np.repeat(frames, 3, axis=-1)
    return mux_avi(path, frames, wav, fps=fps, sr=sr)


def read_avi(path: str) -> dict:
    """Parse an AVI written by ``mux_avi``: {"fps", "size" (width and the
    DIB height, negative for top-down rows), "streams" (fccType per
    stream), "frames" (T, H, W, 3) RGB uint8, "pcm" (bytes of every 01wb
    chunk, in order), "audio_chunks" (list)}."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path} is not a RIFF AVI")
    if struct.unpack("<I", data[4:8])[0] != len(data) - 8:
        raise ValueError(f"{path}: RIFF size does not match the file")
    out = {"streams": [], "frames": [], "audio_chunks": []}

    def walk(lo, hi):
        while lo < hi:
            tag = data[lo: lo + 4]
            size = struct.unpack("<I", data[lo + 4: lo + 8])[0]
            body = data[lo + 8: lo + 8 + size]
            if tag == b"LIST":
                walk(lo + 12, lo + 8 + size)
            elif tag == b"strh":
                out["streams"].append(body[:4])
                if body[:4] == b"vids":
                    scale, rate = struct.unpack("<II", body[20:28])
                    out["fps"] = rate / scale
            elif tag == b"strf" and out["streams"][-1] == b"vids":
                out["size"] = struct.unpack("<ii", body[4:12])
            elif tag == b"00db":
                w, h = out["size"]
                rows = np.frombuffer(body, np.uint8).reshape(abs(h), -1)
                if h > 0:                       # bottom-up
                    rows = rows[::-1]
                out["frames"].append(
                    rows[:, : w * 3].reshape(abs(h), w, 3)[:, :, ::-1])
            elif tag == b"01wb":
                out["audio_chunks"].append(body)
            lo += 8 + size + size % 2

    walk(12, len(data))
    out["frames"] = np.stack(out["frames"])
    out["pcm"] = b"".join(out["audio_chunks"])
    return out
