"""Host image IO and resize without OpenCV.

``read_image`` stands in for ``cv2.imread`` (the JAX CLI's reader): BGR
uint8 from 8-bit non-interlaced PNG (gray, RGB, RGBA; the alpha channel is
dropped, as OpenCV does) and from binary PPM/PGM. Anything else, JPEG
included, raises an error that names what it reads.

``resize_bicubic`` reproduces ``cv2.resize(..., interpolation=INTER_CUBIC)``
on uint8 images, the resize the JAX package's alignment (``align.py``) and
end-to-end pipeline (``end2end.py``) call: Keys' cubic with A = -0.75,
half-pixel centres, replicated borders, no antialiasing on downscale. As
in OpenCV's float path, the taps are computed in fp32, the image is
filtered along rows and then along columns in fp32, and the result is
rounded half to even and saturated. Measured against OpenCV 5.0 it is
bit-exact on downscales and differs by one level on ~1e-5 of the pixels of
an upscale (fp32 summation order).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

READS = ("PNG (8-bit, non-interlaced: gray, RGB, RGBA)",
         "binary PPM (P6) and PGM (P5) with maxval 255")
_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}       # colour type -> samples per pixel


def _unsupported(path: str, what: str) -> ValueError:
    return ValueError(f"read_image: {path} is {what}; the port reads "
                      + " and ".join(READS))


def _unfilter(raw: bytes, h: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Undo the five PNG row filters (None, Sub, Up, Average, Paeth)."""
    if len(raw) != h * (row_bytes + 1):
        raise ValueError("read_image: PNG image data has the wrong length")
    rows = np.frombuffer(raw, np.uint8).reshape(h, row_bytes + 1)
    out = np.zeros((h, row_bytes), np.uint8)
    prior = np.zeros(row_bytes, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prior
        elif kind in (3, 4):
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for i in range(row_bytes):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"read_image: unknown PNG filter {kind}")
        out[y] = cur
        prior = out[y]
    return out


def _read_png(path: str, data: bytes) -> np.ndarray:
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos: pos + 8])
        body = data[pos + 8: pos + 8 + n]
        crc = data[pos + 8 + n: pos + 12 + n]
        if len(body) != n or len(crc) != 4 or struct.unpack(
                ">I", crc)[0] != zlib.crc32(tag + body):
            raise ValueError(f"read_image: {path}: corrupt PNG chunk {tag}")
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if hdr is None or not idat:
        raise ValueError(f"read_image: {path}: PNG without IHDR or IDAT")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace:
        raise _unsupported(path, f"a PNG of bit depth {depth}, colour type "
                           f"{ctype}, interlace {interlace}")
    ch = _PNG_CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    px = px.reshape(h, w, ch)
    return np.repeat(px, 3, 2) if ch == 1 else px[:, :, 2::-1].copy()


def _read_pnm(path: str, data: bytes) -> np.ndarray:
    fields, pos = [], 2
    while len(fields) < 3:
        while pos < len(data) and data[pos: pos + 1].isspace():
            pos += 1
        if data[pos: pos + 1] == b"#":
            pos = data.index(b"\n", pos)
            continue
        end = pos
        while end < len(data) and not data[end: end + 1].isspace():
            end += 1
        fields.append(int(data[pos:end]))
        pos = end
    w, h, maxval = fields
    if maxval != 255:
        raise _unsupported(path, f"a PNM with maxval {maxval}")
    ch = 3 if data[:2] == b"P6" else 1
    px = np.frombuffer(data, np.uint8, count=w * h * ch, offset=pos + 1)
    px = px.reshape(h, w, ch)
    return np.repeat(px, 3, 2) if ch == 1 else px[:, :, ::-1].copy()


def read_image(path: str) -> np.ndarray:
    """An image file -> (H, W, 3) BGR uint8, as ``cv2.imread`` gives it."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(_PNG_SIG):
        return _read_png(path, data)
    if data[:2] in (b"P5", b"P6"):
        return _read_pnm(path, data)
    if data.startswith(b"\xff\xd8\xff"):
        raise _unsupported(path, "a JPEG")
    raise _unsupported(path, "in a format it does not know")


def _cubic_taps(n_in: int, n_out: int) -> tuple[np.ndarray, np.ndarray]:
    """Per output index: the 4 clamped source indices and their fp32
    weights (OpenCV's ``interpolateCubic``)."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    x = (f - s).astype(np.float32)
    a = np.float32(-0.75)
    x1 = x + np.float32(1)
    c0 = ((a * x1 - 5 * a) * x1 + 8 * a) * x1 - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    y = np.float32(1) - x
    c2 = ((a + 2) * y - (a + 3)) * y * y + 1
    c3 = np.float32(1) - c0 - c1 - c2
    idx = np.clip(s.astype(np.int64)[:, None] + np.arange(-1, 3)[None, :],
                  0, n_in - 1)
    return idx, np.stack([c0, c1, c2, c3], 1)


def resize_bicubic(img: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """uint8 (H, W[, C]) -> uint8 (out_h, out_w[, C]), bicubic as OpenCV."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"resize_bicubic takes uint8, got {img.dtype}")
    iy, wy = _cubic_taps(img.shape[0], out_hw[0])
    ix, wx = _cubic_taps(img.shape[1], out_hw[1])
    trail = (None,) * (img.ndim - 2)            # broadcast over channels
    src = img.astype(np.float32)
    rows = sum(src[:, ix[:, k]] * wx[(slice(None), k) + trail]
               for k in range(4))                # (H, out_w[, C])
    out = sum(rows[iy[:, k]] * wy[(slice(None), k, None) + trail]
              for k in range(4))
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)
