"""Host image IO and resize without OpenCV or PIL.

``read_image`` stands in for ``cv2.imread(path)`` (the JAX CLI's reader):
BGR uint8 from JPEG, PNG and binary PPM/PGM. ``load_image(s)`` stands in
for ``PIL.Image.open(path).convert("RGB" | "L")`` (the training data
layer's reader) on the same formats, ``image_size`` for ``.size``, and
``write_png`` writes 8-bit gray or RGB PNGs with a chosen row filter.

JPEG goes through the port's own baseline decoder (``utils/jpeg.py``),
which gives libjpeg-turbo's samples byte for byte. The two readers differ
where OpenCV and PIL do: ``read_image`` applies the EXIF orientation (1-8)
as ``cv2.imread`` does, ``load_image`` does not. PNG: every colour type
(gray, RGB, palette, gray + alpha, RGBA), bit depths 1-16 and Adam7
interlace; alpha and ``tRNS`` are dropped, as both readers drop them for
RGB and gray output; gray below 8 bits is scaled to 0-255. 16-bit
samples keep their high byte, except 16-bit gray in ``load_image``, which
PIL opens as ``I;16`` and clips to 255 when it converts.

``resize_linear`` is ``cv2.resize(img, (w, h), interpolation=INTER_LINEAR)``
on uint8, byte for byte: OpenCV's fp32 source coordinates, 11-bit weights,
an integer horizontal pass (clamped columns), and its vector path's
vertical pass, ``((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16) + 2)
>> 2``, whose rows are clamped but whose weights are not.

``resize_bicubic_pil`` is ``PIL.Image.resize(..., Image.BICUBIC)`` byte for
byte: PIL's a = -0.5 cubic, its support widened by the downscale factor,
weights normalized per output pixel and rounded to 22-bit fixed point, a
horizontal pass rounded and clipped to uint8, then a vertical pass done
the same way. ``draw_dots`` is ``cv2.circle(img, c, r, 255, -1)`` at integer
centres: OpenCV's midpoint circle fill, as one stamp per radius clipped at
the borders. ``draw_landmarks`` is the reference's ``draw2`` as OpenCV and
PIL draw it: filled circles, ``cv2.line`` at thickness 2 or 4 (OpenCV
5.0's ``ThickLine``), and ``ImageDraw.polygon`` with a fill and an
outline (Pillow 12's scanline fill and Bresenham outline).

``resize_linear_float`` is ``cv2.resize`` (INTER_LINEAR) of a float32 plane
as OpenCV runs it by default, through Intel IPP (measured): a float64
source coordinate with its fraction rounded to float32, the rows
interpolated first, then the columns, each ``fma(b - a, t, a)``.

``resize_bicubic`` reproduces ``cv2.resize(..., interpolation=INTER_CUBIC)``
on uint8 images, the resize the JAX package's alignment (``align.py``) and
end-to-end pipeline (``end2end.py``) call: Keys' cubic with A = -0.75,
half-pixel centres, replicated borders, no antialiasing on downscale. As
OpenCV 5.0 runs it by default, through Intel IPP (measured): the float64
source coordinate's fraction rounded to fp32, each tap's distance in fp32
and its weight from Keys' kernel in float64 rounded to fp32, the rows
filtered first and then the columns in fp32 as (w0 p0 + w1 p1) + (w2 p2 +
w3 p3), rounded half to even and saturated. The weights are IPP's (an
impulse through its float32 resize gives them bit for bit), its sums are
not: no order of the four products and no polynomial form gives its
float32 output, which for one row also changes with the image's height.
So 0-9 of a 480 x 400 -> 512^2 colour resize's 786 432 bytes differ by
one level (20 random images; ``tests/test_torch_layers.py`` records
each test size's bytes).
"""
from __future__ import annotations

import functools
import struct
import zlib

import numpy as np

from portbench.reference.frozen.utils import jpeg

READS = ("baseline JPEG (utils/jpeg.py)",
         "PNG (any colour type and bit depth, Adam7 included)",
         "binary PPM (P6) and PGM (P5) with maxval 255")
_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # colour type -> samples
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _unsupported(path: str, what: str) -> ValueError:
    return ValueError(f"read_image: {path} is {what}; the port reads "
                      + ", ".join(READS))


def _unfilter_row(kind: int, line: np.ndarray, prior: np.ndarray,
                  bpp: int) -> np.ndarray:
    """One row: None, Sub (a cumulative sum) and Up as array operations;
    Average and Paeth, whose predictor reads the decoded byte to the left,
    byte by byte."""
    if kind == 0:
        return line.copy()
    if kind == 1:
        return np.cumsum(line.reshape(-1, bpp), axis=0,
                         dtype=np.uint8).reshape(-1)
    if kind == 2:
        return line + prior
    cur = bytearray(line.tobytes())
    up = prior.tobytes()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = up[i - bpp] if i >= bpp else 0
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


@functools.lru_cache(maxsize=1)
def _pred_table() -> np.ndarray:
    """Each filter's predictor less c, as a function of da = a - c and
    db = b - c alone: (5, 511 * 511) int16 indexed by kind, then
    (da + 255) * 511 + (db + 255). None 0 (its c is not added), Sub da,
    Up db, Average (da + db) >> 1 (as c + (da + db) >> 1 = (a + b) >> 1),
    Paeth da, db or 0 by its distances |db|, |da| and |da + db|."""
    da, db = np.meshgrid(np.arange(-255, 256), np.arange(-255, 256),
                         indexing="ij")
    pa, pb, pc = np.abs(db), np.abs(da), np.abs(da + db)
    paeth = np.where((pa <= pb) & (pa <= pc), da, np.where(pb <= pc, db, 0))
    return np.stack([np.zeros_like(da), da, db, (da + db) >> 1, paeth]
                    ).reshape(5, -1).astype(np.int16)


def _unfilter_wavefront(kinds: np.ndarray, lines: np.ndarray
                        ) -> np.ndarray:
    """Undo the filters of all rows at once: ``lines`` (H, W, C) uint8, the
    filtered bytes of each pixel's C byte columns, and ``kinds`` (H, C),
    each row's filter for each column; any mix of the five. The byte of
    pixel (y, x) depends on pixels (y, x - 1), (y - 1, x) and
    (y - 1, x - 1) of its column only, so every pixel of an anti-diagonal
    y + x = d can be decoded together once diagonals d - 1 and d - 2 are: a
    few array operations per diagonal, H + W - 1 diagonals, the predictor
    one gather from ``_pred_table``. Columns are independent, so images of
    one size decode together, stacked along C. The rows are skewed so that
    each diagonal is a contiguous slice: ``o[d + 2, y + 1]`` is pixel
    (y, d - y); ``o[x + 1, 0]`` is the zero row above the image and
    ``o[y + 1, y + 1]`` the zero pixel left of row y."""
    h, w, cols = lines.shape
    raw = np.zeros((w + h, h, cols), np.uint8)             # (d, y, column)
    for y in range(h):
        raw[y:y + w, y] = lines[y]
    o = np.zeros((w + h + 1, h + 1, cols), np.int32)
    table = _pred_table()
    kinds = kinds.astype(np.int32)
    mixed = bool((kinds != kinds[0, 0]).any())
    if mixed:
        flat = table.reshape(-1)
        # each row's table offset, and 0 to drop c from a None row
        off = kinds * table.shape[1] + 255 * 511 + 255
        keep_c = (kinds != 0).astype(np.int32)
    else:
        flat = table[kinds[0, 0]]
        off = 255 * 511 + 255
    for d in range(h + w - 1):
        lo, hi = max(0, d - w + 1), min(h - 1, d) + 1      # rows on it
        a = o[d + 1, lo + 1:hi + 1]                        # (y, x - 1)
        b = o[d + 1, lo:hi]                                # (y - 1, x)
        c = o[d, lo:hi]                                    # (y - 1, x - 1)
        idx = a - c
        idx *= 511
        idx += b
        idx -= c
        if mixed:
            idx += off[lo:hi]
            t = c * keep_c[lo:hi]
        else:
            idx += off
            t = c.copy() if kinds[0, 0] else np.zeros_like(c)
        t += raw[d, lo:hi]
        t += flat.take(idx)
        t &= 0xFF
        o[d + 2, lo + 1:hi + 1] = t
    out = np.empty((h, w, cols), np.uint8)
    for y in range(h):
        out[y] = o[y + 2:y + 2 + w, y + 1]
    return out


def _unfilter_rows(kinds: np.ndarray, lines: np.ndarray) -> np.ndarray:
    """The row loop: (H,) filters and (H, W, bpp) filtered bytes ->
    (H, W, bpp) pixels."""
    h, w, bpp = lines.shape
    out = np.zeros((h, w * bpp), np.uint8)
    prior = np.zeros(w * bpp, np.uint8)
    for y in range(h):
        out[y] = _unfilter_row(int(kinds[y]), lines[y].reshape(-1), prior,
                               bpp)
        prior = out[y]
    return out.reshape(h, w, bpp)


# The wavefront decodes in H + W - 1 array steps of ~15-40 us whatever the
# filters; the row loop spends ~0.4 us a byte on each Average or Paeth row
# and ~0.01 us on the others. Images of one size whose Average and Paeth
# rows hold more bytes than this many times H + W take the wavefront.
_WAVEFRONT_BYTES_PER_STEP = 40


def _slow_bytes(kinds: np.ndarray, lines: np.ndarray) -> int:
    return int(np.count_nonzero(kinds >= 3)) * lines[0].size


def _split_rows(raw: bytes, h: int, w: int, bpp: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """Inflated PNG image data -> (each row's filter (H,), the filtered
    bytes (H, W, bpp))."""
    if len(raw) != h * (w * bpp + 1):
        raise ValueError("read_image: PNG image data has the wrong length")
    rows = np.frombuffer(raw, np.uint8).reshape(h, w * bpp + 1)
    kinds = rows[:, 0]
    if kinds.size and int(kinds.max()) > 4:
        raise ValueError(f"read_image: unknown PNG filter {int(kinds.max())}")
    return kinds, rows[:, 1:].reshape(h, w, bpp)


def _unfilter(kinds: np.ndarray, lines: np.ndarray) -> np.ndarray:
    """One image's rows, by the cheaper of the row loop and the
    wavefront."""
    h, w, bpp = lines.shape
    if _slow_bytes(kinds, lines) <= _WAVEFRONT_BYTES_PER_STEP * (h + w):
        return _unfilter_rows(kinds, lines)
    return _unfilter_wavefront(np.repeat(kinds[:, None], bpp, 1), lines)


def _png_samples(raw: np.ndarray, w: int, depth: int, ctype: int,
                 palette: np.ndarray | None) -> np.ndarray:
    """Unfiltered rows (H, row bytes) of one image or Adam7 pass ->
    (H, W, C) samples: palette indices looked up (C = 3), alpha dropped,
    gray below 8 bits scaled to 0-255, 16 bits kept as uint16 for gray and
    cut to the high byte for the other types."""
    h = raw.shape[0]
    ch = _PNG_CHANNELS[ctype]
    if depth < 8:
        bits = np.unpackbits(raw, axis=1).reshape(h, -1, depth)
        weights = 1 << np.arange(depth - 1, -1, -1)
        px = (bits * weights).sum(-1)[:, :w].astype(np.uint8)[..., None]
        if ctype == 0:
            px = px * np.uint8(255 // ((1 << depth) - 1))
    elif depth == 16:
        px = raw.reshape(h, w, ch, 2).astype(np.uint16)
        px = (px[..., 0] << 8) | px[..., 1]
        if ctype != 0:
            px = (px >> 8).astype(np.uint8)
    else:
        px = raw.reshape(h, w, ch)
    if ctype == 3:
        return palette[px[..., 0]]
    if ctype in (4, 6):                  # drop alpha
        px = px[..., :ch - 1]
    return px


def _png_parse(path: str, data: bytes):
    """A PNG file -> (its filtered rows, one (filters (H,), filtered bytes
    (H, W, bpp)) per Adam7 pass or one in all, and the function that makes
    samples (H, W, C) from their unfiltered bytes). A row's filter unit is
    its pixel's bytes, or one byte below 8 bits a pixel."""
    pos, idat, hdr, plte = 8, [], None, None
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos: pos + 8])
        body = data[pos + 8: pos + 8 + n]
        crc = data[pos + 8 + n: pos + 12 + n]
        if len(body) != n or len(crc) != 4 or struct.unpack(
                ">I", crc)[0] != zlib.crc32(tag + body):
            raise ValueError(f"read_image: {path}: corrupt PNG chunk {tag}")
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if hdr is None or not idat:
        raise ValueError(f"read_image: {path}: PNG without IHDR or IDAT")
    w, h, depth, ctype, _, _, interlace = hdr
    if ctype not in _PNG_DEPTHS or depth not in _PNG_DEPTHS[ctype] or (
            interlace > 1):
        raise _unsupported(path, f"a PNG of bit depth {depth}, colour type "
                           f"{ctype}, interlace {interlace}")
    palette = None
    if ctype == 3:
        if plte is None:
            raise ValueError(f"read_image: {path}: palette PNG without PLTE")
        palette = np.zeros((256, 3), np.uint8)
        palette[:len(plte)] = plte[:256]
    bits = _PNG_CHANNELS[ctype] * depth
    bpp = max(1, bits // 8)
    raw = zlib.decompress(b"".join(idat))
    passes, sizes = [], []
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        nbytes = ph * (-(-pw * bits // 8) + 1)
        unit = -(-pw * bits // 8) // bpp
        passes.append(_split_rows(raw[:nbytes], ph, unit, bpp))
        sizes.append((x0, y0, dx, dy, pw))
        raw = raw[nbytes:]
    if raw:
        raise ValueError("read_image: PNG image data has the wrong length")

    def finish(unfiltered: list[np.ndarray]) -> np.ndarray:
        parts = [_png_samples(u.reshape(u.shape[0], -1), pw, depth, ctype,
                              palette)
                 for u, (_, _, _, _, pw) in zip(unfiltered, sizes)]
        if not interlace:
            return parts[0]
        out = np.zeros((h, w, parts[0].shape[2]), parts[0].dtype)
        for part, (x0, y0, dx, dy, _) in zip(parts, sizes):
            out[y0::dy, x0::dx] = part
        return out

    return passes, finish


def _pnm_header(data: bytes) -> tuple[int, int, int, int]:
    """A binary PPM/PGM's (width, height, maxval, offset of the samples)."""
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
    return fields[0], fields[1], fields[2], pos + 1


def _png_rows(path: str, data: bytes) -> tuple[np.ndarray, np.ndarray]:
    """A non-interlaced PNG's rows: (filters (H,), filtered bytes (H, W,
    bpp))."""
    passes, _ = _png_parse(path, data)
    if len(passes) != 1:
        raise ValueError(f"read_image: {path}: an interlaced PNG")
    return passes[0]


def _read_pnm(path: str, data: bytes) -> np.ndarray:
    w, h, maxval, offset = _pnm_header(data)
    if maxval != 255:
        raise _unsupported(path, f"a PNM with maxval {maxval}")
    ch = 3 if data[:2] == b"P6" else 1
    px = np.frombuffer(data, np.uint8, count=w * h * ch, offset=offset)
    return px.reshape(h, w, ch)


def _eight_bits(px: np.ndarray, reader: str) -> np.ndarray:
    """16-bit gray to uint8: the high byte (OpenCV), or clipped to 255
    (PIL's ``I;16`` conversions)."""
    if px.dtype != np.uint16:
        return px
    if reader == "cv2":
        return (px >> 8).astype(np.uint8)
    return np.minimum(px, 255).astype(np.uint8)


def _decode_many(paths: list[str], reader: str) -> list[np.ndarray]:
    """Image files -> their samples, each (H, W, 1) gray or (H, W, 3) RGB
    uint8, with ``reader``'s ("cv2" or "pil") semantics. The 8-bit
    non-interlaced PNGs of one size whose Average and Paeth rows make the
    wavefront the cheaper method decode in one wavefront, their byte
    columns side by side; the other PNGs by the cheaper method alone."""
    out: list = [None] * len(paths)
    pending: dict[tuple[int, int], list] = {}
    for i, path in enumerate(paths):
        with open(path, "rb") as f:
            data = f.read()
        if data.startswith(_PNG_SIG):
            passes, finish = _png_parse(path, data)
            kinds, lines = passes[0]
            if len(passes) == 1 and _slow_bytes(kinds, lines):
                pending.setdefault(lines.shape[:2], []).append(
                    (i, kinds, lines, finish))
            else:
                out[i] = _eight_bits(finish([_unfilter(k, ln)
                                             for k, ln in passes]), reader)
        elif data[:2] in (b"P5", b"P6"):
            out[i] = _read_pnm(path, data)
        elif jpeg.is_jpeg(data):
            try:
                dec = jpeg.decode(data)
            except jpeg.JPEGUnsupported as e:
                raise _unsupported(path, str(e)) from None
            except (ValueError, IndexError, KeyError) as e:
                raise ValueError(f"read_image: {path}: {e}") from e
            out[i] = (jpeg.orient(dec.samples, dec.orientation)
                      if reader == "cv2" else dec.samples)
        else:
            raise _unsupported(path, "in a format it does not know")
    for (h, w), group in pending.items():
        slow = sum(_slow_bytes(k, ln) for _, k, ln, _ in group)
        if slow <= _WAVEFRONT_BYTES_PER_STEP * (h + w):
            for i, kinds, lines, finish in group:
                out[i] = _eight_bits(finish([_unfilter_rows(kinds, lines)]),
                                     reader)
            continue
        px = _unfilter_wavefront(
            np.concatenate([np.repeat(k[:, None], ln.shape[2], 1)
                            for _, k, ln, _ in group], 1),
            np.concatenate([ln for _, _, ln, _ in group], 2))
        col = 0
        for i, _, lines, finish in group:
            out[i] = _eight_bits(finish([px[:, :, col:col + lines.shape[2]]]),
                                 reader)
            col += lines.shape[2]
    return out


def read_image(path: str) -> np.ndarray:
    """An image file -> (H, W, 3) BGR uint8, as ``cv2.imread`` gives it."""
    px = _decode_many([path], "cv2")[0]
    return np.repeat(px, 3, 2) if px.shape[2] == 1 else px[:, :, 2::-1].copy()


def _pil_mode(px: np.ndarray, grayscale: bool) -> np.ndarray:
    if grayscale:
        if px.shape[2] == 1:
            return px[:, :, 0].copy()
        rgb = px[:, :, :3].astype(np.uint32)
        return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470
                 + rgb[..., 2] * 7471 + 0x8000) >> 16).astype(np.uint8)
    return np.repeat(px, 3, 2) if px.shape[2] == 1 else px[:, :, :3].copy()


def load_images(paths: list[str], grayscale: list[bool]) -> list[np.ndarray]:
    """Image files as ``PIL.Image.open(path).convert("L" | "RGB")`` gives
    them: (H, W) gray or (H, W, 3) RGB uint8 each, decoded together
    (``_decode_many``). RGB goes to gray by PIL's ITU-R 601-2 integer
    formula (L = (19595 R + 38470 G + 7471 B + 2^15) >> 16)."""
    return [_pil_mode(px, g) for px, g in zip(_decode_many(paths, "pil"),
                                               grayscale)]


def load_image(path: str, grayscale: bool = False) -> np.ndarray:
    """One image file, as ``load_images`` reads it."""
    return load_images([path], [grayscale])[0]


def image_size(path: str) -> tuple[int, int]:
    """(width, height) of a PNG (its IHDR), a JPEG (its frame header) or a
    PNM, as ``PIL.Image.open(path).size`` gives it: no EXIF rotation."""
    with open(path, "rb") as f:
        head = f.read(65536)
    if head.startswith(_PNG_SIG) and head[12:16] == b"IHDR":
        return struct.unpack(">II", head[16:24])
    if jpeg.is_jpeg(head):
        with open(path, "rb") as f:
            return jpeg.size(f.read())
    if head[:2] in (b"P5", b"P6"):
        return _pnm_header(head)[:2]
    raise _unsupported(path, "in a format it does not know")


def _filter_rows(px: np.ndarray, kind: int, bpp: int) -> np.ndarray:
    """PNG filter ``kind`` applied to every row of (H, row_bytes) uint8."""
    x = px.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    if kind == 0:
        pred = np.zeros_like(x)
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = b
    elif kind == 3:
        pred = (a + b) >> 1
    elif kind == 4:
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a,
                        np.where(pb <= pc, b, c))
    else:
        raise ValueError(f"write_png: PNG filter {kind} is not one of 0-4")
    return ((x - pred) & 0xFF).astype(np.uint8)


def write_png(path: str, img: np.ndarray, png_filter: int = 1,
              level: int = 6) -> str:
    """Write (H, W) gray or (H, W, 3) RGB uint8 as an 8-bit PNG whose rows
    all take filter ``png_filter`` (0 None, 1 Sub, 2 Up, 3 Average,
    4 Paeth), deflated by zlib at ``level``."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] not in (1, 3)):
        raise ValueError(f"write_png takes (H, W) or (H, W, 3) uint8, got "
                         f"{img.shape} {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else 3
    rows = _filter_rows(img.reshape(h, w * bpp), png_filter, bpp)
    body = np.concatenate([np.full((h, 1), png_filter, np.uint8), rows], 1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if bpp == 1 else 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIG + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(body.tobytes(), level))
                + chunk(b"IEND", b""))
    return path


def _keys(d: np.ndarray) -> np.ndarray:
    """Keys' cubic kernel, A = -0.75, in float64 at distances |d| < 2."""
    a = -0.75
    d = np.abs(d)
    return np.where(d <= 1, ((a + 2) * d - (a + 3)) * d * d + 1,
                    ((a * d - 5 * a) * d + 8 * a) * d - 4 * a)


def _cubic_taps(n_in: int, n_out: int) -> tuple[np.ndarray, np.ndarray]:
    """Per output index: the 4 clamped source indices and their fp32
    weights, as Intel IPP's cubic resize computes them under OpenCV 5.0
    (measured): the float64 source coordinate's fraction t rounded to
    fp32, the distances 1 + t, t, 1 - t and 2 - t in fp32, Keys' kernel
    on them in float64, each weight rounded to fp32."""
    x = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    s = np.floor(x)
    t = (x - s).astype(np.float32)
    one, two = np.float32(1), np.float32(2)
    d = np.stack([t + one, t, one - t, two - t], 1).astype(np.float64)
    idx = np.clip(s.astype(np.int64)[:, None] + np.arange(-1, 3)[None, :],
                  0, n_in - 1)
    return idx, _keys(d).astype(np.float32)


def _cubic_pass(x: np.ndarray, taps: np.ndarray, w: np.ndarray
                ) -> np.ndarray:
    """One fp32 filtering pass along the first axis: (p0 w0 + p1 w1) +
    (p2 w2 + p3 w3), IPP's order."""
    prod = [x[taps[:, k]] * w[:, k].reshape((-1,) + (1,) * (x.ndim - 1))
            for k in range(4)]
    return (prod[0] + prod[1]) + (prod[2] + prod[3])


def resize_bicubic(img: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """uint8 (H, W[, C]) -> uint8 (out_h, out_w[, C]), bicubic as OpenCV
    (through IPP): the rows filtered first, then the columns, in fp32,
    rounded half to even and saturated."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"resize_bicubic takes uint8, got {img.dtype}")
    iy, wy = _cubic_taps(img.shape[0], out_hw[0])
    ix, wx = _cubic_taps(img.shape[1], out_hw[1])
    rows = _cubic_pass(np.swapaxes(img.astype(np.float32), 0, 1), ix, wx)
    out = _cubic_pass(np.swapaxes(rows, 0, 1), iy, wy)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _linear_taps(n_in: int, n_out: int, clamp: bool
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per output index: the first source index and the two 11-bit
    weights of OpenCV's fixed-point linear resize (``resize.cpp``: the
    fp32 coordinate ``(d + 0.5) * scale - 0.5``, its fraction, each weight
    x 2048 rounded half to even). ``clamp``, for the columns: an index
    before the first or at or past the last source column takes that
    column with weight (2048, 0)."""
    f = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp:
        for edge, at in ((s < 0, 0), (s >= n_in - 1, n_in - 1)):
            f[edge] = 0
            s[edge] = at
    one = np.float32(2048)
    return (s, np.rint((np.float32(1) - f) * one).astype(np.int64),
            np.rint(f * one).astype(np.int64))


def resize_linear(img: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """uint8 (H, W[, C]) -> uint8 (out_h, out_w[, C]), as ``cv2.resize(img,
    (out_w, out_h), interpolation=cv2.INTER_LINEAR)``."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"resize_linear takes uint8, got {img.dtype}")
    h, w = img.shape[:2]
    trail = (None,) * (img.ndim - 2)
    x = img.astype(np.int64)
    sx, a0, a1 = _linear_taps(w, out_hw[1], clamp=True)
    cols = (x[:, sx] * a0[(slice(None),) + trail]
            + x[:, np.minimum(sx + 1, w - 1)] * a1[(slice(None),) + trail])
    sy, b0, b1 = _linear_taps(h, out_hw[0], clamp=False)
    top = cols[np.clip(sy, 0, h - 1)] >> 4
    bottom = cols[np.clip(sy + 1, 0, h - 1)] >> 4
    rows = (slice(None), None) + trail
    out = (((b0[rows] * top) >> 16) + ((b1[rows] * bottom) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def _ipp_linear_taps(n_in: int, n_out: int, dtype
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per output index: the two source indices and the fraction of
    Intel IPP's linear resize (measured through OpenCV 5.0's default
    float path): the float64 coordinate ``(d + 0.5) * n_in / n_out -
    0.5``, its fraction rounded to ``dtype``; before the first or at or
    past the last source index, that index with fraction 0."""
    f = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    s = np.floor(f).astype(np.int64)
    t = (f - s).astype(dtype)
    for edge, at in ((s < 0, 0), (s >= n_in - 1, n_in - 1)):
        t[edge] = 0
        s[edge] = at
    return s, np.minimum(s + 1, n_in - 1), t


def _lerp_fma(a: np.ndarray, b: np.ndarray, t: np.ndarray) -> np.ndarray:
    """fma(b - a, t, a) rounded once to a's float32 (the product of two
    float32 values and the sum are exact or rounded once in float64)."""
    if a.dtype != np.float32:
        return a + (b - a) * t
    return ((b - a).astype(np.float64) * t + a).astype(np.float32)


def resize_linear_float(img: np.ndarray, out_hw: tuple[int, int]
                        ) -> np.ndarray:
    """float (H, W[, C]) -> (out_h, out_w[, C]) of the same dtype, as
    ``cv2.resize(img, (out_w, out_h))`` (INTER_LINEAR) with OpenCV's
    default Intel IPP path: the rows first, then the columns, each ``fma(b
    - a, t, a)``, each channel alike. Byte-equal for float32 (measured
    against OpenCV 5.0.0's bundled IPP on up- and downscales, 1 and 3
    channels); float64 input takes the same steps in float64 and is within
    ~1e-13 of IPP's."""
    img = np.asarray(img)
    if img.dtype not in (np.float32, np.float64) or img.ndim not in (2, 3):
        raise TypeError(f"resize_linear_float takes a float32/64 plane or "
                        f"(H, W, C) image, got {img.shape} {img.dtype}")
    if img.ndim == 3:
        return np.stack([resize_linear_float(np.ascontiguousarray(
            img[..., c]), out_hw) for c in range(img.shape[2])], axis=-1)
    h, w = img.shape
    c0, c1, t = _ipp_linear_taps(w, out_hw[1], img.dtype)
    cols = _lerp_fma(img[:, c0], img[:, c1], t[None])
    r0, r1, u = _ipp_linear_taps(h, out_hw[0], img.dtype)
    return _lerp_fma(cols[r0], cols[r1], u[:, None])


def rotation_matrix_2d(center: tuple[float, float], angle: float,
                       scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, scale)``: the (2, 3) float64
    matrix of a rotation by ``angle`` degrees (counter-clockwise) about
    ``center`` (x, y), which OpenCV takes as float32."""
    cx, cy = (float(np.float32(c)) for c in center)
    a = np.deg2rad(angle)
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


# the columns of a row that OpenCV 5.0's vector loop of warpAffine takes
# at a time; the rest of the row goes through its scalar loop
_WARP_BLOCK = 16


def warp_affine(img: np.ndarray, m: np.ndarray,
                dsize: tuple[int, int]) -> np.ndarray:
    """float32 (H, W[, C]) -> (dsize[1], dsize[0][, C]), as
    ``cv2.warpAffine(img, m, dsize)`` (INTER_LINEAR, constant border 0)
    runs in OpenCV 5.0 (measured; not through IPP): ``m`` inverted in
    float64 and rounded to float32; each destination pixel's source
    coordinate in float32, ``fma(x, M0, y * M1 + M2)`` in the vector loop
    (the first ``16 * (width // 16)`` columns of a row) and ``fma(x, M0,
    y * M1) + M2`` in the scalar one; then ``fma(p01 - p00, a, p00)`` along
    x and the same along y, with the pixels outside the image 0.
    Byte-equal to OpenCV 5.0.0 on float32 images."""
    img = np.asarray(img)
    if img.dtype != np.float32:
        raise TypeError(f"warp_affine takes float32, got {img.dtype}")
    m = np.asarray(m, np.float64).reshape(2, 3)
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22, a12, a21 = m[1, 1] * d, m[0, 0] * d, -m[0, 1] * d, -m[1, 0] * d
    inv = np.array([a11, a12, -a11 * m[0, 2] - a12 * m[1, 2],
                    a21, a22, -a21 * m[0, 2] - a22 * m[1, 2]]).astype(
                        np.float32)
    w_out, h_out = dsize
    yy, xx = np.mgrid[0:h_out, 0:w_out].astype(np.float32)
    vec = xx < _WARP_BLOCK * (w_out // _WARP_BLOCK)
    f32 = np.float32

    def fma(a, b, c):
        # a float32 product is exact in float64: one rounding, of the sum
        return (a.astype(np.float64) * b + c).astype(f32)

    def coord(m0, m1, m2):
        row = yy * m1
        return np.where(vec, fma(xx, m0, row + m2), fma(xx, m0, row) + m2)

    sx, sy = coord(*inv[:3]), coord(*inv[3:])
    x0, y0 = np.floor(sx), np.floor(sy)
    ax, ay = sx - x0, sy - y0
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    h, w = img.shape[:2]
    trail = (None,) * (img.ndim - 2)

    def px(yi, xi):
        ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        v = img[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]
        return np.where(ok[(...,) + trail], v, f32(0))

    ax, ay = ax[(...,) + trail], ay[(...,) + trail]
    top = _lerp_fma(px(y0, x0), px(y0, x0 + 1), ax)
    bottom = _lerp_fma(px(y0 + 1, x0), px(y0 + 1, x0 + 1), ax)
    return _lerp_fma(top, bottom, ay)


_PIL_PRECISION_BITS = 22          # 32 - 8 - 2, Resample.c


def _pil_cubic(x: np.ndarray) -> np.ndarray:
    """PIL's bicubic filter, a = -0.5 (Resample.c:bicubic_filter)."""
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _pil_taps(n_in: int, n_out: int) -> tuple[np.ndarray, np.ndarray]:
    """Per output index: the source indices of its band and their fixed-point
    weights, (n_out, ksize) each, zero-weighted past the band
    (Resample.c:precompute_coeffs and normalize_coeffs_8bpc)."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(n_out) + 0.5) * scale
    # C's (int) truncates toward zero; clamped at 0 right after
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                      n_in) - xmin
    k = np.arange(ksize)
    idx = xmin[:, None] + k[None, :]
    valid = k[None, :] < xmax[:, None]
    w = np.where(valid, _pil_cubic((idx - center[:, None] + 0.5)
                                   / filterscale), 0.0)
    ww = w.sum(1, keepdims=True)
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    one = float(1 << _PIL_PRECISION_BITS)
    fixed = np.trunc(np.where(w < 0, -0.5 + w * one, 0.5 + w * one))
    return np.minimum(idx, n_in - 1), fixed.astype(np.int64)


def _pil_pass(img: np.ndarray, idx: np.ndarray, w: np.ndarray,
              axis: int) -> np.ndarray:
    """One 8-bit pass along ``axis``: the banded sums in 32-bit integers,
    rounded with 2^21, shifted by 22 and clipped to uint8. A band's
    positive weights sum to under 1.25 * 2^22, so no partial sum of 255 x
    weight terms reaches 2^31."""
    src = img.astype(np.int32)
    w = w.astype(np.int32)
    shape = [1] * src.ndim
    shape[axis] = idx.shape[0]
    acc = np.take(src, idx[:, 0], axis=axis) * w[:, 0].reshape(shape)
    acc += 1 << (_PIL_PRECISION_BITS - 1)
    for k in range(1, idx.shape[1]):
        acc += np.take(src, idx[:, k], axis=axis) * w[:, k].reshape(shape)
    acc >>= _PIL_PRECISION_BITS
    return np.clip(acc, 0, 255).astype(np.uint8)


def resize_bicubic_pil(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """uint8 (H, W[, C]) -> (out_h, out_w[, C]) as ``PIL.Image.fromarray(img)
    .resize(size, Image.BICUBIC)`` gives it; ``size`` is (width, height),
    as PIL takes it. A pass runs only along an axis whose size changes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"resize_bicubic_pil takes uint8, got {img.dtype}")
    out_w, out_h = size
    if img.shape[1] != out_w:
        img = _pil_pass(img, *_pil_taps(img.shape[1], out_w), axis=1)
    if img.shape[0] != out_h:
        img = _pil_pass(img, *_pil_taps(img.shape[0], out_h), axis=0)
    return img


def _circle_stamp(radius: int) -> tuple[np.ndarray, np.ndarray]:
    """(dy, dx) offsets of the pixels ``cv2.circle(..., thickness=-1)``
    fills around an integer centre: OpenCV's midpoint circle
    (drawing.cpp:Circle), whose every step fills the rows +-dy over
    +-dx and the rows +-dx over +-dy."""
    cells = set()
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for ry, rx in ((dy, dx), (dx, dy)):
            for sy in (-ry, ry):
                cells.update((sy, x) for x in range(-rx, rx + 1))
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    off = np.array(sorted(cells), np.int64)
    return off[:, 0], off[:, 1]


def draw_dots(lm: np.ndarray, crop_size: int) -> np.ndarray:
    """The landmark-dot image of the data layer (``data/umlvd_ifw.py``):
    a filled circle of radius 3 (5 at 512) at each rounded (x, y) of ``lm``
    (N, 2), on a zero crop_size^2 image, as (crop_size, crop_size, 1)
    float32 in [-1, 1]. Pixels outside the image are dropped."""
    radius = 5 if crop_size == 512 else 3
    dy, dx = _circle_stamp(radius)
    c = np.round(np.asarray(lm)).astype(np.int64)
    ys = (c[:, 1:2] + dy[None]).reshape(-1)
    xs = (c[:, 0:1] + dx[None]).reshape(-1)
    keep = (ys >= 0) & (ys < crop_size) & (xs >= 0) & (xs < crop_size)
    img = np.zeros((crop_size, crop_size), np.uint8)
    img[ys[keep], xs[keep]] = 255
    return (img[..., None].astype(np.float32) / 255.0) * 2 - 1


# --- landmark drawings (the reference's draw2) --------------------------

_XY_SHIFT = 16                     # OpenCV drawing's fixed point
_XY_ONE = 1 << _XY_SHIFT


def _cdiv(a: int, b: int) -> int:
    """C's integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def _fill_disc(img: np.ndarray, cx: int, cy: int, radius: int) -> None:
    """``cv2.circle(img, (cx, cy), radius, 255, -1)``: OpenCV's midpoint
    circle (``_circle_stamp``), clipped at the borders."""
    dy, dx = _circle_stamp(radius)
    ys, xs = cy + dy, cx + dx
    keep = (ys >= 0) & (ys < img.shape[0]) & (xs >= 0) & (xs < img.shape[1])
    img[ys[keep], xs[keep]] = 255


def _clip_line(w: int, h: int, p1: list, p2: list) -> bool:
    """drawing.cpp's ``clipLine`` on (w, h) in place; False when the
    segment misses the image."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(*p1), code(*p2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        x1, y1 = p1
        x2, y2 = p2
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
        p1[:], p2[:] = [x1, y1], [x2, y2]
    return (c1 | c2) == 0


def _line2(img: np.ndarray, p1: tuple, p2: tuple) -> None:
    """``Line2`` of OpenCV 5.0's drawing.cpp, which draws a polygon's
    edges: the segment between two points in 16-bit fixed point clipped to
    the image, then one pixel a step along the longer axis from the start
    rounded to the nearest pixel, the other coordinate stepped in fixed
    point, and the rounded end's pixel (measured against OpenCV 5.0)."""
    h, w = img.shape[:2]
    p1, p2 = list(p1), list(p2)
    if not _clip_line(w << _XY_SHIFT, h << _XY_SHIFT, p1, p2):
        return
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    half = _XY_ONE >> 1
    if abs(dx) > abs(dy):
        if dx < 0:
            p1, p2, dy = p2, p1, -dy
        step = _cdiv(dy * _XY_ONE, abs(dx) | 1)
        count = (p2[0] - p1[0]) >> _XY_SHIFT
        xs = ((p1[0] + half) >> _XY_SHIFT) + np.arange(count + 1)
        ys = (p1[1] + half + step * np.arange(count + 1)) >> _XY_SHIFT
    else:
        if dy < 0:
            p1, p2, dx = p2, p1, -dx
        step = _cdiv(dx * _XY_ONE, abs(dy) | 1)
        count = (p2[1] - p1[1]) >> _XY_SHIFT
        xs = (p1[0] + half + step * np.arange(count + 1)) >> _XY_SHIFT
        ys = ((p1[1] + half) >> _XY_SHIFT) + np.arange(count + 1)
    # the end's own pixel, which the steps can stop short of
    xs = np.append(xs, (p2[0] + half) >> _XY_SHIFT)
    ys = np.append(ys, (p2[1] + half) >> _XY_SHIFT)
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep], xs[keep]] = 255


def _line8(img: np.ndarray, p1: tuple, p2: tuple) -> None:
    """``cv2.line(img, p1, p2, 255)`` (LINE_8) between integer points:
    drawing.cpp's ``Line``, a ``LineIterator`` taken left to right over
    the segment clipped to the image (Bresenham: one step along the
    longer axis each pixel, one along the shorter when the error is
    negative)."""
    h, w = img.shape[:2]
    p1, p2 = list(p1), list(p2)
    if not _clip_line(w, h, p1, p2):
        return
    if p2[0] < p1[0]:
        p1, p2 = p2, p1
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    sy = -1 if dy < 0 else 1
    if abs(dy) > dx:        # y is the longer axis
        n, m, major, minor = abs(dy), dx, (0, sy), (1, 0)
    else:
        n, m, major, minor = dx, abs(dy), (1, 0), (0, sy)
    err, x, y = n - 2 * m, p1[0], p1[1]
    for _ in range(n + 1):
        img[y, x] = 255
        neg = err < 0
        err += -2 * m + (2 * n if neg else 0)
        x, y = x + major[0] + (minor[0] if neg else 0), \
            y + major[1] + (minor[1] if neg else 0)


def _fill_convex(img: np.ndarray, v: list, integer: bool = False) -> None:
    """drawing.cpp's ``FillConvexPoly`` for 8-connected lines and vertices
    in 16-bit fixed point: the outline by ``_line2`` (``Line``, ``_line8``,
    for ``integer`` vertices, which ``cv2.fillConvexPoly`` with no shift
    draws), then each scanline between two edges walked in fixed point."""
    h, w = img.shape[:2]
    n = len(v)
    delta = _XY_ONE >> 1
    prev = v[-1]
    for p in v:
        if integer:
            _line8(img, (prev[0] >> _XY_SHIFT, prev[1] >> _XY_SHIFT),
                   (p[0] >> _XY_SHIFT, p[1] >> _XY_SHIFT))
        else:
            _line2(img, prev, p)
        prev = p
    ys = [p[1] for p in v]
    imin = int(np.argmin(ys))
    xmin = (min(p[0] for p in v) + delta) >> _XY_SHIFT
    xmax = (max(p[0] for p in v) + delta) >> _XY_SHIFT
    ymin = (min(ys) + delta) >> _XY_SHIFT
    ymax = (max(ys) + delta) >> _XY_SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = n
    # per edge: [idx, di, x, dx, ye]
    edge = [[imin, 1, -_XY_ONE, 0, ymin], [imin, n - 1, -_XY_ONE, 0, ymin]]
    y = ymin
    while True:
        for e in edge:
            if y >= e[4]:
                idx0, di = e[0], e[1]
                idx = (idx0 + di) % n
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (v[idx][1] + delta) >> _XY_SHIFT
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        e[4] = ty
                        e[3] = _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e[2] = xs
                        e[0] = idx
                        break
                    idx0 = idx
                    idx = (idx + di) % n
        if edges < 0:
            break
        if y >= 0:
            left, right = sorted((edge[0][2], edge[1][2]))
            x1 = (left + delta) >> _XY_SHIFT
            x2 = (right + delta) >> _XY_SHIFT
            if x2 >= 0 and x1 < w:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = 255
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


def draw_thick_line(img: np.ndarray, p0: tuple, p1: tuple,
                    thickness: int) -> None:
    """``cv2.line(img, p0, p1, 255, thickness)`` for thickness >= 2, as
    OpenCV 5.0 draws it (measured): the segment clipped to the image grown
    by ``thickness`` on each side, then drawing.cpp's ``ThickLine``: a
    filled quadrilateral of half-width thickness / 2 in 16-bit fixed point
    (corner offsets rounded half to even) and, at each end, a filled disc
    of radius ((thickness << 15) + 2^15) >> 16."""
    if thickness < 2:
        raise ValueError(f"draw_thick_line draws thickness >= 2, not "
                         f"{thickness}")
    h, w = img.shape[:2]
    q0 = [p0[0] + thickness, p0[1] + thickness]
    q1 = [p1[0] + thickness, p1[1] + thickness]
    if not _clip_line(w + 2 * thickness, h + 2 * thickness, q0, q1):
        return
    p0 = (q0[0] - thickness, q0[1] - thickness)
    p1 = (q1[0] - thickness, q1[1] - thickness)
    q0 = (p0[0] << _XY_SHIFT, p0[1] << _XY_SHIFT)
    q1 = (p1[0] << _XY_SHIFT, p1[1] << _XY_SHIFT)
    dx = float(p0[0] - p1[0])
    dy = float(p1[1] - p0[1])
    r = dx * dx + dy * dy
    half = thickness << (_XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (half + (thickness & 1) * _XY_ONE * 0.5) / np.sqrt(r)
        ox, oy = int(np.rint(dy * r)), int(np.rint(dx * r))
        _fill_convex(img, [(q0[0] + ox, q0[1] + oy), (q0[0] - ox, q0[1] - oy),
                           (q1[0] - ox, q1[1] - oy), (q1[0] + ox, q1[1] + oy)])
    radius = (half + (_XY_ONE >> 1)) >> _XY_SHIFT
    for p in (p0, p1):
        _fill_disc(img, p[0], p[1], radius)


# ImageDraw's colour names (ImageColor.getrgb)
_PIL_COLORS = {"pink": (255, 192, 203), "blue": (0, 0, 255),
               "green": (0, 128, 0), "purple": (128, 0, 128),
               "cyan": (0, 255, 255), "brown": (165, 42, 42),
               "orange": (255, 165, 0), "yellow": (255, 255, 0),
               "magenta": (255, 0, 255), "black": (0, 0, 0)}
POLY_LOOPS = (
    tuple(range(17)) + (26, 25, 24, 23, 22, 21, 20, 19, 18, 17),
    (21, 20, 19, 18, 17), (26, 25, 24, 23, 22),
    (39, 38, 37, 36, 41, 40), (45, 44, 43, 42, 47, 46),
    (35, 27, 31, 32, 33, 34),
    (54, 53, 52, 51, 50, 49, 48, 60, 61, 62, 63, 64),
    (54, 64, 65, 66, 67, 60, 48, 59, 58, 57, 56, 55),
    (64, 63, 62, 61, 60, 67, 66, 65))
POLY_COLORS = ("pink", "blue", "green", "purple", "cyan", "brown",
               "orange", "yellow", "magenta")


def _pil_hline(img: np.ndarray, x0: int, y: int, x1: int, ink) -> None:
    """Draw.c's hline32: clipped to the image, nothing when x1 < x0."""
    h, w = img.shape[:2]
    if 0 <= y < h and x0 < w and x1 >= 0:
        img[y, max(x0, 0):min(x1, w - 1) + 1] = ink


def _round_up(f: float) -> int:
    return int(np.floor(f + 0.5)) if f >= 0 else -int(np.floor(abs(f) + 0.5))


def _round_down(f: float) -> int:
    return int(np.ceil(f - 0.5)) if f >= 0 else -int(np.ceil(abs(f) - 0.5))


def _pil_roundf(v: float) -> float:
    """C's roundf: half away from zero."""
    return float(np.sign(v) * np.floor(abs(v) + 0.5))


def _pil_fill_polygon(img: np.ndarray, xy: list, ink) -> None:
    """``ImageDraw.polygon(xy, fill=ink)`` as Pillow 12.1's Draw.c fills it
    (``ImagingDrawPolygon`` and ``polygon_generic``, read from the
    compiled library): an edge list (a horizontal edge that continues the
    one before it in the same direction merged into it; horizontal edges
    drawn as they are), then one scanline a row with C float (fp32)
    intersections. An edge that ends on the row (not the last row) counts
    twice. An edge that starts on the row (or ends on the last row) makes
    a corner with the first earlier edge that has an end on the row at the
    same rounded x and runs on into the next row (the row before, on the
    last row); where the corner stands more than a pixel clear of both
    edges on that row, its intersection moves to the pixel beside the
    nearer one. Spans run from ``ROUND_UP`` of each odd intersection to
    ``ROUND_DOWN`` of the next."""
    f32 = np.float32
    edges = []                 # [xmin, xmax, ymin, ymax, dx, x0, y0]
    n = len(xy)
    for i in range(n - 1):
        (x0, y0), (x1, y1) = xy[i], xy[i + 1]
        if y0 == y1 and i != 0 and y0 == xy[i - 1][1]:
            if x1 > x0 > xy[i - 1][0]:
                edges[-1][1] = x1
                continue
            if x1 < x0 < xy[i - 1][0]:
                edges[-1][0] = x1
                continue
        edges.append(_pil_edge(x0, y0, x1, y1))
    if xy[-1] != xy[0]:
        edges.append(_pil_edge(*xy[-1], *xy[0]))
    h = img.shape[0]
    ymin, ymax = h - 1, 0
    table = []
    for e in edges:
        ymin, ymax = min(ymin, e[2]), max(ymax, e[3])
        if e[2] == e[3]:
            _pil_hline(img, e[0], e[2], e[1], ink)
            continue
        table.append(e)
    ymin, ymax = max(ymin, 0), min(ymax, h)

    def at(e, y):
        return f32(f32(f32(y - e[6]) * e[4]) + f32(e[5]))

    for y in range(ymin, ymax + 1):
        xx = []
        for i, cur in enumerate(table):
            if not cur[2] <= y <= cur[3]:
                continue
            x = at(cur, y)
            xx.append(x)
            if y == cur[3] and y < ymax:
                xx.append(x)
                continue
            if (y != cur[2] and y != cur[3]) or cur[4] == 0:
                continue
            # the edge starts here (or ends on the last row): a corner
            # with the first earlier edge that has an end on this row at
            # the same rounded x and runs on into the next row (the row
            # before, on the last row)
            nxt = y - 1 if y == cur[3] else y + 1
            for other in table[:i]:
                if (y != other[2] and y != other[3]) or other[4] == 0 or (
                        _pil_roundf(at(other, y)) != _pil_roundf(x)) or not (
                        other[2] <= nxt <= other[3]):
                    continue
                a, b = at(cur, nxt), at(other, nxt)
                if x > a + 1 and x > b + 1:
                    xx[-1] = f32(f32(_pil_roundf(max(a, b))) + 1)
                elif x < a - 1 and x < b - 1:
                    xx[-1] = f32(f32(_pil_roundf(min(a, b))) - 1)
                break
        xx.sort()
        for i in range(1, len(xx), 2):
            x0, x1 = _round_up(xx[i - 1]), _round_down(xx[i])
            if x1 >= x0:
                _pil_hline(img, x0, y, x1, ink)


def _pil_edge(x0: int, y0: int, x1: int, y1: int) -> list:
    """Draw.c's add_edge: [xmin, xmax, ymin, ymax, dx (fp32), x0, y0]."""
    dx = np.float32(0) if y0 == y1 else np.float32(
        np.float32(x1 - x0) / np.float32(y1 - y0))
    return [min(x0, x1), max(x0, x1), min(y0, y1), max(y0, y1), dx, x0, y0]


def _pil_line(img: np.ndarray, x0: int, y0: int, x1: int, y1: int,
              ink) -> None:
    """Draw.c's line32 as a polygon outline draws it: Bresenham, the end
    point left to the next segment (drawn for vertical and horizontal
    runs), nothing for a segment of length 0 (measured)."""
    if (x0, y0) == (x1, y1):
        return
    h, w = img.shape[:2]
    dx, dy = abs(x1 - x0), abs(y1 - y0)
    xs = 1 if x1 >= x0 else -1
    ys = 1 if y1 >= y0 else -1
    if dx == 0:
        pts = [(x0, y) for y in range(min(y0, y1), max(y0, y1) + 1)]
    elif dy == 0:
        pts = [(x, y0) for x in range(min(x0, x1), max(x0, x1) + 1)]
    elif dx > dy:
        pts = []
        e = 2 * dy - dx
        for _ in range(dx):
            pts.append((x0, y0))
            if e >= 0:
                y0 += ys
                e -= 2 * dx
            e += 2 * dy
            x0 += xs
    else:
        pts = []
        e = 2 * dx - dy
        for _ in range(dy):
            pts.append((x0, y0))
            if e >= 0:
                x0 += xs
                e -= 2 * dy
            e += 2 * dx
            y0 += ys
    for x, y in pts:
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = ink


def draw_landmarks(height: int, width: int, lands: np.ndarray,
                   radius: int = 3, thickness: int = 2,
                   op: int = 0) -> np.ndarray:
    """The reference's ``draw2`` (umlvdfw_test_dataset.py:34-65), as the
    JAX package's ``pipeline/render.py:draw_landmarks`` draws it with
    OpenCV and PIL, exactly. ``lands`` (68, 2) (x, y), rounded to
    integers. op 0: a ``cv2.circle`` filled disc of ``radius`` at each
    point; op 1: op 0 plus a ``cv2.line`` of ``thickness`` over each pair of
    ``faceLmarkLookup``; both (H, W, 1) float32 in {-1, 1}. op 2: PIL's
    ``ImageDraw.polygon`` with a colour fill and a black outline over each
    loop of ``POLY_LOOPS`` on white, (H, W, 3) float32 in [-1, 1]."""
    from portbench.reference.frozen.utils.assets import face_lmark_lookup

    lands = np.round(np.asarray(lands)).astype(np.int64)
    if op in (0, 1):
        frame = np.zeros((height, width), np.uint8)
        for x, y in lands.tolist():
            _fill_disc(frame, x, y, radius)
        if op == 1:
            for a, b in face_lmark_lookup().tolist():
                draw_thick_line(frame, tuple(lands[a].tolist()),
                                tuple(lands[b].tolist()), thickness)
        return (frame[..., None].astype(np.float32) / 255.0) * 2 - 1
    if op == 2:
        img = np.full((height, width, 3), 255, np.uint8)
        for loop, color in zip(POLY_LOOPS, POLY_COLORS):
            pts = [tuple(lands[i].tolist()) for i in loop]
            _pil_fill_polygon(img, pts, _PIL_COLORS[color])
            black = _PIL_COLORS["black"]
            for (x0, y0), (x1, y1) in zip(pts, pts[1:] + pts[:1]):
                _pil_line(img, x0, y0, x1, y1, black)
        return (img.astype(np.float32) / 255.0) * 2 - 1
    raise ValueError(f"draw_landmarks: op {op} is not 0, 1 or 2")
