"""Baseline JPEG decoding on the host, with no library: the decoder behind
``utils/image.py``'s ``read_image`` (``cv2.imread``) and ``load_image``
(``PIL.Image.open(path).convert(...)``), both of which decode with
libjpeg-turbo. ``decode`` gives the samples that libjpeg-turbo gives with
its defaults (islow IDCT, fancy upsampling), byte for byte.

Read: sequential DCT frames (SOF0, and SOF1 with 8-bit samples) with
Huffman coding, optimized tables included; 1 or 3 components; any
sampling factors whose ratio to the largest is 1 or 2 along each axis
(4:4:4, 4:2:2, 4:2:0, 4:4:0) or another integer; one interleaved scan or
several scans of some components each; restart intervals; byte stuffing
and fill bytes; any width and height (partial MCUs are decoded and
cropped). Refused by name (``JPEGUnsupported``): progressive, lossless,
hierarchical and arithmetic-coded frames, 12- and 16-bit samples, and 2-
or 4-component files (CMYK, YCCK).

The arithmetic is libjpeg-turbo's:

- entropy decoding (``jdhuff.c``): one 65 536-entry table per Huffman
  table, indexed by the next 16 bits of the scan, gives the code's length
  and symbol and, where code and value fit in those 16 bits, the value
  too. This part is sequential and stays a Python loop over the
  coefficients; the scan is unstuffed once into a byte array whose 32-bit
  big-endian windows the loop reads. A run past the end reads zeros, as
  libjpeg does;
- ``jidctint.c``'s islow IDCT (13-bit constants, a 2-bit first pass,
  ``DESCALE`` rounding, the 1024-entry range-limit table of
  ``jdmaster.c``), vectorised over all blocks in int64;
- ``jdsample.c``'s fancy upsampling: h2v1 (3/4 + 1/4, biases +1/+2),
  h2v2 (9/16 3/16 3/16 1/16, biases +8/+7) and h1v2 (biases +1/+2), edge
  samples replicated at the component's own size; box replication for a
  component at most 2 samples wide and for other integer ratios;
- ``jdcolor.c``'s YCbCr -> RGB in 16-bit fixed point (``SCALEBITS`` 16,
  ``ONE_HALF``), then clamped.

The colour space follows libjpeg's guess (``jdapimin.c``): YCbCr for a
JFIF file, for an Adobe APP14 with transform 1, or for component ids
1, 2, 3; RGB for an Adobe transform 0 or ids 'R', 'G', 'B'. The EXIF
orientation tag of an APP1 ``Exif`` segment (either byte order) is
returned beside the samples; applying it is the caller's choice. A scan
whose DC or AC table 0 or 1 no DHT defined takes the standard table of
Annex K, as libjpeg-turbo's ``std_huff_tables`` gives it: Motion-JPEG
frames (the ``AVI1`` convention) leave their tables out.

``encode_jpeg`` writes what ``cv2.imwrite(path.jpg, img)`` writes with its
defaults through libjpeg-turbo: JFIF 1.01, quality 95, 4:2:0 for colour
(one component for gray), the standard Huffman tables, one interleaved
scan, no restart markers. Its arithmetic is libjpeg-turbo's:
``jcparam.c``'s quality scaling of the Annex K quantizers, ``jccolor.c``'s
16-bit fixed-point RGB -> YCbCr, the edge expansion of ``jcprepct.c`` and
``jcsample.c`` (the last column and row replicated) with ``h2v2_downsample``
(biases 1, 2 alternating), dummy blocks that repeat the DC of the block
before them (``jccoefct.c``), ``jfdctint.c``'s islow forward DCT and
``jcdctmgr.c``'s quantization (rounded half away from zero). The entropy
coder is vectorised: every block's symbols are built, ordered and packed
with array operations.
"""
from __future__ import annotations

import dataclasses
import functools
import struct

import numpy as np

# zigzag position -> natural (row-major) index, with libjpeg's 16 guard
# entries of 63 for runs that overshoot in a corrupt stream
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
    + [63] * 16)
_EOB = 64          # the run an end-of-block symbol carries in the tables

_REFUSED_SOF = {
    0xC2: "a progressive JPEG (SOF2)",
    0xC3: "a lossless JPEG (SOF3)",
    0xC5: "a hierarchical JPEG (SOF5)",
    0xC6: "a hierarchical progressive JPEG (SOF6)",
    0xC7: "a hierarchical lossless JPEG (SOF7)",
    0xC9: "an arithmetic-coded JPEG (SOF9)",
    0xCA: "an arithmetic-coded progressive JPEG (SOF10)",
    0xCB: "an arithmetic-coded lossless JPEG (SOF11)",
    0xCD: "an arithmetic-coded hierarchical JPEG (SOF13)",
    0xCE: "an arithmetic-coded hierarchical JPEG (SOF14)",
    0xCF: "an arithmetic-coded hierarchical JPEG (SOF15)",
}
_SOF = (0xC0, 0xC1) + tuple(_REFUSED_SOF)


# Annex K's tables (jstdhuff.c): counts of codes of length 1-16, symbols
STD_DC_LUMA = (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]),
               bytes(range(12)))
STD_DC_CHROMA = (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]),
                 bytes(range(12)))
STD_AC_LUMA = (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]),
               bytes.fromhex(
                   "01020300041105122131410613516107227114328191a1082342b1c1"
                   "1552d1f02433627282090a161718191a25262728292a343536373839"
                   "3a434445464748494a535455565758595a636465666768696a737475"
                   "767778797a838485868788898a92939495969798999aa2a3a4a5a6a7"
                   "a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8"
                   "d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
STD_AC_CHROMA = (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]),
                 bytes.fromhex(
                     "00010203110405213106124151076171132232810814429"
                     "1a1b1c109233352f0156272d10a162434e125f11718191a"
                     "262728292a35363738393a434445464748494a535455565"
                     "758595a636465666768696a737475767778797a82838485"
                     "868788898a92939495969798999aa2a3a4a5a6a7a8a9aab"
                     "2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7"
                     "d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))
# (table class, slot) -> the table a scan takes when no DHT defined it
_STD_TABLES = {(0, 0): STD_DC_LUMA, (1, 0): STD_AC_LUMA,
               (0, 1): STD_DC_CHROMA, (1, 1): STD_AC_CHROMA}


class JPEGUnsupported(ValueError):
    """A JPEG of a kind the decoder does not read; the message names it."""


@dataclasses.dataclass
class _Component:
    cid: int
    h: int
    v: int
    tq: int
    width: int = 0        # samples, before upsampling
    height: int = 0
    bw: int = 0           # blocks allocated per row (whole MCUs)
    bh: int = 0
    offset: int = 0       # first coefficient in the shared list


@dataclasses.dataclass
class Decoded:
    samples: np.ndarray   # (H, W, 1) gray or (H, W, 3) RGB uint8
    orientation: int      # EXIF orientation 1-8 (1 when there is none)


def _u16(data: bytes, pos: int) -> int:
    return (data[pos] << 8) | data[pos + 1]


def is_jpeg(data: bytes) -> bool:
    return data[:3] == b"\xff\xd8\xff"


def size(data: bytes) -> tuple[int, int]:
    """(width, height) from the first SOF marker, of any kind, as
    ``PIL.Image.open(path).size`` gives it (no EXIF rotation)."""
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise ValueError("corrupt JPEG: no marker where one is due")
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        if marker in _SOF:
            h, w = struct.unpack(">HH", data[pos + 5: pos + 9])
            return w, h
        if marker in (0xD9, 0xDA):
            break
        pos += 2 + _u16(data, pos + 2)
    raise ValueError("corrupt JPEG: no frame header before the scan")


@functools.lru_cache(maxsize=64)
def _lookup(counts: bytes, symbols: bytes, ac: bool) -> list:
    """One Huffman table as a list indexed by the next 16 bits of the scan:
    (bits used, run, value, extra bits still to read) each; bits used 0 for
    a prefix no code starts. Where the code and its value fit in 16 bits
    the value is decoded (``extra`` 0); else only the code is used and
    ``extra`` bits follow. For AC the run is the symbol's zero run, or
    ``_EOB`` for a symbol that ends the block (size 0, run other than
    15); a ZRL (run 15, size 0) writes a zero after its 15 zeros."""
    lens = np.zeros(65536, np.int64)
    syms = np.zeros(65536, np.int64)
    code = k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= 1 << length:
                raise ValueError("corrupt JPEG: bad Huffman table")
            lo, hi = code << (16 - length), (code + 1) << (16 - length)
            lens[lo:hi] = length
            syms[lo:hi] = symbols[k]
            k += 1
            code += 1
        code <<= 1
    s = syms & 15 if ac else syms
    run = np.where((s == 0) & ((syms >> 4) != 15), _EOB, syms >> 4) if ac \
        else np.zeros_like(syms)
    w = np.arange(65536, dtype=np.int64)
    fits = (lens > 0) & (lens + s <= 16)
    shift = np.where(fits, 16 - lens - s, 0)
    extra = (w >> shift) & ((1 << s) - 1)
    value = np.where(extra < (1 << np.maximum(s - 1, 0)),
                     extra - (1 << s) + 1, extra)
    value = np.where(fits & (s > 0), value, 0)
    used = np.where(fits, lens + s, lens)
    slow = np.where(fits, 0, s)
    return list(zip(used.tolist(), run.tolist(), value.tolist(),
                    slow.tolist()))


def _unstuff(data: bytes, pos: int) -> tuple[bytes, list[int], int]:
    """Entropy-coded data from ``pos``: (the bytes with stuffing, fill
    bytes and restart markers taken out; the offset in them where each
    restart segment starts; the position of the marker that ends the
    scan)."""
    buf = np.frombuffer(data, np.uint8)
    ffs = np.flatnonzero(buf[pos:] == 0xFF) + pos
    chunks, segs, length, cur = [], [0], 0, pos
    for j in ffs.tolist():
        if j < cur:
            continue
        nxt = data[j + 1] if j + 1 < len(data) else 0xD9
        if nxt == 0x00:                       # a stuffed 0xFF
            chunks.append(data[cur:j + 1])
            length += j + 1 - cur
            cur = j + 2
        elif nxt == 0xFF:                     # a fill byte before a marker
            chunks.append(data[cur:j])
            length += j - cur
            cur = j + 1
        elif 0xD0 <= nxt <= 0xD7:             # RSTn
            chunks.append(data[cur:j])
            length += j - cur
            segs.append(length)
            cur = j + 2
        else:
            chunks.append(data[cur:j])
            return b"".join(chunks), segs, j
    chunks.append(data[cur:])
    return b"".join(chunks), segs, len(data)


def _windows(stream: bytes) -> list[int]:
    """The 32-bit big-endian word at each byte of ``stream``, zero past
    its end."""
    b = np.frombuffer(stream + bytes(8), np.uint8).astype(np.int64)
    return ((b[:-7] << 24) | (b[1:-6] << 16) | (b[2:-5] << 8)
            | b[3:-4]).tolist()


def _decode_scan(stream: bytes, segs: list[int], blocks: list,
                 restart_every: int, coefs: list, n_comp: int) -> None:
    """Huffman-decode one scan into ``coefs`` (natural order). ``blocks``
    holds, per block in scan order, (first coefficient, DC table, AC table,
    component's DC predictor slot, starts an MCU); ``restart_every`` is the
    restart interval in MCUs (0 for none)."""
    win = _windows(stream)
    zz = _ZIGZAG.tolist()
    pred = [0] * n_comp
    p = 0
    mcu = 0
    seg = 0
    for base, dct, act, ci, first in blocks:
        if first:
            if restart_every and mcu and mcu % restart_every == 0:
                seg += 1
                if seg >= len(segs):
                    raise ValueError("corrupt JPEG: a restart marker is "
                                     "missing")
                p = segs[seg] << 3
                pred = [0] * n_comp
            mcu += 1
        # DC
        n, _, val, s = dct[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
        if not n:
            raise ValueError("corrupt JPEG: bad Huffman code")
        p += n
        if s:
            val = (win[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
            p += s
            if val < 1 << (s - 1):
                val -= (1 << s) - 1
        val += pred[ci]
        pred[ci] = val
        coefs[base] = val
        # AC
        k = 1
        while k < 64:
            n, r, val, s = act[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
            if not n:
                raise ValueError("corrupt JPEG: bad Huffman code")
            p += n
            if r == _EOB:
                break
            k += r
            if s:
                val = (win[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                p += s
                if val < 1 << (s - 1):
                    val -= (1 << s) - 1
            coefs[base + zz[k]] = val
            k += 1


# jidctint.c, CONST_BITS 13
_C = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373,
          f1175=9633, f1501=12299, f1847=15137, f1961=16069, f2053=16819,
          f2562=20995, f3072=25172)


def _idct_1d(x: list, final_shift: int) -> list:
    """One pass of the islow IDCT over axis-aligned slices ``x[0..7]``
    (int64 arrays), each output rounded by ``DESCALE(., final_shift)``."""
    c = _C
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * c["f0541"]
    tmp2 = z1 - z3 * c["f1847"]
    tmp3 = z1 + z2 * c["f0765"]
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * c["f1175"]
    t0 = t0 * c["f0298"]
    t1 = t1 * c["f2053"]
    t2 = t2 * c["f3072"]
    t3 = t3 * c["f1501"]
    z1 = z1 * -c["f0899"]
    z2 = z2 * -c["f2562"]
    z3 = z3 * -c["f1961"] + z5
    z4 = z4 * -c["f0390"] + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    half = 1 << (final_shift - 1)
    return [(v + half) >> final_shift for v in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


@functools.lru_cache(maxsize=1)
def _idct_range_limit() -> np.ndarray:
    """jdmaster.c's post-IDCT table, indexed by ``x & 1023``: x + 128
    clamped to [0, 255] for |x| up to 512, wrapping beyond."""
    i = np.arange(1024)
    return np.select([i < 128, i < 512, i < 896], [i + 128, 255, 0],
                     i - 896).astype(np.uint8)


def idct_islow(blocks: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """(N, 8, 8) coefficients (natural order) and their (8, 8) quantizers
    -> (N, 8, 8) uint8 samples, level-shifted and range-limited, as
    ``jpeg_idct_islow``. Its all-zero-AC shortcuts give the same values as
    the full formula, so there are none here."""
    x = blocks.astype(np.int64) * quant.astype(np.int64)
    cols = _idct_1d([x[:, k, :] for k in range(8)], 13 - 2)   # pass 1
    ws = np.stack(cols, axis=1)
    rows = _idct_1d([ws[:, :, k] for k in range(8)], 13 + 2 + 3)
    out = np.stack(rows, axis=2)
    return _idct_range_limit()[out & 1023]


def _upsample(plane: np.ndarray, fx: int, fy: int) -> np.ndarray:
    """A component's (height, width) samples -> (fy * height, fx * width),
    as jdsample.c chooses and computes it."""
    x = plane.astype(np.int32)
    h, w = x.shape
    if (fx, fy) == (1, 1):
        return plane
    if (fx, fy) == (2, 1) and w > 2:                 # h2v1_fancy_upsample
        left = np.concatenate([x[:, :1], x[:, :-1]], 1)
        right = np.concatenate([x[:, 1:], x[:, -1:]], 1)
        out = np.empty((h, 2 * w), np.int32)
        out[:, 0::2] = (3 * x + left + 1) >> 2
        out[:, 1::2] = (3 * x + right + 2) >> 2
        return out.astype(np.uint8)
    if (fx, fy) in ((1, 2), (2, 2)) and (fx == 1 or w > 2):
        above = np.concatenate([x[:1], x[:-1]], 0)
        below = np.concatenate([x[1:], x[-1:]], 0)
        if fx == 1:                                  # h1v2_fancy_upsample
            out = np.empty((2 * h, w), np.int32)
            out[0::2] = (3 * x + above + 1) >> 2
            out[1::2] = (3 * x + below + 2) >> 2
            return out.astype(np.uint8)
        out = np.empty((2 * h, 2 * w), np.int32)     # h2v2_fancy_upsample
        for r, near in ((0, above), (1, below)):
            col = 3 * x + near
            last = np.concatenate([col[:, :1], col[:, :-1]], 1)
            nxt = np.concatenate([col[:, 1:], col[:, -1:]], 1)
            out[r::2, 0::2] = (3 * col + last + 8) >> 4
            out[r::2, 1::2] = (3 * col + nxt + 7) >> 4
        return out.astype(np.uint8)
    return np.repeat(np.repeat(plane, fy, 0), fx, 1)  # int_upsample


def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert on uint8 planes -> (H, W, 3) uint8."""
    y = y.astype(np.int64)
    cb = cb.astype(np.int64) - 128
    cr = cr.astype(np.int64) - 128
    half = 1 << 15
    r = y + ((_fix(1.40200) * cr + half) >> 16)
    g = y + ((-_fix(0.34414) * cb + half - _fix(0.71414) * cr) >> 16)
    b = y + ((_fix(1.77200) * cb + half) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _exif_orientation(seg: bytes) -> int:
    """The orientation tag (0x0112) of IFD0 of an APP1 ``Exif`` body, 1
    when it is absent or unreadable."""
    tiff = seg[6:]
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    ifd = struct.unpack(e + "I", tiff[4:8])[0]
    if ifd + 2 > len(tiff):
        return 1
    n = struct.unpack(e + "H", tiff[ifd: ifd + 2])[0]
    for i in range(n):
        at = ifd + 2 + 12 * i
        if at + 12 > len(tiff):
            break
        tag, kind = struct.unpack(e + "HH", tiff[at: at + 4])
        if tag == 0x0112 and kind == 3:
            v = struct.unpack(e + "H", tiff[at + 8: at + 10])[0]
            return v if 1 <= v <= 8 else 1
    return 1


def orient(px: np.ndarray, orientation: int) -> np.ndarray:
    """EXIF orientation 1-8 applied as ``cv2.imread`` applies it
    (``ExifTransform``: a transpose for 5-8, then the flips)."""
    if orientation >= 5:
        px = px.transpose(1, 0, 2)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}
    for axis in flip.get(orientation, ()):
        px = np.flip(px, axis)
    return np.ascontiguousarray(px)


def decode(data: bytes) -> Decoded:
    """A JPEG file's bytes -> its samples (gray, or RGB after the colour
    conversion) and its EXIF orientation."""
    if not is_jpeg(data):
        raise ValueError("not a JPEG (no SOI marker)")
    quant: dict[int, np.ndarray] = {}
    tables: dict[tuple[int, int], list] = {}
    comps: list[_Component] = []
    coefs: list = []
    restart = 0
    orientation = 1
    jfif = False
    adobe = None
    frame = None
    pos = 2
    while True:
        if pos + 2 > len(data):
            raise ValueError("corrupt JPEG: it ends before its EOI marker")
        if data[pos] != 0xFF:
            raise ValueError("corrupt JPEG: no marker where one is due")
        marker = data[pos + 1]
        if marker == 0xFF:                    # fill byte
            pos += 1
            continue
        if marker == 0xD9:
            break
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        n = _u16(data, pos + 2)
        seg = data[pos + 4: pos + 2 + n]
        pos += 2 + n
        if marker in _REFUSED_SOF:
            raise JPEGUnsupported(_REFUSED_SOF[marker])
        if marker == 0xCC:
            raise JPEGUnsupported("an arithmetic-coded JPEG (DAC)")
        if marker in (0xC0, 0xC1):
            precision, h, w, nf = struct.unpack(">BHHB", seg[:6])
            if precision != 8:
                raise JPEGUnsupported(f"a {precision}-bit JPEG")
            if nf not in (1, 3):
                raise JPEGUnsupported(
                    f"a {nf}-component JPEG" + (" (CMYK or YCCK)"
                                                if nf == 4 else ""))
            if w == 0 or h == 0:
                raise JPEGUnsupported("a JPEG whose height is set by a "
                                      "DNL marker")
            for i in range(nf):
                cid, hv, tq = seg[6 + 3 * i: 9 + 3 * i]
                comps.append(_Component(cid, hv >> 4, hv & 15, tq))
            hmax = max(c.h for c in comps)
            vmax = max(c.v for c in comps)
            mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
            for c in comps:
                if hmax % c.h or vmax % c.v:
                    raise JPEGUnsupported(
                        f"a JPEG with sampling factors {c.h}x{c.v} of "
                        f"{hmax}x{vmax}")
                c.width = -(-w * c.h // hmax)
                c.height = -(-h * c.v // vmax)
                c.bw, c.bh = mx * c.h, my * c.v
                c.offset = len(coefs)
                coefs.extend([0] * (c.bw * c.bh * 64))
            frame = (w, h, hmax, vmax, mx, my)
        elif marker == 0xC4:                  # DHT
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = bytes(seg[i + 1: i + 17])
                m = sum(counts)
                tables[(tc, th)] = _lookup(counts, bytes(
                    seg[i + 17: i + 17 + m]), tc == 1)
                i += 17 + m
        elif marker == 0xDB:                  # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                width = 2 if pq else 1
                vals = np.frombuffer(seg[i + 1: i + 1 + 64 * width],
                                     ">u2" if pq else np.uint8)
                q = np.zeros(64, np.int64)
                q[_ZIGZAG[:64]] = vals
                quant[tq] = q.reshape(8, 8)
                i += 1 + 64 * width
        elif marker == 0xDD:                  # DRI
            restart = _u16(seg, 0)
        elif marker == 0xE0 and seg[:5] == b"JFIF\0":
            jfif = True
        elif marker == 0xE1 and seg[:6] == b"Exif\0\0" and orientation == 1:
            orientation = _exif_orientation(seg)
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif marker == 0xDA:                  # SOS
            if frame is None:
                raise ValueError("corrupt JPEG: a scan before the frame "
                                 "header")
            pos = _scan(data, pos, seg, frame, comps, tables, restart,
                        coefs)
    if frame is None:
        raise ValueError("corrupt JPEG: no frame")
    w, h, hmax, vmax, _, _ = frame
    planes = []
    for c in comps:
        if c.tq not in quant:
            raise ValueError(f"corrupt JPEG: no quantization table {c.tq}")
        block = np.array(coefs[c.offset: c.offset + c.bw * c.bh * 64],
                         np.int64).reshape(-1, 8, 8)
        px = idct_islow(block, quant[c.tq]).reshape(c.bh, c.bw, 8, 8)
        plane = px.transpose(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)
        plane = plane[:c.height, :c.width]
        planes.append(_upsample(plane, hmax // c.h, vmax // c.v)[:h, :w])
    if len(planes) == 1:
        return Decoded(planes[0][:, :, None], orientation)
    ids = tuple(c.cid for c in comps)
    rgb = (not jfif and (adobe == 0 if adobe is not None
                         else ids == (82, 71, 66)))
    out = (np.stack(planes, -1) if rgb
           else ycc_to_rgb(*planes))
    return Decoded(out, orientation)


def _scan(data: bytes, pos: int, seg: bytes, frame, comps, tables,
          restart: int, coefs: list) -> int:
    """Decode the scan whose SOS body is ``seg`` and whose entropy-coded
    data starts at ``pos``; returns the position of the marker after
    it."""
    w, h, hmax, vmax, mx, my = frame
    ns = seg[0]
    members = []
    for i in range(ns):
        cid, t = seg[1 + 2 * i: 3 + 2 * i]
        idx = [k for k, c in enumerate(comps) if c.cid == cid]
        if not idx:
            raise ValueError(f"corrupt JPEG: scan names component {cid}")
        for kind, th in ((0, t >> 4), (1, t & 15)):
            if (kind, th) in tables:
                continue
            if (kind, th) not in _STD_TABLES:
                raise ValueError(f"corrupt JPEG: no Huffman table "
                                 f"{'DA'[kind]}C{th}")
            tables[(kind, th)] = _lookup(*_STD_TABLES[(kind, th)], kind == 1)
        members.append((idx[0], tables[(0, t >> 4)], tables[(1, t & 15)]))
    ss, se, ahl = seg[1 + 2 * ns: 4 + 2 * ns]
    if (ss, se, ahl) != (0, 63, 0):
        raise JPEGUnsupported("a progressive JPEG (spectral selection or "
                              "successive approximation in a scan)")
    blocks = []
    if ns == 1:                               # non-interleaved: raster
        ci, dct, act = members[0]
        c = comps[ci]
        for by in range(-(-c.height // 8)):
            for bx in range(-(-c.width // 8)):
                blocks.append((c.offset + (by * c.bw + bx) * 64, dct, act,
                               ci, True))
    else:
        for my_ in range(my):
            for mx_ in range(mx):
                first = True
                for ci, dct, act in members:
                    c = comps[ci]
                    for by in range(c.v):
                        row = (my_ * c.v + by) * c.bw + mx_ * c.h
                        for bx in range(c.h):
                            blocks.append((c.offset + (row + bx) * 64, dct,
                                           act, ci, first))
                            first = False
    stream, segs, end = _unstuff(data, pos)
    _decode_scan(stream, segs, blocks, restart, coefs, len(comps))
    return end


def decode_jpeg(data: bytes) -> np.ndarray:
    """A JPEG file's bytes -> (H, W, 3) BGR uint8, as ``cv2.imdecode(buf,
    IMREAD_COLOR)`` (and ``cv2.imread``) gives it: EXIF orientation
    applied, gray repeated into three channels."""
    dec = decode(data)
    px = orient(dec.samples, dec.orientation)
    return np.repeat(px, 3, 2) if px.shape[2] == 1 else px[:, :, ::-1].copy()


# --- encoding ----------------------------------------------------------

# jcparam.c's base quantizers (Annex K), natural order
_STD_QUANT_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64).reshape(8, 8)
_STD_QUANT_CHROMA = np.full((8, 8), 99, np.int64)
_STD_QUANT_CHROMA[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66],
                             [24, 26, 56, 99], [47, 66, 99, 99]]


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """``jpeg_quality_scaling`` and ``jpeg_add_quant_table`` with
    force_baseline: the base table scaled by the quality, 1..255."""
    quality = min(max(quality, 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def rgb_to_ycc(rgb: np.ndarray) -> np.ndarray:
    """jccolor.c's rgb_ycc_convert: (..., 3) uint8 RGB -> (..., 3) uint8
    YCbCr, 16-bit fixed point; Cb and Cr take ONE_HALF - 1 as their
    rounding term, so they never reach 256."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, offset = 1 << 15, 128 << 16
    y = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b
         + half) >> 16
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b + offset
          + half - 1) >> 16
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b + offset
          + half - 1) >> 16
    return np.stack([y, cb, cr], -1).astype(np.uint8)


def _pad_edges(plane: np.ndarray, h: int, w: int) -> np.ndarray:
    """``plane`` grown to (h, w) by repeating its last row and column."""
    ph, pw = plane.shape
    return np.pad(plane, ((0, h - ph), (0, w - pw)), mode="edge")


def downsample_h2v2(plane: np.ndarray) -> np.ndarray:
    """jcsample.c's h2v2_downsample of a plane of even size: each 2x2 sum
    plus a bias of 1, 2, 1, 2, ... along the row, shifted by 2."""
    x = plane.astype(np.int32)
    s = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
    bias = np.tile(np.array([1, 2], np.int32), s.shape[1] // 2 + 1)
    return ((s + bias[:s.shape[1]]) >> 2).astype(np.uint8)


def _fdct_1d(x: list, pass1: bool) -> list:
    """One pass of jfdctint.c's islow forward DCT over ``x[0..7]`` (int64
    arrays): pass 1 leaves the output scaled up by 2^PASS1_BITS, pass 2
    takes that scale out again."""
    c = _C
    tmp0, tmp7 = x[0] + x[7], x[0] - x[7]
    tmp1, tmp6 = x[1] + x[6], x[1] - x[6]
    tmp2, tmp5 = x[2] + x[5], x[2] - x[5]
    tmp3, tmp4 = x[3] + x[4], x[3] - x[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    shift = 13 - 2 if pass1 else 13 + 2

    def descale(v, n):
        return (v + (1 << (n - 1))) >> n

    out = [None] * 8
    if pass1:
        out[0] = (tmp10 + tmp11) << 2
        out[4] = (tmp10 - tmp11) << 2
    else:
        out[0] = descale(tmp10 + tmp11, 2)
        out[4] = descale(tmp10 - tmp11, 2)
    z1 = (tmp12 + tmp13) * c["f0541"]
    out[2] = descale(z1 + tmp13 * c["f0765"], shift)
    out[6] = descale(z1 - tmp12 * c["f1847"], shift)
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * c["f1175"]
    tmp4 = tmp4 * c["f0298"]
    tmp5 = tmp5 * c["f2053"]
    tmp6 = tmp6 * c["f3072"]
    tmp7 = tmp7 * c["f1501"]
    z1 = z1 * -c["f0899"]
    z2 = z2 * -c["f2562"]
    z3 = z3 * -c["f1961"] + z5
    z4 = z4 * -c["f0390"] + z5
    out[7] = descale(tmp4 + z1 + z3, shift)
    out[5] = descale(tmp5 + z2 + z4, shift)
    out[3] = descale(tmp6 + z2 + z3, shift)
    out[1] = descale(tmp7 + z1 + z4, shift)
    return out


def fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """(N, 8, 8) uint8 samples -> (N, 8, 8) int64 DCT coefficients scaled
    by 8, as ``jpeg_fdct_islow`` on the level-shifted samples."""
    x = blocks.astype(np.int64) - 128
    rows = _fdct_1d([x[:, :, k] for k in range(8)], True)      # pass 1
    ws = np.stack(rows, axis=2)
    cols = _fdct_1d([ws[:, k, :] for k in range(8)], False)
    return np.stack(cols, axis=1)


def quantize(coefs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """jcdctmgr.c: each coefficient over its quantizer x 8, the magnitude
    rounded half up, the sign kept."""
    q = quant.astype(np.int64) * 8
    mag = (np.abs(coefs) + (q >> 1)) // q
    return np.where(coefs < 0, -mag, mag)


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(8 by, 8 bx) -> (by, bx, 8, 8)."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _code_table(counts: bytes, symbols: bytes) -> tuple[np.ndarray,
                                                         np.ndarray]:
    """jchuff.c's derived table: (code, length) per symbol 0-255."""
    code_of = np.zeros(256, np.int64)
    size_of = np.zeros(256, np.int64)
    code = k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            code_of[symbols[k]] = code
            size_of[symbols[k]] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, size_of


def _nbits(v: np.ndarray) -> np.ndarray:
    """The bit length of |v| (0 for 0)."""
    return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)


def _entropy_code(zz: np.ndarray, table: np.ndarray, comp: np.ndarray,
                  dc_tables, ac_tables) -> bytes:
    """Huffman-code blocks in scan order (jchuff.c's encode_one_block):
    ``zz`` (N, 64) quantized coefficients in zigzag order, ``table`` (N,)
    each block's table slot, ``comp`` (N,) its component (for the DC
    predictor). Returns the byte-stuffed scan, its last byte padded with
    1 bits."""
    n = zz.shape[0]
    dc = zz[:, 0]
    diff = np.empty(n, np.int64)
    for ci in np.unique(comp):
        at = np.flatnonzero(comp == ci)
        diff[at] = np.diff(dc[at], prepend=0)
    dc_code = np.stack([t[0] for t in dc_tables])
    dc_size = np.stack([t[1] for t in dc_tables])
    ac_code = np.stack([t[0] for t in ac_tables])
    ac_size = np.stack([t[1] for t in ac_tables])

    def value_bits(v, nb):
        return (v - (v < 0)) & ((1 << nb) - 1)

    # DC items: one per block, slot 0
    nb = _nbits(diff)
    keys = [np.arange(n, dtype=np.int64) * 256]
    vals = [(dc_code[table, nb] << nb) | value_bits(diff, nb)]
    lens = [dc_size[table, nb] + nb]
    # AC items: each nonzero at zigzag position k (slot 2k), after its runs
    # of 16 zeros (ZRL, slot 2k - 1); EOB (slot 255) when the block ends in
    # zeros
    blk, col = np.nonzero(zz[:, 1:])
    k = col + 1
    prev = np.concatenate([[0], k[:-1]])
    prev[np.concatenate([[True], blk[1:] != blk[:-1]])] = 0
    run = k - prev - 1
    v = zz[blk, k]
    nb = _nbits(v)
    t = table[blk]
    sym = ((run & 15) << 4) | nb
    keys.append(blk * 256 + 2 * k)
    vals.append((ac_code[t, sym] << nb) | value_bits(v, nb))
    lens.append(ac_size[t, sym] + nb)
    zrl = np.repeat(np.arange(len(blk)), run >> 4)
    keys.append(blk[zrl] * 256 + 2 * k[zrl] - 1)
    vals.append(ac_code[t[zrl], 0xF0])
    lens.append(ac_size[t[zrl], 0xF0])
    eob = np.flatnonzero(zz[:, 63] == 0)
    keys.append(eob * 256 + 255)
    vals.append(ac_code[table[eob], 0x00])
    lens.append(ac_size[table[eob], 0x00])
    order = np.argsort(np.concatenate(keys), kind="stable")
    vals = np.concatenate(vals)[order]
    lens = np.concatenate(lens)[order]
    # pad to a whole byte with 1 bits (jchuff.c's flush)
    total = int(lens.sum())
    pad = -total % 8
    vals = np.append(vals, (1 << pad) - 1)
    lens = np.append(lens, pad)
    # pack: each item (<= 27 bits) lands in the 5 bytes from its start
    # byte; items never share a bit, so summing the bytes ORs them
    ends = np.cumsum(lens)
    start = ends - lens
    byte0, off = start >> 3, start & 7
    window = vals << (40 - off - lens)
    nbytes = (total + pad) // 8
    out = np.zeros(nbytes + 5, np.int64)
    for j in range(5):
        out += np.bincount(byte0 + j, weights=(window >> (32 - 8 * j)) & 0xFF,
                           minlength=nbytes + 5).astype(np.int64)
    out = out[:nbytes].astype(np.uint8)
    ff = np.flatnonzero(out == 0xFF)
    return np.insert(out, ff + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _dht(cls_slot: int, table: tuple[bytes, bytes]) -> bytes:
    return _segment(0xC4, bytes([cls_slot]) + table[0] + table[1])


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """(H, W, 3) BGR or (H, W) gray uint8 -> the JPEG file that
    ``cv2.imencode(".jpg", img)`` writes at ``IMWRITE_JPEG_QUALITY``
    ``quality`` (95, OpenCV's default), through libjpeg-turbo with the rest
    of OpenCV's defaults."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if img.dtype != np.uint8 or not (img.ndim == 2 or (
            img.ndim == 3 and img.shape[2] == 3)) or 0 in img.shape:
        raise ValueError(f"encode_jpeg takes (H, W) or (H, W, 3) uint8, got "
                         f"{img.shape} {img.dtype}")
    h, w = img.shape[:2]
    if max(h, w) > 65535:
        raise ValueError(f"encode_jpeg: {w}x{h} is over JPEG's 65535 limit")
    luma_q = quant_table(_STD_QUANT_LUMA, quality)
    chroma_q = quant_table(_STD_QUANT_CHROMA, quality)
    zz = _ZIGZAG[:64]
    gray = img.ndim == 2
    if gray:
        # one component, 1x1: a non-interleaved scan of whole blocks
        bh, bw = -(-h // 8), -(-w // 8)
        blocks = _blocks(_pad_edges(img, 8 * bh, 8 * bw)).reshape(-1, 8, 8)
        q = quantize(fdct_islow(blocks), luma_q).reshape(-1, 64)[:, zz]
        scan = _entropy_code(q, np.zeros(len(q), np.int64),
                             np.zeros(len(q), np.int64),
                             [_code_table(*STD_DC_LUMA)],
                             [_code_table(*STD_AC_LUMA)])
        comps = [(1, 0x11, 0)]
    else:
        ycc = rgb_to_ycc(img[:, :, ::-1])
        mx, my = -(-w // 16), -(-h // 16)          # MCUs
        # luma: whole blocks of the image (the last column and row
        # repeated); the blocks an MCU still lacks are dummies
        bw, bh = -(-w // 8), -(-h // 8)
        y = _pad_edges(ycc[:, :, 0], 8 * bh, 8 * bw)
        yq = quantize(fdct_islow(_blocks(y).reshape(-1, 8, 8)),
                      luma_q).reshape(bh, bw, 64)
        full = np.zeros((2 * my, 2 * mx, 64), np.int64)
        full[:bh, :bw] = yq
        if bw % 2:                       # right: the DC of the block left
            full[:bh, bw, 0] = yq[:, bw - 1, 0]
        if bh % 2:                       # bottom: the MCU's upper right DC
            full[bh, :, 0] = full[bh - 1, 1::2, 0].repeat(2)
        luma = full.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4)
        # chroma: rows to an even count, columns to 16 mx, downsampled,
        # then rows to 8 my
        chroma = []
        for c in (1, 2):
            plane = _pad_edges(ycc[:, :, c], h + h % 2, 16 * mx)
            plane = _pad_edges(downsample_h2v2(plane), 8 * my, 8 * mx)
            chroma.append(quantize(fdct_islow(_blocks(plane).reshape(-1, 8, 8)),
                                   chroma_q).reshape(my, mx, 1, 64))
        mcu = np.concatenate([luma.reshape(my, mx, 4, 64)] + chroma, axis=2)
        q = mcu.reshape(-1, 64)[:, zz]
        per_mcu = np.array([0, 0, 0, 0, 1, 2], np.int64)
        comp = np.tile(per_mcu, my * mx)
        scan = _entropy_code(q, np.minimum(comp, 1), comp,
                             [_code_table(*STD_DC_LUMA),
                              _code_table(*STD_DC_CHROMA)],
                             [_code_table(*STD_AC_LUMA),
                              _code_table(*STD_AC_CHROMA)])
        comps = [(1, 0x22, 0), (2, 0x11, 1), (3, 0x11, 1)]
    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01"
                                 b"\x00\x00")]
    for slot, table in enumerate((luma_q,) if gray else (luma_q, chroma_q)):
        out.append(_segment(0xDB, bytes([slot]) + bytes(
            table.reshape(-1)[zz].astype(np.uint8))))
    out.append(_segment(0xC0, struct.pack(">BHHB", 8, h, w, len(comps))
                        + b"".join(bytes(c) for c in comps)))
    out += [_dht(0x00, STD_DC_LUMA), _dht(0x10, STD_AC_LUMA)]
    if not gray:
        out += [_dht(0x01, STD_DC_CHROMA), _dht(0x11, STD_AC_CHROMA)]
    sos = bytes([len(comps)]) + b"".join(
        bytes([cid, 0x11 * slot]) for cid, _, slot in comps) + b"\x00\x3f\x00"
    out += [_segment(0xDA, sos), scan, b"\xff\xd9"]
    return b"".join(out)
