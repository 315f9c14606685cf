"""The port's host image readers against PIL and OpenCV, byte for byte, on
files that PIL and OpenCV write in the test from seeded numpy:

- the baseline JPEG decoder (``utils/jpeg.py``) through ``read_image``
  (``cv2.imread``: BGR, EXIF orientation applied) and ``load_image``
  (``PIL.Image.open(path).convert("RGB" | "L")``: no rotation), over
  qualities, chroma subsampling, sizes, optimized Huffman tables, restart
  intervals, greyscale and the eight EXIF orientations in both byte
  orders; progressive and arithmetic-coded files refused by name;
- the PNG kinds added beside 8-bit gray/RGB/RGBA: palette, gray + alpha,
  16-bit, sub-byte gray and Adam7 interlace, each with each reader's
  semantics;
- ``resize_linear`` against ``cv2.resize(INTER_LINEAR)``, up and down."""
import io
import os
import struct
import zlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

from animateportrait_tpu_torch.utils import image, jpeg  # noqa: E402


def _photo(h, w, seed=0):
    """A smooth colour ramp with seeded noise, like a photo's statistics."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    a = np.stack([90 + 120 * x, 70 + 100 * y, 110 + 60 * np.sin(6 * x * y)],
                 -1) + rng.normal(0, 12, (h, w, 3))
    return np.clip(a, 0, 255).astype(np.uint8)


def _both_readers(path):
    np.testing.assert_array_equal(image.read_image(path), cv2.imread(path))
    for gray in (False, True):
        want = np.asarray(Image.open(path).convert("L" if gray else "RGB"))
        np.testing.assert_array_equal(image.load_image(path, gray), want)
    assert image.image_size(path) == Image.open(path).size


# --- JPEG --------------------------------------------------------------


@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_jpeg_matches_pil_and_opencv(tmp_path, quality, subsampling):
    for h, w in ((1, 1), (7, 13), (61, 77), (255, 257)):
        path = str(tmp_path / f"p{h}x{w}.jpg")
        Image.fromarray(_photo(h, w, quality + h)).save(
            path, quality=quality, subsampling=subsampling)
        _both_readers(path)


@pytest.mark.parametrize("sampling", ["440", "411", "422", "420"])
def test_jpeg_opencv_sampling_and_restart_intervals(tmp_path, sampling):
    """cv2's writer, its sampling factors (4:4:0 is h1v2 luma) and restart
    intervals of 1 and 3 MCUs."""
    factor = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")
    for h, w in ((61, 77), (40, 33)):
        for rst in (1, 3):
            path = str(tmp_path / f"c{h}_{rst}.jpg")
            assert cv2.imwrite(path, _photo(h, w, rst)[:, :, ::-1], [
                cv2.IMWRITE_JPEG_QUALITY, 90,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor,
                cv2.IMWRITE_JPEG_RST_INTERVAL, rst])
            with open(path, "rb") as f:
                assert b"\xff\xdd" in f.read()       # a DRI segment
            _both_readers(path)


@pytest.mark.parametrize("size", [(7, 13), (61, 77), (255, 257)])
def test_jpeg_optimized_tables_and_greyscale(tmp_path, size):
    a = _photo(*size, seed=size[0])
    for i, (img, kw) in enumerate((
            (a, dict(quality=90, optimize=True)),
            (a[:, :, 1], dict(quality=90)),
            (a[:, :, 2], dict(quality=60, optimize=True)))):
        path = str(tmp_path / f"o{i}.jpg")
        Image.fromarray(img).save(path, **kw)
        _both_readers(path)


def _exif(orientation, big_endian):
    """An APP1 Exif body with IFD0 holding one tag, the orientation."""
    e = ">" if big_endian else "<"
    tiff = ((b"MM" if big_endian else b"II") + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", 1)
            + struct.pack(e + "HHI", 0x0112, 3, 1)
            + struct.pack(e + "HH", orientation, 0) + struct.pack(e + "I", 0))
    return b"Exif\0\0" + tiff


@pytest.mark.parametrize("orientation", range(1, 9))
def test_jpeg_exif_orientation(tmp_path, orientation):
    """read_image rotates as cv2.imread does, load_image does not (PIL);
    both byte orders of the EXIF block."""
    a = _photo(61, 77, orientation)
    for big in (False, True):
        path = str(tmp_path / f"e{int(big)}.jpg")
        Image.fromarray(a).save(path, quality=90,
                                exif=_exif(orientation, big))
        got = image.read_image(path)
        np.testing.assert_array_equal(got, cv2.imread(path))
        assert got.shape[:2] == ((77, 61) if orientation >= 5 else (61, 77))
        np.testing.assert_array_equal(
            image.load_image(path), np.asarray(Image.open(path).convert(
                "RGB")))
        assert image.image_size(path) == (77, 61)


def test_jpeg_refuses_progressive_and_arithmetic_by_name(tmp_path):
    path = str(tmp_path / "prog.jpg")
    Image.fromarray(_photo(16, 16)).save(path, progressive=True)
    with pytest.raises(ValueError, match="prog.jpg is a progressive JPEG"):
        image.read_image(path)
    with open(path, "rb") as f:
        data = f.read()
    # the same file with its frame marked arithmetic-coded (SOF9)
    arith = data.replace(b"\xff\xc2", b"\xff\xc9", 1)
    path2 = str(tmp_path / "arith.jpg")
    with open(path2, "wb") as f:
        f.write(arith)
    with pytest.raises(ValueError, match="arithmetic-coded JPEG"):
        image.load_image(path2)
    with pytest.raises(jpeg.JPEGUnsupported, match="12-bit"):
        base = io.BytesIO()
        Image.fromarray(_photo(8, 8)).save(base, "JPEG")
        b = bytearray(base.getvalue())
        sof = b.index(b"\xff\xc0")
        b[sof + 4] = 12                       # sample precision
        jpeg.decode(bytes(b))


def test_jpeg_corrupt_stream_raises(tmp_path):
    path = str(tmp_path / "bad.jpg")
    with open(path, "wb") as f:
        f.write(b"\xff\xd8\xff\xe0" + bytes(64))
    with pytest.raises(ValueError, match="bad.jpg"):
        image.read_image(path)


def test_idct_matches_float_idct_within_one_level():
    """islow against the exact 2-D DCT-III, rounded: they differ by at most
    one level (the islow error bound in IEEE 1180 terms)."""
    rng = np.random.default_rng(0)
    coef = rng.integers(-60, 60, (50, 8, 8))
    coef[:, 0, 0] = rng.integers(-500, 500, 50)
    got = jpeg.idct_islow(coef, np.ones((8, 8), np.int64)).astype(int)
    k = np.arange(8)
    c = np.where(k == 0, np.sqrt(0.5), 1.0)
    basis = c[None, :] * np.cos((2 * k[:, None] + 1) * k[None, :] * np.pi
                                / 16) / 2          # (x, u)
    ref = np.einsum("xu,nuv,yv->nxy", basis, coef, basis) + 128
    assert np.abs(got - np.clip(np.rint(ref), 0, 255)).max() <= 1


# --- PNG kinds ------------------------------------------------------------


def test_png_palette_and_gray_alpha(tmp_path):
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (29, 35, 3)).astype(np.uint8)
    for i, colors in enumerate((200, 10, 2)):
        path = str(tmp_path / f"p{i}.png")     # 8-, 4- and 1-bit indices
        Image.fromarray(rgb).quantize(colors).save(path)
        _both_readers(path)
    path = str(tmp_path / "pt.png")             # with a tRNS chunk
    Image.fromarray(rgb).quantize(64).save(path, transparency=3)
    _both_readers(path)
    path = str(tmp_path / "la.png")
    Image.fromarray(rng.integers(0, 256, (29, 35, 2)).astype(np.uint8),
                    "LA").save(path)
    _both_readers(path)
    path = str(tmp_path / "b1.png")             # 1-bit gray
    Image.fromarray((rng.integers(0, 2, (29, 35)) * 255).astype(
        np.uint8)).convert("1").save(path)
    _both_readers(path)


def test_png_16_bit(tmp_path):
    """cv2 keeps the high byte; PIL does too for colour and gray + alpha,
    and clips 16-bit gray (its I;16 mode) at 255."""
    rng = np.random.default_rng(2)
    for i, shape in enumerate(((13, 9), (13, 9, 3), (13, 9, 4))):
        a = rng.integers(0, 65536, shape).astype(np.uint16)
        a.flat[:4] = (0, 100, 255, 256)
        path = str(tmp_path / f"s{i}.png")
        assert cv2.imwrite(path, a)
        _both_readers(path)


def _adam7_png(path, px, ctype, depth=8):
    """An Adam7-interlaced PNG of (H, W[, C]) samples, each pass's rows
    filtered with a filter that cycles through the five kinds."""
    h, w = px.shape[:2]
    ch = 1 if px.ndim == 2 else px.shape[2]
    raw = bytearray()
    for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8),
                           (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
                           (0, 1, 1, 2)):
        sub = px[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        if depth == 16:
            rows = sub.astype(">u2").view(np.uint8).reshape(sub.shape[0], -1)
        else:
            rows = sub.reshape(sub.shape[0], -1).astype(np.uint8)
        bpp = ch * depth // 8
        for y in range(rows.shape[0]):
            kind = (y + x0) % 5
            cur = rows[y].astype(np.int64)
            up = rows[y - 1].astype(np.int64) if y else np.zeros_like(cur)
            left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
            ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
            if kind == 4:
                pa, pb, pc = (np.abs(up - ul), np.abs(left - ul),
                              np.abs(left + up - 2 * ul))
                pred = np.where((pa <= pb) & (pa <= pc), left,
                                np.where(pb <= pc, up, ul))
            else:
                pred = [0 * cur, left, up, (left + up) // 2][kind]
            out = (cur - pred) & 0xFF
            raw += bytes([kind]) + out.astype(np.uint8).tobytes()

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
            ">IIBBBBB", w, h, depth, ctype, 0, 0, 1))
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("shape", [(1, 1), (5, 3), (23, 37)])
def test_png_adam7_interlace(tmp_path, shape):
    rng = np.random.default_rng(shape[0])
    for i, (ch, ctype, depth) in enumerate(((3, 2, 8), (1, 0, 8), (4, 6, 8),
                                            (3, 2, 16))):
        a = rng.integers(0, 1 << depth, shape + ((ch,) if ch > 1 else ()))
        path = str(tmp_path / f"i{i}.png")
        _adam7_png(path, a, ctype, depth)
        _both_readers(path)


# --- resize_linear --------------------------------------------------------


@pytest.mark.parametrize("src", [97, 131, 200, 256, 300, 410, 580, 640])
def test_resize_linear_matches_opencv(src):
    rng = np.random.default_rng(src)
    for shape in ((src, src, 3), (src, src - 23, 3), (src - 11, src)):
        a = rng.integers(0, 256, shape).astype(np.uint8)
        for out in ((256, 256), (13, 7)):
            np.testing.assert_array_equal(
                image.resize_linear(a, out),
                cv2.resize(a, out[::-1], interpolation=cv2.INTER_LINEAR))


# --- the committed fixtures of chip_smoke.py phase 11 --------------------


def test_committed_fixtures_decode_to_their_hashes():
    """Each reader's decode of the committed JPEG fixtures has the hash
    PIL and OpenCV give here, which ``jpeg_fixtures.json`` records for the
    card machine (where neither is installed)."""
    import json

    from animateportrait_tpu_torch.utils.assets import ASSET_DIR
    from torch_jpeg_fixtures import FIXTURES, HASHES, digest, \
        reference_digests

    with open(os.path.join(ASSET_DIR, HASHES)) as f:
        table = json.load(f)
    assert sorted(table) == sorted(FIXTURES)
    for name in FIXTURES:
        path = os.path.join(ASSET_DIR, name)
        assert reference_digests(path) == table[name]
        got = {"pil_rgb": digest(image.load_image(path)),
               "pil_l": digest(image.load_image(path, grayscale=True)),
               "cv2_bgr": digest(image.read_image(path))}
        assert got == {k: table[name][k] for k in got}, name


def test_committed_fixtures_encode_to_opencvs_hashes():
    """The quality-95 encoder on each fixture's cv2.imread image: the
    file cv2.imencode writes (its SHA-256 and length) and the round trip
    cv2.imread(cv2.imwrite(.)), as recorded for the card machine."""
    import hashlib
    import json

    from animateportrait_tpu_torch.utils.assets import ASSET_DIR
    from torch_jpeg_fixtures import FIXTURES, HASHES, digest

    with open(os.path.join(ASSET_DIR, HASHES)) as f:
        table = json.load(f)
    for name in FIXTURES:
        data = jpeg.encode_jpeg(image.read_image(os.path.join(ASSET_DIR,
                                                              name)))
        assert {"sha256": hashlib.sha256(data).hexdigest(),
                "size": len(data)} == table[name]["cv2_q95_file"], name
        assert digest(jpeg.decode_jpeg(data)) == table[name]["cv2_q95"]
