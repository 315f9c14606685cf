"""The port's training data layer against PIL, OpenCV and the JAX package,
on the CPU at small sizes (sources of 128^2 or less, load 72, crop 64):

- ``resize_bicubic_pil`` byte-equal to PIL's bicubic resize, gray and RGB,
  up and down;
- the PNG reader (the row loop and the wavefront, ``read_image``,
  ``load_image``, ``image_size``) byte-equal to OpenCV and PIL on files that
  ``write_png`` wrote with each of the five row filters, and on files PIL
  and OpenCV wrote;
- ``draw_dots`` equal to ``cv2.circle`` with centres at and past the
  borders;
- on a ``write_umlvd_tree`` tree, ``UMLVDIFWDataset.sample`` and ``batch``
  (threaded) against the JAX dataset for the same ``Generator`` seed, in
  every target branch: integer outputs and simplices exact, images exact
  after the layout transpose, landmarks within 1e-5 px; and the worker
  loader's batches against the JAX CLI's draws.
"""
import os

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from animateportrait_tpu.data import umlvd_ifw as jdata
from animateportrait_tpu_torch.data import umlvd_ifw as tdata
from animateportrait_tpu_torch.utils import image
from animateportrait_tpu_torch.utils.smoke import write_umlvd_tree

LM_ATOL = 1e-5          # px; both sides compute the same float32 steps


def _pil_resize(a, size):
    return np.asarray(Image.fromarray(a).resize(size, Image.BICUBIC))


@pytest.mark.parametrize("shape", [(128, 128, 3), (128, 96), (37, 53, 3),
                                   (72, 72)])
@pytest.mark.parametrize("size", [(72, 72), (64, 40), (200, 301), (16, 16),
                                  (128, 96)])
def test_resize_bicubic_pil_is_byte_exact(shape, size):
    rng = np.random.default_rng(sum(shape) + size[0])
    noise = rng.integers(0, 256, shape).astype(np.uint8)
    y, x = np.mgrid[0:shape[0], 0:shape[1]]
    smooth = (127 + 120 * np.sin(x / 5.0) * np.cos(y / 3.0)).astype(np.uint8)
    if len(shape) == 3:
        smooth = np.repeat(smooth[..., None], 3, 2)
    for a in (noise, smooth):
        got = image.resize_bicubic_pil(a, size)
        want = _pil_resize(a, size)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _inflated(path):
    with open(path, "rb") as f:
        return image._png_rows(path, f.read())


@pytest.mark.parametrize("png_filter", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("shape", [(61, 47, 3), (50, 33)])
def test_png_filters_read_back_exactly(tmp_path, png_filter, shape):
    a = np.random.default_rng(png_filter).integers(0, 256, shape).astype(
        np.uint8)
    path = image.write_png(str(tmp_path / "x.png"), a, png_filter=png_filter)
    kinds, lines = _inflated(path)
    assert set(kinds.tolist()) == {png_filter}
    bpp = lines.shape[2]
    for px in (image._unfilter_rows(kinds, lines), image._unfilter_wavefront(
            np.repeat(kinds[:, None], bpp, 1), lines)):
        np.testing.assert_array_equal(px.reshape(a.shape), a)
    np.testing.assert_array_equal(image.read_image(path), cv2.imread(path))
    for gray in (False, True):
        want = np.asarray(Image.open(path).convert("L" if gray else "RGB"))
        np.testing.assert_array_equal(image.load_image(path, gray), want)
    assert image.image_size(path) == Image.open(path).size


@pytest.mark.parametrize("writer", ["pil", "cv2"])
@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_reader_matches_on_pil_and_opencv_files(tmp_path, writer, mode):
    rng = np.random.default_rng(3)
    y, x = np.mgrid[0:90, 0:120]
    ch = {"L": 1, "RGB": 3, "RGBA": 4}[mode]
    a = np.stack([(127 + 100 * np.sin(x / (4.0 + c)) * np.cos(y / 6.0)
                   + rng.normal(0, 6, x.shape)) for c in range(ch)], -1)
    a = np.clip(a, 0, 255).astype(np.uint8)
    path = str(tmp_path / "x.png")
    if writer == "pil":
        Image.fromarray(a[..., 0] if ch == 1 else a, mode).save(path)
    else:
        cv2.imwrite(path, a[..., 0] if ch == 1 else (
            a[..., [2, 1, 0]] if ch == 3 else a[..., [2, 1, 0, 3]]))
    np.testing.assert_array_equal(image.read_image(path), cv2.imread(path))
    for gray in (False, True):
        want = np.asarray(Image.open(path).convert("L" if gray else "RGB"))
        np.testing.assert_array_equal(image.load_image(path, gray), want)


def test_files_of_one_size_decode_together(tmp_path):
    """Several PNGs of one size share one wavefront (their byte columns side
    by side); the result is each file's own."""
    rng = np.random.default_rng(4)
    paths, want = [], []
    for i, (shape, f) in enumerate([((40, 30, 3), 4), ((40, 30), 3),
                                    ((40, 30, 3), 1), ((20, 30), 4)]):
        a = rng.integers(0, 256, shape).astype(np.uint8)
        paths.append(image.write_png(str(tmp_path / f"{i}.png"), a,
                                     png_filter=f))
        want.append(a)
    pil = str(tmp_path / "pil.png")
    Image.fromarray(want[0]).save(pil)
    got = image.load_images(paths + [pil], [False, True, False, True, False])
    for g, a in zip(got, want + [want[0]]):
        np.testing.assert_array_equal(g, a)


def test_reader_refuses_jpeg_by_name(tmp_path):
    """A JPEG of a kind the decoder does not read (here progressive) is
    refused by name; its size reads, as PIL's ``.size`` does."""
    path = str(tmp_path / "photo.jpg")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(path,
                                                        progressive=True)
    for fn in (image.read_image, image.load_image):
        with pytest.raises(ValueError,
                           match="photo.jpg is a progressive JPEG"):
            fn(path)
    assert image.image_size(path) == Image.open(path).size


@pytest.mark.parametrize("crop_size", [64, 512])
def test_draw_dots_matches_opencv(crop_size):
    rng = np.random.default_rng(crop_size)
    lm = rng.uniform(-8, crop_size + 8, (68, 2))
    lm[:6] = [[0, 0], [crop_size - 1, crop_size - 1], [-3, 5],
              [crop_size + 2, 10], [2.5, 3.5], [-20, -20]]
    img = np.zeros((crop_size, crop_size), np.uint8)
    for x, y in np.round(lm).astype(int):
        cv2.circle(img, (int(x), int(y)), 5 if crop_size == 512 else 3, 255,
                   -1)
    want = (img[..., None].astype(np.float32) / 255.0) * 2 - 1
    np.testing.assert_array_equal(image.draw_dots(lm, crop_size), want)
    np.testing.assert_array_equal(
        image.draw_dots(lm, crop_size),
        jdata.draw_dots(lm.astype(np.float32), crop_size))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_umlvd_tree(str(tmp_path_factory.mktemp("umlvd")),
                            n_photos=3, n_styles=3, clips=1, frames=3,
                            size=96, seed=0, png_filter=4)


def _cfgs(root, **kw):
    kw = {"root": root, "output_nc": 1, "load_size": 72, "crop_size": 64,
          **kw}
    return jdata.DataConfig(**kw), tdata.DataConfig(**kw)


def _assert_item_equal(j: dict, t: dict):
    """The JAX item (NHWC images) against the port's (NCHW)."""
    assert set(j) == set(t)
    for k, a in j.items():
        a, b = np.asarray(a), np.asarray(t[k])
        if k.endswith("_68"):
            assert a.shape == b.shape and b.dtype == a.dtype, k
            np.testing.assert_allclose(b, a, atol=LM_ATOL, rtol=0,
                                       err_msg=k)
            continue
        if a.dtype == np.float32 and a.ndim >= 3 and a.shape[-1] in (1, 3) \
                and a.shape[-2] > 4:
            a = np.moveaxis(a, -1, -3)       # NHWC / HWC -> NCHW / CHW
        assert a.shape == b.shape and a.dtype == b.dtype, (k, a.shape,
                                                           b.shape)
        np.testing.assert_array_equal(b, a, err_msg=k)


@pytest.mark.parametrize("branch", [
    {}, {"select_target12_thre": 1.0}, {"select_noniden_thre": 0.0},
    {"no_flip": True}, {"input_nc": 1, "output_nc": 3},
    {"use_clips": False, "style_dir": "Drawing"}])
def test_sample_matches_jax(tree, branch):
    jc, tc = _cfgs(tree, **branch)
    jd, td = jdata.UMLVDIFWDataset(jc), tdata.UMLVDIFWDataset(tc)
    assert (jd.A_paths, jd.B_paths, jd.B12_paths) == (
        td.A_paths, td.B_paths, td.B12_paths)
    for index in range(4):
        j = jd.sample(index, np.random.default_rng(index))
        t = td.sample(index, np.random.default_rng(index))
        _assert_item_equal(j, t)
        assert t["tri_motion"].dtype == np.int32
        assert t["real_A"].shape == (tc.input_nc, 64, 64)


@pytest.mark.parametrize("num_threads", [0, 3])
def test_batch_matches_jax(tree, num_threads):
    jc, tc = _cfgs(tree)
    jrng, trng = np.random.default_rng(9), np.random.default_rng(9)
    j = jdata.UMLVDIFWDataset(jc).batch([0, 2, 1], jrng, num_threads)
    t = tdata.UMLVDIFWDataset(tc).batch([0, 2, 1], trng, num_threads)
    _assert_item_equal(j, t)
    assert jrng.integers(1 << 30) == trng.integers(1 << 30)


def test_worker_loader_matches_the_jax_cli_draws(tree):
    """Two worker processes, two batches: each is the JAX dataset's
    ``batch(indices, rng, num_threads > 1)`` after the indices the JAX
    ``train_cli`` draws from the same generator."""
    jc, tc = _cfgs(tree)
    jd = jdata.UMLVDIFWDataset(jc)
    rng = np.random.default_rng(0)
    want = []
    for _ in range(2):
        idx = rng.integers(0, len(jd), size=2)
        want.append(jd.batch(list(idx), rng, num_threads=2))
    it = iter(tdata.loader(tdata.UMLVDIFWDataset(tc), 2,
                           np.random.default_rng(0), num_workers=2,
                           pin_memory=False))
    try:
        for w in want:
            got = next(it)
            assert all(isinstance(v, torch.Tensor) for v in got.values())
            _assert_item_equal(w, {k: v.numpy() for k, v in got.items()})
    finally:
        it._shutdown_workers()


def test_a_failing_worker_stops_the_loader(tmp_path):
    root = write_umlvd_tree(str(tmp_path / "t"), n_photos=2, n_styles=2,
                            clips=1, frames=2, size=80, seed=1)
    os.remove(os.path.join(root, "Alm", "MTCNN", "a0.png"))
    os.remove(os.path.join(root, "Alm", "MTCNN", "a1.png"))
    _, tc = _cfgs(root)
    it = iter(tdata.loader(tdata.UMLVDIFWDataset(tc), 2,
                           np.random.default_rng(0), num_workers=1,
                           pin_memory=False))
    try:
        with pytest.raises(FileNotFoundError, match="a[01].png"):
            next(it)
    finally:
        it._shutdown_workers()


def test_stopping_the_worker_servers_leaves_no_process(tree):
    """The loader's forkserver and the resource tracker exit, and are
    reaped, in ``stop_worker_servers``, not after the calling process."""
    from multiprocessing import forkserver, resource_tracker

    _, tc = _cfgs(tree)
    it = iter(tdata.loader(tdata.UMLVDIFWDataset(tc), 2,
                           np.random.default_rng(0), num_workers=1,
                           pin_memory=False))
    try:
        next(it)
    finally:
        it._shutdown_workers()
    del it
    pids = [forkserver._forkserver._forkserver_pid,
            resource_tracker._resource_tracker._pid]
    assert all(pids)
    tdata.stop_worker_servers()
    assert [p for p in pids if os.path.exists(f"/proc/{p}")] == []
    assert forkserver._forkserver._forkserver_pid is None


def test_serial_batches_and_cap(tree):
    """``tests/test_dataset.py::test_dataset_serial_batches_and_cap`` on the
    port's dataset, and the same items as the JAX one's."""
    jc, tc = _cfgs(tree, serial_batches=True)
    ds = tdata.UMLVDIFWDataset(tc)
    assert ds.b_index(1, np.random.default_rng(0)) == 1
    assert ds.b_index(4, np.random.default_rng(99)) == 1      # 4 % 3
    rnd = tdata.UMLVDIFWDataset(_cfgs(tree)[1])
    assert len({rnd.b_index(0, np.random.default_rng(s))
                for s in range(16)}) > 1
    item = ds.sample(1, np.random.default_rng(0))
    assert item["real_B"].shape[0] == 1
    _assert_item_equal(jdata.UMLVDIFWDataset(jc).sample(
        1, np.random.default_rng(0)), item)

    capped = tdata.UMLVDIFWDataset(_cfgs(tree, max_dataset_size=2)[1])
    assert len(capped.A_paths) == 2 and len(capped.B_paths) == 2
    jcap = jdata.UMLVDIFWDataset(_cfgs(tree, max_dataset_size=2)[0])
    assert (capped.A_paths, capped.B_paths) == (jcap.A_paths, jcap.B_paths)


def test_tree_layout_and_landmarks(tree):
    """The synthetic tree holds every part of the reference layout, and its
    landmark sets are face-like (never collinear)."""
    for rel in ("Photo/a0.png", "Alm/MTCNN/a0.png", "Alm_txt/MTCNN/a0.txt",
                "Amask/lips/a0.png", "fakeB_static/a0.png", "Drawing/b2.png",
                "Blm/MTCNN/b2.png", "Blm_txt/MTCNN/b2.txt", "Bmask/eyes/b2.png",
                "Drawing/scanner_frag_0_MTCNN/f2.png",
                "Blm_txt/MTCNN/scanner_frag_0_MTCNN/f2_win.txt"):
        assert os.path.exists(os.path.join(tree, rel)), rel
    lm = np.loadtxt(os.path.join(tree, "Alm_txt/MTCNN/a1.txt"))
    assert lm.shape == (68, 2)
    centred = lm - lm.mean(0)
    assert np.linalg.svd(centred, compute_uv=False)[1] > 5.0
