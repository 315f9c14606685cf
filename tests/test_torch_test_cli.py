"""``test_cli`` (the reference's ``Module2/test.py`` surface) against the JAX
package's ``test_cli`` on ``tests/test_test_cli.py``'s driver layout: the
results trees' file names, the HTML byte for byte, the float visuals at
PSNR >= 40 dB on shared checkpoints (generator ngf 4, the frozen nets at
their own widths), the landmark drawings exact for ``--draw_op`` 0, 1 and
2 at crop 256 and 512, ``--aspect_ratio``, and the generator loaded
strictly at ``--netg_resb_disp 3``."""
import os

import numpy as np
import pytest
import torch

from animateportrait_tpu_torch import test_cli
from animateportrait_tpu_torch.utils.image import read_image
from test_test_cli import _make_driver_layout
from torch_port_helpers import psnr

cv2 = pytest.importorskip("cv2")

FLOAT_VISUALS = ("real_A", "fake_B", "fake_B_vis", "fg_mask", "fakeB_static",
                 "fake_B_fore", "fg_mask1")
DB = "hermione2_MTCNN"


def _save(net, path, seed):
    from animateportrait_tpu_torch.utils.smoke import init_random_

    init_random_(net, torch.Generator().manual_seed(seed))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(net.state_dict(), path)
    return net


def _checkpoints(cd, disp=1):
    """Seeded nets in the reference layout, which both CLIs load."""
    from animateportrait_tpu_torch.models.flowunet import FlowUnet
    from animateportrait_tpu_torch.models.gan import (
        ResnetStyle2Generator, TridentGeneratorFullIFW)
    from animateportrait_tpu_torch.models.modnet import MODNet

    _save(TridentGeneratorFullIFW(output_nc=1, ngf=4, div=3, disp=disp),
          os.path.join(cd, "formal/drawing/70_net_G_A.pth"), 1)
    _save(FlowUnet(), os.path.join(cd, "FlowReg_id_flow_faces",
                                   "best_net_netF.pth"), 2)
    _save(MODNet(), os.path.join(cd, "modnet_photographic_portrait_matting"
                                 ".ckpt"), 3)
    _save(ResnetStyle2Generator(), os.path.join(cd, "static", "drawing.pth"),
          4)


def _argv(cd, results, *extra):
    return (f"--dataroot {DB} --name formal/drawing --model geomcgt_ifw_test "
            f"--netG resnet_9blocks_rcatland32_full_ifw --netg_resb_div 3 "
            f"--netg_resb_disp 1 --output_nc 1 --ngf 4 --epoch 70 "
            f"--num_test 3 --serial_batches --imagefolder {DB} --frame_batch 2 "
            f"--checkpoints_dir {cd} --results_dir {results}").split() + list(
                extra)


def _tree(results):
    web = os.path.join(results, "formal/drawing", "test_70")
    return web, sorted(os.listdir(web)), sorted(os.listdir(os.path.join(web,
                                                                        DB)))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Both CLIs on the driver layout (3 frames of one photo, frame batch 2
    so the last batch is padded) with the same checkpoints."""
    from animateportrait_tpu import test_cli as jtest

    tmp = tmp_path_factory.mktemp("layout")
    _make_driver_layout(tmp, db=DB, n_frames=3)
    cd = str(tmp / "ckpt")
    _checkpoints(cd)
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        jtest.main(_argv(cd, str(tmp / "jax")))
        res = test_cli.main(_argv(cd, str(tmp / "port"), "--device", "cpu"))
    finally:
        os.chdir(cwd)
    return tmp, res


def test_results_tree_names_and_html(trees):
    tmp, res = trees
    jweb, jtop, jimgs = _tree(str(tmp / "jax"))
    tweb, ttop, timgs = _tree(str(tmp / "port"))
    assert ttop == jtop == [DB, f"index{DB}.html"]
    assert timgs == jimgs and len(timgs) == 3 * 9
    assert res.names == [f"ori->{i:05d}" for i in range(3)]
    assert res.index == os.path.join(tweb, f"index{DB}.html")
    with open(res.index, "rb") as a, open(os.path.join(
            jweb, f"index{DB}.html"), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("label", FLOAT_VISUALS)
def test_float_visuals_match_jax(trees, label):
    tmp, _ = trees
    jweb, _, _ = _tree(str(tmp / "jax"))
    tweb, _, _ = _tree(str(tmp / "port"))
    for i in range(3):
        fn = os.path.join(DB, f"ori->{i:05d}_{label}.png")
        got = read_image(os.path.join(tweb, fn))
        want = cv2.imread(os.path.join(jweb, fn))
        assert got.shape == want.shape == (256, 256, 3)
        assert psnr(got, want, peak=255.0) >= 40.0, fn


def test_landmark_drawings_of_the_full_run_are_exact(trees):
    tmp, _ = trees
    jweb, _, _ = _tree(str(tmp / "jax"))
    tweb, _, _ = _tree(str(tmp / "port"))
    for i in range(3):
        for label in ("real_A_lm", "target_B_lm"):
            fn = os.path.join(DB, f"ori->{i:05d}_{label}.png")
            np.testing.assert_array_equal(read_image(os.path.join(tweb, fn)),
                                          cv2.imread(os.path.join(jweb, fn)))


class _StubRenderer:
    """render_visuals with the renderer's keys and shapes, made from its
    inputs alone: both CLIs around the same numbers."""

    def render_visuals(self, photo, a68, tb68s):
        T, cs = tb68s.shape[0], photo.shape[0]
        ramp = np.linspace(-1, 1, cs, dtype=np.float32)
        shift = tb68s.mean(axis=(1, 2)).astype(np.float32)[:, None, None,
                                                            None] / cs
        one = np.clip(ramp[None, :, None, None] + shift, -1, 1) * np.ones(
            (T, cs, cs, 1), np.float32)
        rgb = np.broadcast_to(photo, (T,) + photo.shape).astype(np.float32)
        return {"fake_B": one, "fake_B_fore": -one, "fg_mask1": one ** 2,
                "fakeB_static": one * 0.5, "target_B_lm": one,
                "warp_motion": np.zeros((T, cs, cs, 2), np.float32),
                "iw_flow": np.zeros((T, cs, cs, 2), np.float32),
                "if_mask": np.ones((T, cs, cs, 1), np.float32),
                "real_A": rgb, "fg_mask": np.abs(one)}


def _stub_trees(tmp, monkeypatch, size, *extra):
    from animateportrait_tpu import test_cli as jtest

    monkeypatch.setattr(jtest, "build_renderer", lambda args: _StubRenderer())
    monkeypatch.setattr(test_cli, "build_renderer",
                        lambda args, device: _StubRenderer())
    _make_driver_layout(tmp, db=DB, n_frames=3)
    monkeypatch.chdir(tmp)
    cd = str(tmp / "ckpt")
    sizes = ["--load_size", str(size), "--crop_size", str(size)]
    jtest.main(_argv(cd, str(tmp / "jax"), *sizes, *extra))
    test_cli.main(_argv(cd, str(tmp / "port"), "--device", "cpu", *sizes,
                        *extra))
    jweb, jtop, jimgs = _tree(str(tmp / "jax"))
    tweb, ttop, timgs = _tree(str(tmp / "port"))
    assert (ttop, timgs) == (jtop, jimgs)
    return jweb, tweb, timgs


@pytest.mark.parametrize("size", [256, 512])
@pytest.mark.parametrize("op", [0, 1, 2])
def test_landmark_drawings_exact(tmp_path, monkeypatch, op, size):
    """real_A_lm and target_B_lm through both CLIs at --draw_op op: cv2
    circles (radius 3, or 5 at 512), cv2 lines (thickness 2, or 4) and PIL
    polygons, pixel for pixel; every other visual too (the same stub
    numbers through tensor2im, the overlay and the PNG writers)."""
    jweb, tweb, imgs = _stub_trees(tmp_path, monkeypatch, size, "--draw_op",
                                   str(op))
    for fn in imgs:
        got = read_image(os.path.join(tweb, DB, fn))
        want = cv2.imread(os.path.join(jweb, DB, fn))
        assert got.shape == want.shape == (size, size, 3)
        np.testing.assert_array_equal(got, want, err_msg=fn)
    lm = read_image(os.path.join(tweb, DB, "ori->00002_target_B_lm.png"))
    colours = len(np.unique(lm.reshape(-1, 3), axis=0))
    assert colours == 2 if op < 2 else colours > 3


@pytest.mark.parametrize("ratio", [1.5, 0.75])
def test_aspect_ratio(tmp_path, monkeypatch, ratio):
    jweb, tweb, imgs = _stub_trees(tmp_path, monkeypatch, 256,
                                   "--aspect_ratio", str(ratio))
    shape = (256, 384, 3) if ratio > 1 else (341, 256, 3)
    for fn in imgs:
        got = read_image(os.path.join(tweb, DB, fn))
        np.testing.assert_array_equal(
            got, cv2.imread(os.path.join(jweb, DB, fn)), err_msg=fn)
        assert got.shape == shape


def test_disp3_generator_loads_strictly(tmp_path, capsys):
    """The reference command's generator (--netg_resb_disp 3) loads at the
    disp it is built with. The JAX test_cli loads it at its loader's
    default disp, 1, and fails on such a checkpoint."""
    from animateportrait_tpu.models.gan import load_trident_full_ifw_params
    from animateportrait_tpu_torch.models.gan import TridentGeneratorFullIFW

    cd = str(tmp_path / "ckpt")
    want = _save(TridentGeneratorFullIFW(output_nc=1, ngf=4, div=3, disp=3),
                 os.path.join(cd, "formal/drawing/70_net_G_A.pth"), 9)
    args = test_cli.build_test_argparser().parse_args(
        _argv(cd, str(tmp_path), "--netg_resb_disp", "3"))
    r = test_cli.build_renderer(args, torch.device("cpu"))
    assert "no checkpoint for generator" not in capsys.readouterr().err
    got = r.g.state_dict()
    assert set(got) == set(want.state_dict())
    for k, t in want.state_dict().items():
        np.testing.assert_array_equal(got[k].numpy(), t.numpy(), err_msg=k)
    sd = {k: t.numpy() for k, t in want.state_dict().items()}
    with pytest.raises(Exception):
        load_trident_full_ifw_params(sd)            # the JAX loader, disp 1
    load_trident_full_ifw_params(sd, 9, 3, 3)
    # built at another disp, the strict load refuses the checkpoint
    args.netg_resb_disp = 1
    with pytest.raises(RuntimeError, match="state_dict"):
        test_cli.build_renderer(args, torch.device("cpu"))


def test_helpers_match_jax(tmp_path, monkeypatch):
    from animateportrait_tpu import test_cli as jtest

    x = np.random.default_rng(0).uniform(-1.2, 1.2, (5, 6, 1)).astype(
        np.float32)
    np.testing.assert_array_equal(test_cli.tensor2im(x), jtest._tensor2im(x))
    np.testing.assert_array_equal(test_cli.tensor2im(x[None]),
                                  jtest._tensor2im(x[None]))
    for p in ("/d/Data/Photo/db/ori.png", "/d/Data/Alm/MTCNN/db/00001.png",
              "/d/Drawing/db/00002.jpg"):
        assert test_cli.lm_txt_for(p) == jtest._lm_txt_for(p)
    # lists from the {phase}A|B directories when the driver's lists are
    # not there
    for sub in ("testA", "testB/x"):
        os.makedirs(tmp_path / "db" / sub)
    for name in ("testA/b.png", "testA/a.JPG", "testA/c.txt", "testB/x/1.png",
                 "testB/0.jpeg"):
        (tmp_path / "db" / name).write_bytes(b"")
    monkeypatch.chdir(tmp_path)
    got = test_cli.resolve_lists(str(tmp_path / "db"), "test", float("inf"))
    assert got == jtest.resolve_lists(str(tmp_path / "db"), "test",
                                      float("inf"))
    assert [len(v) for v in got] == [2, 2]
    assert test_cli.resolve_lists(str(tmp_path / "db"), "test", 1) == (
        got[0][:1], got[1][:1])
    txt = tmp_path / "lm.txt"
    txt.write_text("1.5 2.25 0\n3 4 0\n")
    np.testing.assert_array_equal(test_cli.read_lm(str(txt)),
                                  jtest._read_lm(str(txt)))


def test_refuses_what_it_does_not_run(tmp_path, monkeypatch):
    argv = _argv(str(tmp_path / "ckpt"), str(tmp_path))
    with pytest.raises(SystemExit, match="only resize_and_crop"):
        test_cli.main(argv + ["--preprocess", "scale_width", "--device",
                              "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            test_cli.main(argv)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="no test images"):
        test_cli.main(argv + ["--device", "cpu"])


# --- the drawing primitives, against OpenCV and PIL directly ---------------


@pytest.mark.parametrize("thickness", [2, 3, 4, 5])
def test_thick_lines_match_opencv(thickness):
    """cv2.line at thickness >= 2, ends inside and outside the image."""
    from animateportrait_tpu_torch.utils.image import draw_thick_line

    rng = np.random.default_rng(thickness)
    for _ in range(300):
        p0, p1 = (tuple(int(v) for v in rng.integers(-30, 94, 2))
                  for _ in range(2))
        want = np.zeros((64, 64), np.uint8)
        cv2.line(want, p0, p1, 255, thickness)
        got = np.zeros((64, 64), np.uint8)
        draw_thick_line(got, p0, p1, thickness)
        np.testing.assert_array_equal(got, want, err_msg=f"{p0} {p1}")


def test_filled_discs_match_opencv():
    from animateportrait_tpu_torch.utils.image import _fill_disc

    for radius in range(0, 9):
        for centre in ((10, 10), (0, 0), (19, 19), (10, 21), (-2, 5)):
            want = np.zeros((20, 20), np.uint8)
            cv2.circle(want, centre, radius, 255, -1)
            got = np.zeros((20, 20), np.uint8)
            _fill_disc(got, *centre, radius)
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{radius} {centre}")


def _polygon(rng, t):
    """Random vertices (self-intersecting, horizontal runs, points off the
    image), or a path that goes out and back along itself (a closed
    mouth's inner loop), or vertices drawn from a few points (repeats)."""
    def pt():
        return tuple(int(v) for v in rng.integers(-3, 27, 2))
    path = [pt() for _ in range(int(rng.integers(2, 5)))]
    if t % 4 == 0:
        return path + path[-2:0:-1]
    if t % 4 == 1:
        return path + [pt()] + path[-1:0:-1]
    if t % 4 == 2:
        return [path[int(i)] for i in rng.integers(0, len(path),
                                                   int(rng.integers(3, 9)))]
    return [pt() for _ in range(int(rng.integers(3, 8)))]


def test_polygons_match_pil():
    """ImageDraw.polygon with a fill and a black outline."""
    from PIL import Image, ImageDraw

    from animateportrait_tpu_torch.utils.image import (
        _pil_fill_polygon, _pil_line)

    rng = np.random.default_rng(0)
    for t in range(800):
        pts = _polygon(rng, t)
        img = Image.new("RGB", (24, 24), (255, 255, 255))
        ImageDraw.Draw(img).polygon(pts, fill="pink", outline="black")
        got = np.full((24, 24, 3), 255, np.uint8)
        _pil_fill_polygon(got, pts, (255, 192, 203))
        for (x0, y0), (x1, y1) in zip(pts, pts[1:] + pts[:1]):
            _pil_line(got, x0, y0, x1, y1, (0, 0, 0))
        np.testing.assert_array_equal(got, np.asarray(img), err_msg=str(pts))


@pytest.mark.parametrize("size", [256, 512])
def test_drawings_match_jax_on_faces(size):
    """draw_landmarks ops 0, 1 and 2 against the JAX package's (cv2 and
    PIL) on face-shaped landmarks, mouths open and closed (the inner loop
    then goes out and back along itself), some points off the image."""
    from animateportrait_tpu.pipeline.render import draw_landmarks as jdraw
    from animateportrait_tpu_torch.utils.assets import std_face_landmarks
    from animateportrait_tpu_torch.utils.image import draw_landmarks

    rng = np.random.default_rng(size)
    std = std_face_landmarks()[:, :2]
    std = (std - std.mean(0)) / np.abs(std - std.mean(0)).max()
    radius, thickness = (5, 4) if size == 512 else (3, 2)
    for t in range(12):
        scale = size * rng.uniform(0.2, 0.55)
        lm = (size / 2 + rng.normal(0, size * 0.08, 2)
              + std * scale * np.array([1, -1])
              + rng.normal(0, [0.3, 1, 3][t % 3], (68, 2)))
        if t % 2:
            for up, lo in ((61, 67), (62, 66), (63, 65)):
                lm[up] = lm[lo] = (lm[up] + lm[lo]) / 2
        for op in (0, 1, 2):
            np.testing.assert_array_equal(
                draw_landmarks(size, size, lm, radius, thickness, op),
                jdraw(size, size, lm, radius, thickness, op),
                err_msg=f"face {t} op {op}")
