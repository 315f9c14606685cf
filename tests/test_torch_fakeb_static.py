"""The port's fakeB_static builder (``data/fakeb_static.py``) against the
JAX package's ``tools/make_fakeb_static.py`` on the CPU, on one converted
checkpoint, over a tree of a .png and a .jpg photo: the same files under
``fakeB_static/`` (a PNG for a .png photo, a JPEG for a .jpg one).

- With the photo's bicubic resize taken from OpenCV in both, the decoded
  pixels of every PNG are within one level of the JAX tool's (the nets'
  fp32 sums differ in order; the truncation to uint8 turns that into at
  most one level), and every JPEG within 40 dB (a one-level difference
  can move a block's quantized coefficients at quality 95).
- With each package's own resize, the outputs are within 30 dB of each
  other. The port inherits the gap of ``resize_bicubic`` to OpenCV's IPP
  ``INTER_CUBIC`` (up to 9 one-level bytes of a 512^2 resize,
  ``tests/test_torch_layers.py:IPP_CUBIC_GAP``), which the 9-block static
  net at random weights spreads to a few hundred pixels by up to a few
  levels. The test asserts that the resizes differ there, so a fix of the
  gap shows as a failure of this assertion too.

Drawing runs the full-width static net at 512^2 (the tool builds it at
its defaults), cartoon Photo2Cartoon at 256^2."""
import os
import sys

import numpy as np
import pytest
import torch

from animateportrait_tpu_torch.data import fakeb_static
from animateportrait_tpu_torch.utils.image import read_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(root, names):
    import cv2
    from torch_jpeg_fixtures import synthetic_photo
    os.makedirs(os.path.join(root, "Photo"))
    for i, (name, hw) in enumerate(names):
        img = synthetic_photo(512, seed=i)[:, :, ::-1]
        img = cv2.resize(img, hw[::-1], interpolation=cv2.INTER_AREA)
        cv2.imwrite(os.path.join(root, "Photo", name), img)
    return root


def _jax_tool():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import make_fakeb_static
    return make_fakeb_static


def _psnr(a, b):
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255 ** 2 / mse)


@pytest.mark.parametrize("style", ["drawing", "cartoon"])
def test_fakeb_static_matches_the_jax_tool(style, tmp_path, capsys,
                                           monkeypatch):
    import cv2

    from animateportrait_tpu_torch.utils import image

    names = [("p0.png", (120, 96)), ("p1.jpg", (80, 100))]
    roots = {k: _tree(str(tmp_path / k), names)
             for k in ("ours", "cv2_resize", "theirs")}
    net = fakeb_static.build_static_net(style, None, "cpu")
    assert "random init" in capsys.readouterr().err
    ckpt = str(tmp_path / "static.pth")
    sd = net.state_dict()
    torch.save(sd if style == "drawing" else {"genA2B": sd}, ckpt)

    argv = ["--static_ckpt", ckpt, "--style", style]
    written = fakeb_static.main(["--root", roots["ours"], *argv,
                                 "--device", "cpu"])
    _jax_tool().main(["--root", roots["theirs"], *argv])
    with monkeypatch.context() as m:
        m.setattr(image, "resize_bicubic", lambda img, hw: cv2.resize(
            img, hw[::-1], interpolation=cv2.INTER_CUBIC))
        fakeb_static.main(["--root", roots["cv2_resize"], *argv,
                           "--device", "cpu"])
    assert [os.path.basename(p) for p in written] == [n for n, _ in names]

    def read(k, name):
        path = os.path.join(roots[k], "fakeB_static", name)
        with open(path, "rb") as f:
            head = f.read(4)
        assert head[:2] == b"\xff\xd8" if name.endswith(".jpg") \
            else head == b"\x89PNG"
        return read_image(path)

    for name, hw in names:
        want = read("theirs", name)
        shared, own = read("cv2_resize", name), read("ours", name)
        assert shared.shape == own.shape == want.shape == hw + (3,)
        if name.endswith(".png"):
            d = np.abs(shared.astype(int) - want.astype(int))
            assert d.max() <= 1, (name, d.max(), np.count_nonzero(d))
        else:
            assert _psnr(shared, want) >= 40, _psnr(shared, want)
        assert _psnr(own, want) >= 30, _psnr(own, want)
        if style == "drawing":
            np.testing.assert_array_equal(own[..., 0], own[..., 2])
        # the inherited gap: OpenCV's and the port's resizes of this photo
        photo = read_image(os.path.join(roots["ours"], "Photo", name))
        size = fakeb_static.IN_SIZE[style]
        gap = np.abs(image.resize_bicubic(photo, (size, size)).astype(int)
                     - cv2.resize(photo, (size, size),
                                  interpolation=cv2.INTER_CUBIC))
        assert gap.max() <= 1
        if (own != shared).any():
            assert gap.any()


def test_fakeb_static_without_photos_and_unknown_style(tmp_path):
    os.makedirs(tmp_path / "Photo")
    with pytest.raises(SystemExit, match="no photos"):
        fakeb_static.make_fakeb_static(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="style"):
        fakeb_static.build_static_net("sketch", None, "cpu")
