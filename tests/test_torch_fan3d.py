"""The port's FAN3D and ResNetDepth (``models/fan3d.py``) against the JAX
package's on the CPU, with the same seeded weights: torch's default init
with seeded BatchNorm statistics, read by the JAX package's own
``load_fan3d_params`` / ``load_depth_params`` and carried back into the
port by ``io/from_jax.py`` (a round trip that must return every tensor).
The bars are the JAX tests' own (``tests/test_fan3d.py``): heatmaps and
depth at atol 2e-4, ``decode_heatmaps`` at 1e-5, ``draw_gaussian_fa`` at
1e-6, ``fa_crop`` byte-equal to the JAX package's cv2 crop, and
``landmarks_from_box`` with x and y exact and z within 2e-3. Then a strict
load of face_alignment-layout checkpoints written as ``.pth.tar`` and as
a traced torchscript ``.zip``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from animateportrait_tpu_torch.io import from_jax, reference
from animateportrait_tpu_torch.models import fan3d
from torch_port_helpers import maxdiff, nchw

DEPTH_SMALL = (1, 1, 1, 1)


def _seeded_norms(net: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Seeded BatchNorm statistics and affines (a default init has
    mean 0, var 1, weight 1, bias 0, which would hide a swapped key)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(torch.randn(c, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(c, generator=g) + 0.5)
                m.weight.copy_(1 + torch.randn(c, generator=g) * 0.1)
                m.bias.copy_(torch.randn(c, generator=g) * 0.1)
    return net.eval()


def _numpy_sd(net):
    return {k: v.numpy() for k, v in net.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def _carried(make, sd_np, to_jax, to_torch):
    """(JAX variables read from ``sd_np``, a fresh port net loaded
    strictly from those variables through ``io/from_jax.py``), after
    checking that the round trip returns every tensor."""
    variables = to_jax(sd_np)
    back = to_torch(variables)
    net = make()
    net.load_state_dict(back, strict=True)
    for k, v in sd_np.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    return variables, net.eval()


def _fan_pair(num_modules, seed=0):
    from animateportrait_tpu.models.fan3d import load_fan3d_params

    torch.manual_seed(seed)
    src = _seeded_norms(fan3d.FAN3D(num_modules=num_modules), seed)
    return _carried(
        lambda: fan3d.FAN3D(num_modules=num_modules), _numpy_sd(src),
        lambda sd: load_fan3d_params(sd, num_modules=num_modules),
        lambda v: from_jax.fan3d_state_dict(v, num_modules=num_modules))


def _depth_pair(layers=DEPTH_SMALL, seed=1):
    from animateportrait_tpu.models.fan3d import load_depth_params

    torch.manual_seed(seed)
    src = _seeded_norms(fan3d.ResNetDepth(layers=layers), seed)
    return _carried(
        lambda: fan3d.ResNetDepth(layers=layers), _numpy_sd(src),
        lambda sd: load_depth_params(sd, layers=layers),
        lambda v: from_jax.depth_state_dict(v, layers=layers))


@pytest.mark.parametrize("num_modules", [1, 2])
def test_fan3d_heatmaps_match_jax(num_modules):
    from animateportrait_tpu.models.fan3d import FAN3D

    variables, net = _fan_pair(num_modules)
    x = np.random.default_rng(num_modules).uniform(
        0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = FAN3D(num_modules=num_modules).apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = net(nchw(x))
    assert len(got) == len(want) == num_modules
    for g, w in zip(got, want):
        w = np.transpose(np.asarray(w), (0, 3, 1, 2))
        assert g.shape == w.shape
        assert maxdiff(g.numpy(), w) <= 2e-4


def test_resnet_depth_matches_jax():
    from animateportrait_tpu.models.fan3d import ResNetDepth

    variables, net = _depth_pair()
    x = np.random.default_rng(3).uniform(0, 1, (1, 256, 256, 71)).astype(
        np.float32)
    want = np.asarray(ResNetDepth(layers=DEPTH_SMALL).apply(
        variables, jnp.asarray(x)))
    with torch.no_grad():
        got = net(nchw(x)).numpy()
    assert got.shape == want.shape == (1, 68)
    assert maxdiff(got, want) <= 2e-4


def test_decode_heatmaps_matches_jax():
    from animateportrait_tpu.models.fan3d import decode_heatmaps

    rng = np.random.default_rng(4)
    hm = rng.standard_normal((2, 64, 64, 68)).astype(np.float32)
    hm[0, 0, 5, 0] = hm[0, 63, 63, 1] = 50.0    # peaks on the border
    hm[1, 10, 10, 2] = hm[1, 20, 20, 2] = 50.0  # a tie: the first wins
    want = np.asarray(decode_heatmaps(jnp.asarray(hm)))
    got = fan3d.decode_heatmaps(nchw(hm)).numpy()
    assert maxdiff(got, want) <= 1e-5


def test_draw_gaussian_fa_matches_jax():
    from animateportrait_tpu.models.fan3d import draw_gaussian_fa

    pts = np.array([[128.0, 100.0], [3.2, 250.1], [0.5, 0.5],
                    [255.9, 2.0], [-10.0, -10.0], [300.0, 300.0],
                    [-3.0, 40.0], [70.0, 259.0]], np.float32)
    want = np.asarray(draw_gaussian_fa((256, 256), jnp.asarray(pts), 2))
    got = fan3d.draw_gaussian_fa((256, 256), torch.from_numpy(pts), 2)
    assert maxdiff(got.numpy(), want) <= 1e-6


def test_transform_and_center_scale_match_jax():
    from animateportrait_tpu.models import fan3d as jf

    for box in ((103.7, 88.2, 411.9, 430.0), (-20, 300, 280, 560)):
        c, s = fan3d.bbox_to_center_scale(box)
        jc, js = jf.bbox_to_center_scale(box)
        np.testing.assert_array_equal(c, jc)
        assert s == js
        for pt in ([1, 1], [256, 256], [33.25, 61.75], [-4.5, 70.0]):
            for res, inv in ((256, True), (64, True), (64, False)):
                np.testing.assert_array_equal(
                    fan3d.fa_transform(pt, c, s, res, inv),
                    jf.fa_transform(pt, jc, js, res, inv))


def test_fa_crop_matches_jax_cv2_crop():
    from animateportrait_tpu.models.fan3d import fa_crop

    img = np.random.default_rng(5).integers(0, 255, (512, 512, 3),
                                            dtype=np.uint8)
    # inside, across the top-left border, across the bottom-right, and a
    # small box whose crop is upscaled
    for box in ((100, 80, 400, 420), (-20, 300, 280, 560),
                (300, 310, 530, 540), (200, 200, 260, 270)):
        c, s = fan3d.bbox_to_center_scale(box)
        np.testing.assert_array_equal(fan3d.fa_crop(img, c, s),
                                      fa_crop(img, c, s))


def test_landmarks_from_box_match_jax():
    from animateportrait_tpu.models.fan3d import FaceAlignment3D

    fan_v, fan_net = _fan_pair(1, seed=2)
    dep_v, dep_net = _depth_pair(seed=3)
    jfa = FaceAlignment3D(fan_v, dep_v, num_modules=1,
                          depth_layers=DEPTH_SMALL)
    fa = fan3d.FaceAlignment3D(fan_net, dep_net, device="cpu")
    img = np.random.default_rng(6).integers(0, 255, (512, 512, 3),
                                            dtype=np.uint8)
    for box in ((120.0, 110.0, 390.0, 425.0), (-30.0, 200.0, 250.0, 530.0)):
        want = jfa.landmarks_from_box(img, box)
        got = fa.landmarks_from_box(img, box)
        np.testing.assert_array_equal(got[:, :2], want[:, :2])
        assert maxdiff(got[:, 2], want[:, 2]) <= 2e-3
        assert np.abs(got[:, 2]).max() > 0


def test_fan_checkpoints_load_strictly(tmp_path):
    """face_alignment-layout FAN and depth checkpoints, as a ``.pth.tar``
    state dict and as a torchscript ``.zip``, load strictly into fresh
    nets and give the same heatmaps and z; a checkpoint with a missing or
    an extra key is refused."""
    torch.manual_seed(7)
    src = _seeded_norms(fan3d.FAN3D(num_modules=1), 7)
    dep = _seeded_norms(fan3d.ResNetDepth(layers=DEPTH_SMALL), 8)
    x = torch.rand(1, 3, 64, 64)
    xd = torch.rand(1, 71, 256, 256)
    tar = str(tmp_path / "3DFAN4-7835d9f11d.pth.tar")
    torch.save(src.state_dict(), tar)
    zip_ = str(tmp_path / "3DFAN4-4a694010b9.zip")
    torch.jit.trace(src, x, strict=False).save(zip_)
    dtar = str(tmp_path / "depth-2a464da4ea.pth.tar")
    torch.save({"state_dict": dep.state_dict()}, dtar)
    with torch.no_grad():
        want, wantd = src(x)[-1], dep(xd)
        for path in (tar, zip_):
            net = fan3d.FAN3D(num_modules=1)
            reference.load_into(net, reference.load_fa_state_dict(path))
            torch.testing.assert_close(net.eval()(x)[-1], want, rtol=0,
                                       atol=0)
        net = fan3d.ResNetDepth(layers=DEPTH_SMALL)
        reference.load_into(net, reference.load_fa_state_dict(dtar))
        torch.testing.assert_close(net.eval()(xd), wantd, rtol=0, atol=0)
    sd = reference.load_fa_state_dict(tar)
    for broken in ({k: v for k, v in sd.items() if k != "l0.bias"},
                   dict(sd, extra=torch.zeros(1))):
        with pytest.raises(RuntimeError):
            reference.load_into(fan3d.FAN3D(num_modules=1), broken)


def test_find_fan_checkpoints_matches_jax(tmp_path):
    from animateportrait_tpu.models.fan3d import find_fan_checkpoints

    assert fan3d.find_fan_checkpoints(str(tmp_path)) == (None, None)
    sub = tmp_path / "face_alignment"
    sub.mkdir()
    (sub / "3DFAN4-7835d9f11d.pth.tar").write_bytes(b"x")
    (sub / "depth-2a464da4ea.pth.tar").write_bytes(b"x")
    assert fan3d.find_fan_checkpoints(str(tmp_path)) == \
        find_fan_checkpoints(str(tmp_path))
    (tmp_path / "myFAN4-weights.pth").write_bytes(b"x")
    got = fan3d.find_fan_checkpoints(str(tmp_path))
    assert got == find_fan_checkpoints(str(tmp_path))
    assert got[0].endswith("myFAN4-weights.pth")


def test_fan_landmark_hook_matches_jax():
    """The pipeline hook: MTCNN's first box on the aligned photo (a stub
    detector here), then landmarks_from_box; no face raises."""
    from animateportrait_tpu.models.fan3d import (
        FaceAlignment3D, make_fan_landmark_fn)

    fan_v, fan_net = _fan_pair(1, seed=9)
    seen = []

    class Det:
        def __call__(self, rgb):
            seen.append(rgb)
            return (np.array([[100.0, 90.0, 380.0, 400.0, 0.99],
                              [10.0, 10.0, 50.0, 50.0, 0.5]]),
                    np.zeros((2, 10)))

    img = np.random.default_rng(10).integers(0, 255, (512, 512, 3),
                                             dtype=np.uint8)
    got = fan3d.make_fan_landmark_fn(
        fan3d.FaceAlignment3D(fan_net, None, device="cpu"), Det())(img)
    want = make_fan_landmark_fn(FaceAlignment3D(fan_v, None, num_modules=1),
                                Det())(img)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (68, 3) and np.all(got[:, 2] == 0)
    assert seen[0].dtype == np.float32
    np.testing.assert_array_equal(seen[0], img[:, :, ::-1])

    class NoDet:
        def __call__(self, rgb):
            return np.zeros((0, 5)), np.zeros((0, 10))

    with pytest.raises(ValueError, match="no face"):
        fan3d.make_fan_landmark_fn(
            fan3d.FaceAlignment3D(fan_net, None, device="cpu"), NoDet())(img)
