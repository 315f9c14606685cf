"""The port's detection slice against the JAX package: masked NMS, the
ceil-mode max pool, PNet/RNet/ONet on the same weights (JAX random
variables carried over by ``io/from_jax.py``), the image pyramid, and the
whole MTCNN cascade on one photo with the seeded face-biased weights that
``utils/smoke.write_mtcnn_weights`` writes."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from animateportrait_tpu_torch.io import from_jax
from animateportrait_tpu_torch.models import mtcnn
from animateportrait_tpu_torch.ops import nms
from animateportrait_tpu.utils.smoke import random_variables
from torch_port_helpers import maxdiff, nchw

K = jax.random.key(0)
NETS_ATOL = 2e-5            # tests/test_mtcnn.py:66-163


def _boxes_with_ties(seed, n=96):
    """Boxes on a coarse grid (so many overlaps sit exactly at a
    threshold) with scores drawn from a few levels (so many tie)."""
    rng = np.random.default_rng(seed)
    xy = rng.integers(0, 12, (n, 2)) * 4.0
    wh = rng.integers(2, 7, (n, 2)) * 4.0 - 1.0
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    scores = rng.choice(np.float32([0.5, 0.75, 0.9, 0.99]), n)
    valid = rng.uniform(size=n) < 0.8
    return boxes, scores, valid


@pytest.mark.parametrize("mode", ["union", "min"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("thr", [0.3, 0.5, 0.7])
def test_masked_nms_keeps_what_jax_keeps(mode, seed, thr):
    from animateportrait_tpu.ops.nms import iou_matrix as jiou
    from animateportrait_tpu.ops.nms import masked_nms as jnms

    boxes, scores, valid = _boxes_with_ties(seed)
    ref = np.asarray(jnms(jnp.asarray(boxes), jnp.asarray(scores),
                          jnp.asarray(valid), thr, mode=mode))
    got = nms.masked_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                         torch.from_numpy(valid), thr, mode).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < valid.sum()
    np.testing.assert_array_equal(
        nms.iou_matrix(torch.from_numpy(boxes), mode).numpy(),
        np.asarray(jiou(jnp.asarray(boxes), mode)))


def test_topk_mask_orders_ties_as_jax():
    from animateportrait_tpu.ops.nms import topk_mask as jtopk

    _, scores, valid = _boxes_with_ties(3)
    for k in (8, 40, 96):
        ji, jv = jtopk(jnp.asarray(scores), jnp.asarray(valid), k)
        ti, tv = nms.topk_mask(torch.from_numpy(scores),
                               torch.from_numpy(valid), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("size,window,stride", [
    ((13, 17), 2, 2), ((11, 9), 3, 2), ((22, 22), 3, 2), ((5, 7), 2, 2)])
def test_ceil_mode_max_pool_matches_jax(size, window, stride):
    from animateportrait_tpu.nn import max_pool_ceil

    x = np.random.default_rng(0).standard_normal((2, *size, 3)).astype(
        np.float32)
    ref = np.asarray(max_pool_ceil(jnp.asarray(x), window, stride))
    got = torch.nn.MaxPool2d(window, stride, ceil_mode=True)(nchw(x))
    assert got.permute(0, 2, 3, 1).shape == ref.shape
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)


def _jax_nets():
    from animateportrait_tpu.models import mtcnn as jm

    z = lambda *s: jnp.zeros(s)  # noqa: E731
    return {
        "pnet": (jm.PNet(), random_variables(
            lambda: jm.PNet().init(K, z(1, 12, 12, 3)), seed=1),
            mtcnn.PNet, from_jax.pnet_state_dict, jm.load_pnet_params),
        "rnet": (jm.RNet(), random_variables(
            lambda: jm.RNet().init(K, z(1, 24, 24, 3)), seed=2),
            mtcnn.RNet, from_jax.rnet_state_dict, jm.load_rnet_params),
        "onet": (jm.ONet(), random_variables(
            lambda: jm.ONet().init(K, z(1, 48, 48, 3)), seed=3),
            mtcnn.ONet, from_jax.onet_state_dict, jm.load_onet_params),
    }


@pytest.mark.parametrize("name,shape", [("pnet", (2, 37, 41, 3)),
                                        ("rnet", (3, 24, 24, 3)),
                                        ("onet", (2, 48, 48, 3))])
def test_mtcnn_nets_match_jax(name, shape):
    jnet, v, cls, to_torch, _ = _jax_nets()[name]
    # PReLU slopes away from 0 so the negative branch counts
    v = jax.tree_util.tree_map_with_path(
        lambda p, a: (a + 0.25 if "alpha" in jax.tree_util.keystr(p) else a),
        v)
    tnet = cls().eval()     # ONet's dropout
    tnet.load_state_dict(to_torch(v))
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    refs = jnet.apply(v, jnp.asarray(x))
    with torch.no_grad():
        gots = tnet(nchw(x))
    for ref, got in zip(refs, gots):
        ref = np.asarray(ref)
        if got.dim() == 4:
            got = got.permute(0, 2, 3, 1)
        assert got.shape == ref.shape
        assert maxdiff(got.numpy(), ref) <= NETS_ATOL


@pytest.mark.parametrize("name", ["pnet", "rnet", "onet"])
def test_mtcnn_converter_round_trip(name, tmp_path):
    _, v, cls, to_torch, load_jax = _jax_nets()[name]
    sd = to_torch(v)
    cls().load_state_dict(sd, strict=True)
    # the reference format: a pickled {key: array} dict in an .npy
    path = str(tmp_path / f"{name}.npy")
    np.save(path, {k: t.numpy() for k, t in sd.items()}, allow_pickle=True)
    back = load_jax(path)
    flat_v = jax.tree_util.tree_flatten_with_path(v)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_v) == len(flat_b)
    for p, a in flat_v:
        np.testing.assert_array_equal(np.asarray(flat_b[p]), np.asarray(a))
    # ...and the port's own loader reads the same file
    loaded = getattr(mtcnn, f"load_{name}")(path)
    for k, t in sd.items():
        np.testing.assert_array_equal(loaded.state_dict()[k].numpy(),
                                      t.numpy())


@pytest.mark.parametrize("hw", [(200, 180), (37, 512), (20, 20), (1080, 720)])
def test_pyramid_scales_match_jax(hw):
    from animateportrait_tpu.models.mtcnn import pyramid_scales as jps

    assert mtcnn.pyramid_scales(*hw) == jps(*hw)


def test_pyramid_resize_matches_jax():
    img = np.random.default_rng(5).uniform(0, 255, (200, 180, 3)).astype(
        np.float32)
    for s in mtcnn.pyramid_scales(200, 180):
        shape = (int(np.ceil(200 * s)), int(np.ceil(180 * s)))
        ref = np.asarray(jax.image.resize(jnp.asarray(img), (*shape, 3),
                                          method="linear"))
        got = torch.nn.functional.interpolate(
            nchw(img[None]), size=shape, mode="bilinear",
            align_corners=False, antialias=True)
        # 0-255 scale; fp32 sums of up to ~30 taps in another order
        assert maxdiff(got[0].permute(1, 2, 0).numpy(), ref) <= 2e-3


def test_cascade_matches_jax(tmp_path):
    """The whole cascade, port against JAX, on the same biased random
    weights and a 200x180 photo: the same faces, boxes and five points
    within 1 px (rounding in _to_square may move an edge by a pixel)."""
    from animateportrait_tpu.models import mtcnn as jm
    from animateportrait_tpu_torch.utils.smoke import write_mtcnn_weights

    d = write_mtcnn_weights(str(tmp_path / "mtcnn"), seed=0)
    paths = [os.path.join(d, f"{n}.npy") for n in ("pnet", "rnet", "onet")]
    jdet = jm.MTCNNDetector(jm.load_pnet_params(paths[0]),
                            jm.load_rnet_params(paths[1]),
                            jm.load_onet_params(paths[2]))
    tdet = mtcnn.MTCNNDetector(mtcnn.load_pnet(paths[0]),
                               mtcnn.load_rnet(paths[1]),
                               mtcnn.load_onet(paths[2]), device="cpu")
    img = np.random.default_rng(6).uniform(0, 255, (200, 180, 3)).astype(
        np.float32)
    jb, jl = jdet(img)
    tb, tl = tdet(img)
    assert len(jb) > 0
    assert tb.shape == jb.shape and tl.shape == jl.shape == (len(jb), 10)
    assert maxdiff(tb[:, :4], jb[:, :4]) <= 1.0
    assert maxdiff(tl, jl) <= 1.0
    # scores: the crops' sampling coordinates differ by fp32 rounding
    # (grid_sample normalizes them), and the smoke weights' head gain of 100
    # magnifies that; measured 1.2e-5
    assert maxdiff(tb[:, 4], jb[:, 4]) <= 1e-4
