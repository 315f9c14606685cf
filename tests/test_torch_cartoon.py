"""The port's cartoon style against the JAX package: the Photo2Cartoon
generator on the same weights (JAX random variables carried over by
``io/from_jax.py``) at ngf 8, its converter by a round trip, and a 2-frame
cartoon render of ``Module2Renderer(style="cartoon")`` (generator ngf 8
with 3 blocks and 3 output channels, FlowUnet nf 4 / 3 scales, MODNet at
its only width)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from animateportrait_tpu_torch.io import from_jax
from animateportrait_tpu_torch.models.photo2cartoon import (
    Photo2CartoonGenerator)
from animateportrait_tpu.utils.smoke import random_variables
from torch_port_helpers import maxdiff, nchw, nhwc, psnr

K = jax.random.key(0)
CS = 256


def _p2c_jax(size=32, seed=1):
    from animateportrait_tpu.models.photo2cartoon import (
        Photo2CartoonGenerator as JP)

    jm = JP(ngf=8)
    v = random_variables(lambda: jm.init(K, jnp.zeros((1, size, size, 3))),
                         seed=seed)
    # the IN/LN mixes away from their init values, so both halves count
    rng = np.random.default_rng(seed)
    v = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.2, 0.8, a.shape).astype(a.dtype)
                      if jax.tree_util.keystr(p).endswith("['rho']")
                      else a), v)
    return jm, v


def test_photo2cartoon_matches_jax():
    jm, v = _p2c_jax()
    tm = Photo2CartoonGenerator(ngf=8).eval()
    tm.load_state_dict(from_jax.photo2cartoon_state_dict(v))
    x = np.random.default_rng(2).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    out, cam, heat = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        tout, tcam, theat = tm(nchw(x))
    assert tout.shape == (2, 3, 32, 32) and theat.shape == (2, 1, 8, 8)
    # the JAX package's own bounds against the reference
    # (tests/test_photo2cartoon.py:261-264): long InstanceNorm chains
    assert maxdiff(nhwc(tout), out) <= 1e-3
    assert maxdiff(tcam, cam) <= 5e-4
    assert maxdiff(nhwc(theat), heat) <= 1e-3


def test_photo2cartoon_converter_round_trip():
    from animateportrait_tpu.models.photo2cartoon import (
        load_photo2cartoon_params)

    _, v = _p2c_jax(size=16, seed=3)
    sd = from_jax.photo2cartoon_state_dict(v)
    ref_shapes = {"DecodeBlock1.norm1.w_gamma": (1, 32),
                  "DecodeBlock1.norm1.norm.rho": (1, 32, 1, 1),
                  "UpBlock2.3.gamma": (1, 8, 1, 1), "gap_fc.weight": (1, 32)}
    for k, shape in ref_shapes.items():
        assert tuple(sd[k].shape) == shape, k
    Photo2CartoonGenerator(ngf=8).load_state_dict(sd, strict=True)
    back = load_photo2cartoon_params({k: t.numpy() for k, t in sd.items()})
    flat_v = jax.tree_util.tree_flatten_with_path(v)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_v) == len(flat_b)
    for path, a in flat_v:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(a),
                                      err_msg=jax.tree_util.keystr(path))


def _face(rng, jitter):
    from animateportrait_tpu.utils import assets

    std = assets.std_face_landmarks()[:, :2] * np.array([1, -1])
    lm = (std - std.mean(0)) / np.ptp(std[:, 0]) * 110 + 128
    return (lm + rng.uniform(-jitter, jitter, lm.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def cartoon_renderers():
    from animateportrait_tpu.models.flowunet import FlowUnet as JF
    from animateportrait_tpu.models.gan import TridentGeneratorFullIFW as JT
    from animateportrait_tpu.models.modnet import MODNet as JM
    from animateportrait_tpu.models.photo2cartoon import (
        Photo2CartoonGenerator as JP)
    from animateportrait_tpu.pipeline.render import (
        Module2Renderer as JR, RendererVariables)
    from animateportrait_tpu_torch.models.flowunet import FlowUnet
    from animateportrait_tpu_torch.models.gan import TridentGeneratorFullIFW
    from animateportrait_tpu_torch.models.modnet import MODNet
    from animateportrait_tpu_torch.pipeline.render import Module2Renderer

    z = lambda *s: jnp.zeros(s)  # noqa: E731
    gen_v = random_variables(lambda: JT(output_nc=3, ngf=8, n_blocks=3,
                                        div=3, disp=3).init(
        K, z(1, CS, CS, 3), z(1, CS, CS, 1), z(1, CS, CS, 1),
        z(1, CS, CS, 2), z(1, CS, CS, 2), z(1, CS, CS, 1)), seed=1)
    flow_v = random_variables(lambda: JF(nf=4, num_scale=3, max_nf=64).init(
        K, z(1, 224, 224, 136)), seed=2)
    mod_v = random_variables(lambda: JM().init(K, z(1, CS, CS, 3)), seed=3)
    _, p2c_v = _p2c_jax(size=CS, seed=4)
    jr = JR(RendererVariables(generator=gen_v, flowunet=flow_v,
                              modnet=mod_v, photo2cartoon=p2c_v),
            style="cartoon", ngf=8, n_blocks=3, div=3, disp=3,
            frame_batch=2, flowunet=JF(nf=4, num_scale=3, max_nf=64),
            cartoon_g=JP(ngf=8))

    gen = TridentGeneratorFullIFW(output_nc=3, ngf=8, n_blocks=3, div=3,
                                  disp=3)
    gen.load_state_dict(from_jax.trident_state_dict(gen_v, 3, 3, 3))
    flow = FlowUnet(nf=4, num_scale=3, max_nf=64)
    flow.load_state_dict(from_jax.flowunet_state_dict(flow_v, 3))
    mod = MODNet()
    mod.load_state_dict(from_jax.modnet_state_dict(mod_v))
    p2c = Photo2CartoonGenerator(ngf=8)
    p2c.load_state_dict(from_jax.photo2cartoon_state_dict(p2c_v))
    tr = Module2Renderer(gen, flow, mod, frame_batch=2, style="cartoon",
                         cartoon_g=p2c, device="cpu")
    return jr, tr


def test_cartoon_renderer_matches_jax(cartoon_renderers):
    jr, tr = cartoon_renderers
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:CS, 0:CS] / CS
    photo = np.stack([np.sin(6 * x + 1) * np.cos(4 * y), x - y,
                      np.cos(5 * x * y)], -1)
    photo = (0.8 * photo + 0.1 * rng.standard_normal(photo.shape)).clip(
        -1, 1).astype(np.float32)
    a68 = _face(rng, 0.0)
    tb68 = np.stack([_face(rng, 2.0) for _ in range(2)])
    ref = np.asarray(jr(photo, a68, tb68))
    with torch.no_grad():
        got = tr(photo, a68, tb68)
    assert got.shape == ref.shape == (2, CS, CS, 3)
    # the composed render chain's bound (tests/test_composed_parity.py)
    assert psnr(got, ref) >= 40.0


def test_renderer_needs_the_static_net_of_its_style():
    from animateportrait_tpu_torch.models.flowunet import FlowUnet
    from animateportrait_tpu_torch.models.gan import TridentGeneratorFullIFW
    from animateportrait_tpu_torch.models.modnet import MODNet
    from animateportrait_tpu_torch.pipeline.render import Module2Renderer

    nets = (TridentGeneratorFullIFW(output_nc=3, ngf=4, n_blocks=1),
            FlowUnet(nf=4, num_scale=3, max_nf=64), MODNet())
    with pytest.raises(ValueError, match="needs cartoon_g"):
        Module2Renderer(*nets, style="cartoon", device="cpu")
    with pytest.raises(ValueError, match="needs static_g"):
        Module2Renderer(*nets, device="cpu")
    with pytest.raises(ValueError, match="unknown style"):
        Module2Renderer(*nets, style="sketch", device="cpu")


# --- light=False: the full FC head ---------------------------------------


def _p2c_full_jax(size, ngf, seed):
    from animateportrait_tpu.models.photo2cartoon import (
        Photo2CartoonGenerator as JP)

    jm = JP(ngf=ngf, light=False)
    v = random_variables(lambda: jm.init(K, jnp.zeros((1, size, size, 3))),
                         seed=seed)
    return jm, v


@pytest.mark.parametrize("size,ngf", [(32, 4), (48, 4)])
def test_photo2cartoon_full_head_matches_jax(size, ngf):
    """``light=False`` on the same weights: ``fc0`` reads the bottleneck
    flattened in NCHW order. At these widths the map is not square in
    channels and space (16 channels over 8 x 8 or 12 x 12 cells), so
    a flatten in another order, or a transposed kernel, would show."""
    jm, v = _p2c_full_jax(size, ngf, seed=5)
    tm = Photo2CartoonGenerator(ngf=ngf, light=False, img_size=size).eval()
    tm.load_state_dict(from_jax.photo2cartoon_state_dict(v))
    c, hw = ngf * 4, (size // 4) ** 2
    assert c != hw and tm.FC[0].weight.shape == (c, c * hw)
    x = np.random.default_rng(6).uniform(-1, 1, (2, size, size, 3)).astype(
        np.float32)
    out, cam, heat = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        tout, tcam, theat = tm(nchw(x))
    assert maxdiff(nhwc(tout), out) <= 1e-3
    assert maxdiff(tcam, cam) <= 5e-4
    assert maxdiff(nhwc(theat), heat) <= 1e-3
    # the head reads the flattened map, not its mean: another map order
    # gives another style
    with torch.no_grad():
        sd = tm.state_dict()
        w = sd["FC.0.weight"].reshape(c, c, size // 4, size // 4)
        sd["FC.0.weight"] = w.permute(0, 2, 3, 1).reshape(c, c * hw)
        tm.load_state_dict(sd)
        wrong, _, _ = tm(nchw(x))
    assert maxdiff(nhwc(wrong), out) > 1e-2


def test_photo2cartoon_full_head_converter_round_trip():
    from animateportrait_tpu.models.photo2cartoon import (
        load_photo2cartoon_params)

    _, v = _p2c_full_jax(32, 4, seed=7)
    sd = from_jax.photo2cartoon_state_dict(v)
    assert tuple(sd["FC.0.weight"].shape) == (16, 16 * 8 * 8)
    Photo2CartoonGenerator(ngf=4, light=False, img_size=32).load_state_dict(
        sd, strict=True)
    back = load_photo2cartoon_params({k: t.numpy() for k, t in sd.items()})
    np.testing.assert_array_equal(np.asarray(back["params"]["fc0"]["kernel"]),
                                  np.asarray(v["params"]["fc0"]["kernel"]))
