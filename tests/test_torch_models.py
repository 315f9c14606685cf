"""The port's renderer nets against the JAX package on the same weights
(JAX random variables carried over by ``io/from_jax.py``) and inputs, at
small widths; and every weight converter checked by a round trip through
the JAX package's own loader back to the same variables."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from animateportrait_tpu_torch.io import from_jax
from animateportrait_tpu_torch.models.audio2landmark import (
    Audio2landmarkContent, Audio2landmarkPos)
from animateportrait_tpu_torch.models.autovc import AutoVCGenerator
from animateportrait_tpu_torch.models.flowunet import FlowUnet
from animateportrait_tpu_torch.models.gan import (
    ResnetStyle2Generator, TridentGeneratorFullIFW)
from animateportrait_tpu_torch.models.modnet import MODNet
from animateportrait_tpu.utils.smoke import random_variables
from torch_port_helpers import maxdiff, nchw, nhwc

K = jax.random.key(0)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _trident_jax(ngf=8, nb=3, size=64):
    from animateportrait_tpu.models.gan import TridentGeneratorFullIFW

    m = TridentGeneratorFullIFW(output_nc=1, ngf=ngf, n_blocks=nb, div=3,
                                disp=3)
    z = lambda c: jnp.zeros((1, size, size, c))  # noqa: E731
    return m, random_variables(lambda: m.init(K, z(3), z(1), z(1), z(2), z(2), z(1)))


def _trident_inputs(rng, B=2, size=64):
    photo = rng.uniform(-1, 1, (1, size, size, 3)).astype(np.float32)
    land1 = np.where(rng.uniform(size=(1, size, size, 1)) > 0.9, 1.0,
                     -1.0).astype(np.float32)
    land2 = np.where(rng.uniform(size=(B, size, size, 1)) > 0.9, 1.0,
                     -1.0).astype(np.float32)
    motion = rng.uniform(-1, 1, (B, size, size, 2)).astype(np.float32)
    flow = rng.uniform(-3, 3, (B, size, size, 2)).astype(np.float32)
    mask = rng.uniform(0, 1, (B, size, size, 1)).astype(np.float32)
    return photo, land1, land2, motion, flow, mask


def test_trident_encode_decode_matches_jax():
    from animateportrait_tpu.models.gan import TridentGeneratorFullIFW as JT

    jm, v = _trident_jax()
    tm = TridentGeneratorFullIFW(output_nc=1, ngf=8, n_blocks=3, div=3,
                                 disp=3)
    tm.load_state_dict(from_jax.trident_state_dict(v, n_blocks=3, div=3,
                                                   disp=3))
    photo, land1, land2, motion, flow, mask = _trident_inputs(_rng())
    cache = jm.apply(v, jnp.asarray(photo), jnp.asarray(land1),
                     method=JT.encode_static)
    ref = jm.apply(v, cache, jnp.asarray(land2), jnp.asarray(motion),
                   jnp.asarray(flow), jnp.asarray(mask), method=JT.decode)
    with torch.no_grad():
        tcache = tm.encode_static(nchw(photo), nchw(land1))
        for key in cache:
            assert maxdiff(nhwc(tcache[key]), cache[key]) <= 1e-4, key
        got = tm.decode(tcache, nchw(land2), torch.from_numpy(motion),
                        nchw(flow), nchw(mask))
        full = tm(nchw(photo).expand(2, -1, -1, -1),
                  nchw(land1).expand(2, -1, -1, -1), nchw(land2),
                  torch.from_numpy(motion), nchw(flow), nchw(mask))
    assert got.shape == (2, 1, 64, 64)
    assert maxdiff(nhwc(got), ref) <= 1e-4
    assert maxdiff(full, got) <= 1e-5


def test_style2_matches_jax():
    from animateportrait_tpu.models.gan import ResnetStyle2Generator as JS

    jm = JS(ngf=8, n_blocks=2)
    v = random_variables(lambda: jm.init(K, jnp.zeros((1, 64, 64, 3)),
                                 jnp.zeros((1, 16, 16, 3))))
    tm = ResnetStyle2Generator(ngf=8, n_blocks=2)
    tm.load_state_dict(from_jax.style2_state_dict(v, n_blocks=2))
    x = _rng(1).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    style = np.tile(np.float32([0, 1, 0]), (1, 16, 16, 1))
    ref = jm.apply(v, jnp.asarray(x), jnp.asarray(style))
    with torch.no_grad():
        got = tm(nchw(x), nchw(style))
    assert maxdiff(nhwc(got), ref) <= 1e-4


def _flowunet_jax():
    from animateportrait_tpu.models.flowunet import FlowUnet as JF

    jm = JF(nf=4, num_scale=3, max_nf=64)
    v = random_variables(lambda: jm.init(K, jnp.zeros((1, 32, 32, 6))))
    # non-trivial BatchNorm statistics so the test exercises them
    rng = _rng(2)
    v = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 2.0, a.shape).astype(a.dtype)
                      if "var" in str(p[-1]) else
                      rng.uniform(-0.3, 0.3, a.shape).astype(a.dtype)
                      if "mean" in str(p[-1]) else a), v)
    return jm, v


def test_flowunet_and_keypoint_maps_match_jax():
    from animateportrait_tpu.models.flowunet import kp_to_map_binary as jkp
    from animateportrait_tpu_torch.models.flowunet import kp_to_map_binary

    jm, v = _flowunet_jax()
    tm = FlowUnet(input_nc=6, nf=4, num_scale=3, max_nf=64)
    tm.load_state_dict(from_jax.flowunet_state_dict(v, num_scale=3))
    x = _rng(3).standard_normal((2, 32, 32, 6)).astype(np.float32)
    flow, vis, pyr, _ = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        tflow, tvis, tpyr, _ = tm(nchw(x))
    assert maxdiff(nhwc(tflow), flow) <= 1e-4
    assert maxdiff(nhwc(tvis), vis) <= 1e-4
    assert len(tpyr) == len(pyr)
    for a, b in zip(tpyr, pyr):
        assert maxdiff(nhwc(a), b) <= 1e-4

    kps = _rng(4).uniform(-5, 230, (2, 68, 2)).astype(np.float32)
    kps[0, 3] = -1.0                                # an absent keypoint
    ref = jkp((224, 224), jnp.asarray(kps))         # (2, 224, 224, 68)
    got = kp_to_map_binary((224, 224), torch.from_numpy(kps))
    np.testing.assert_array_equal(nhwc(got), np.asarray(ref))


def _modnet_jax():
    from animateportrait_tpu.models.modnet import MODNet as JM

    jm = JM()
    v = random_variables(lambda: jm.init(K, jnp.zeros((1, 64, 64, 3))))
    rng = _rng(5)
    v = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 2.0, a.shape).astype(a.dtype)
                      if "var" in str(p[-1]) else a), v)
    return jm, v


def test_modnet_matches_jax():
    jm, v = _modnet_jax()
    tm = MODNet()
    tm.load_state_dict(from_jax.modnet_state_dict(v))
    img = _rng(6).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    _, _, ref = jm.apply(v, jnp.asarray(img))
    with torch.no_grad():
        got = tm(nchw(img))
    # ~55 convs deep: fp32 accumulation order differs between XLA:CPU and
    # torch's kernels at every layer; the matte is a sigmoid in [0, 1]
    assert maxdiff(nhwc(got), ref) <= 1e-4


# --- converters: port state dict -> JAX loader -> the same variables -------


def _round_trip_cases():
    from animateportrait_tpu.models import audio2landmark as ja
    from animateportrait_tpu.models import autovc as jv
    from animateportrait_tpu.models import flowunet as jf
    from animateportrait_tpu.models import gan as jg
    from animateportrait_tpu.models import modnet as jmn

    def trident():
        return _trident_jax(nb=4, size=16)[1], \
            lambda v: from_jax.trident_state_dict(v, 4, 3, 3), \
            lambda sd: jg.load_trident_full_ifw_params(sd, 4, 3, 3)

    def style2():
        v = random_variables(lambda: jg.ResnetStyle2Generator(ngf=8, n_blocks=2).init(
            K, jnp.zeros((1, 16, 16, 3)), jnp.zeros((1, 4, 4, 3))))
        return v, lambda v: from_jax.style2_state_dict(v, 2), \
            lambda sd: jg.load_style2_params(sd, 2)

    def flowunet():
        return _flowunet_jax()[1], \
            lambda v: from_jax.flowunet_state_dict(v, 3), \
            lambda sd: jf.load_flowunet_params(sd, 3)

    def modnet():
        return _modnet_jax()[1], from_jax.modnet_state_dict, \
            jmn.load_modnet_params

    def autovc():
        v = random_variables(lambda: jv.AutoVCGenerator().init(
            K, jnp.zeros((1, 32, 80)), jnp.zeros((1, 256)),
            jnp.zeros((1, 256)), jnp.zeros((1, 32, 257))))
        return v, from_jax.autovc_state_dict, jv.load_autovc_params

    def content():
        v = random_variables(lambda: ja.Audio2landmarkContent().init(
            K, jnp.zeros((4, 18, 80)), jnp.zeros((1, 204))))
        return v, from_jax.content_state_dict, ja.load_content_params

    def pos():
        v = random_variables(lambda: ja.Audio2landmarkPos().init(
            K, jnp.zeros((4, 18, 80)), jnp.zeros((4, 256)),
            jnp.zeros((1, 204)), jnp.zeros((4, 128))))
        return v, from_jax.pos_state_dict, ja.load_pos_params

    return {"trident": trident, "style2": style2, "flowunet": flowunet,
            "modnet": modnet, "autovc": autovc, "content": content,
            "pos": pos}


_PORT = {
    "trident": lambda: TridentGeneratorFullIFW(output_nc=1, ngf=8,
                                               n_blocks=4, div=3, disp=3),
    "style2": lambda: ResnetStyle2Generator(ngf=8, n_blocks=2),
    "flowunet": lambda: FlowUnet(input_nc=6, nf=4, num_scale=3, max_nf=64),
    "modnet": MODNet,
    "autovc": AutoVCGenerator,
    "content": Audio2landmarkContent,
    "pos": Audio2landmarkPos,
}


@pytest.mark.parametrize("net", sorted(_PORT))
def test_converter_round_trip(net):
    v, to_torch, load_jax = _round_trip_cases()[net]()
    sd = to_torch(v)
    # the state dict fits the port's module exactly (strict load)...
    _PORT[net]().load_state_dict(sd, strict=True)
    # ...and the JAX package's own loader maps it back to the same tree
    back = load_jax({k: t.numpy() for k, t in sd.items()})
    flat_v = jax.tree_util.tree_flatten_with_path(v)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_v) == len(flat_b)
    for path, a in flat_v:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(a),
                                      err_msg=jax.tree_util.keystr(path))
