"""The port's LPIPS (``models/lpips.py``) against the JAX package on the same
weights (JAX random variables carried to torchvision-layout backbone state
dicts and LPIPS heads by ``io/from_jax.py``) and inputs: ``PNetLin`` with
each backbone (vgg, alex, squeeze), with ``lpips`` on and off, ``spatial``
and ``ret_per_layer``, each within 1e-4 of the distance's scale;
``Dist2LogitLayer``, ``bce_ranking_loss`` and ``l2_rgb`` within rtol 1e-5;
and the backbone and head converters checked by a round trip through the
JAX package's own loaders."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from animateportrait_tpu.models import lpips as jl
from animateportrait_tpu.utils.smoke import random_variables
from animateportrait_tpu_torch.io import from_jax
from animateportrait_tpu_torch.models import lpips as tl
from torch_port_helpers import maxdiff, nchw, nhwc

K = jax.random.key(0)
# squeezenet's and alexnet's strides need more than vgg's 32 pixels
SIZES = {"vgg": 48, "alex": 96, "squeeze": 64}


def _pair(size, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    return a, np.clip(a + rng.normal(0, 0.3, a.shape), -1, 1).astype(
        np.float32)


def _nets(pnet_type, **kw):
    jm = jl.PNetLin(pnet_type=pnet_type, **kw)
    a, b = _pair(SIZES[pnet_type])
    v = random_variables(lambda: jm.init(K, jnp.asarray(a), jnp.asarray(b)),
                         seed=7)
    tm = tl.PNetLin(pnet_type, **kw)
    tm.load_pnetlin(*from_jax.pnetlin_state_dicts(v, pnet_type))
    return jm, v, tm, a, b


@pytest.mark.parametrize("pnet_type", ["vgg", "alex", "squeeze"])
@pytest.mark.parametrize("mode", ["lpips", "spatial", "raw"])
def test_pnetlin_matches_jax(pnet_type, mode):
    kw = {"lpips": dict(), "spatial": dict(spatial=True),
          "raw": dict(lpips=False)}[mode]
    jm, v, tm, a, b = _nets(pnet_type, **kw)
    ref, ref_layers = jm.apply(v, jnp.asarray(a), jnp.asarray(b),
                               ret_per_layer=True)
    with torch.no_grad():
        got, layers = tm(nchw(a), nchw(b), ret_per_layer=True)
    ref = np.asarray(ref)
    assert got.shape == np.moveaxis(ref, -1, 1).shape
    assert maxdiff(nhwc(got), ref) <= 1e-4 * float(np.abs(ref).max())
    assert len(layers) == len(ref_layers)
    for g, r in zip(layers, ref_layers):
        r = np.asarray(r)
        assert maxdiff(nhwc(g), r) <= 1e-4 * float(np.abs(r).max())
    with torch.no_grad():
        same = tm(nchw(a), nchw(a))
    assert float(same.abs().max()) == 0.0


@pytest.mark.parametrize("pnet_type", ["vgg", "alex", "squeeze"])
def test_backbone_converter_round_trip(pnet_type):
    """The port's state dicts load strictly into its backbone and heads,
    and the JAX package's ``load_pnetlin_params`` maps them back to the
    same variables."""
    _, v, tm, _, _ = _nets(pnet_type)
    pnet_sd, lins = from_jax.pnetlin_state_dicts(v, pnet_type)
    tm.net.load_state_dict(pnet_sd, strict=True)
    back = jl.load_pnetlin_params({k: t.numpy() for k, t in pnet_sd.items()},
                                  {k: t.numpy() for k, t in lins.items()},
                                  pnet_type)
    flat_v = jax.tree_util.tree_flatten_with_path(v)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_v) == len(flat_b)
    for path, x in flat_v:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(x))


def test_dist2logit_ranking_loss_and_l2():
    rng = np.random.default_rng(3)
    d0, d1 = (rng.uniform(0, 1, (4, 1, 1, 1)).astype(np.float32)
              for _ in range(2))
    jm = jl.Dist2LogitLayer()
    v = random_variables(lambda: jm.init(K, jnp.asarray(d0), jnp.asarray(d1)),
                         seed=8)
    tm = tl.Dist2LogitLayer()
    tm.load_state_dict(from_jax.dist2logit_state_dict(v), strict=True)
    ref = np.asarray(jm.apply(v, jnp.asarray(d0), jnp.asarray(d1)))
    with torch.no_grad():
        got = tm(nchw(d0), nchw(d1))
    assert maxdiff(nhwc(got), ref) <= 1e-5 * np.abs(ref).max()
    judge = rng.uniform(-1, 1, (4, 1, 1, 1)).astype(np.float32)
    want = float(jl.bce_ranking_loss(jnp.asarray(ref), jnp.asarray(judge)))
    have = float(tl.bce_ranking_loss(torch.from_numpy(ref),
                                     torch.from_numpy(judge)))
    assert abs(have - want) <= 1e-5 * abs(want)
    a, b = _pair(16)
    np.testing.assert_allclose(
        tl.l2_rgb(nchw(a), nchw(b)).numpy(),
        np.asarray(jl.l2_rgb(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)
