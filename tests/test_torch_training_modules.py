"""The modules of the port's Module2 training step against the JAX package's,
on the CPU at small sizes, on the same numpy inputs from a seed:

- K2's gradient: autograd through the plain version, and K2b's plain
  version, against ``jax.vjp`` of the JAX package's InstanceNorm (its XLA
  formulation), with and without the ReLU, at an aligned and a 31 x 31
  shape (max |diff| <= 2e-5 at unit-scale inputs);
- the PatchGAN discriminator (2e-5), MobileFaceNet (5e-5), Sphere20a and
  ``face_loss`` (1e-4) and ``crop_head_bbox`` (1e-4), at the JAX tests'
  tolerances, on the port's seeded weights carried into the JAX package by
  its own loaders; and each converter's round trip through that loader;
- the samplers, the TPS warps and motion grids (tolerances measured and
  stated below), the landmark extraction, the lip-line mask and the flow
  fields;
- the coherence pool fed JAX's own draws, the lr schedules at every policy
  and the Adam step, and ``init_weights`` at every mode.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from animateportrait_tpu_torch.io import from_jax
from animateportrait_tpu_torch.models.gan import (
    NLayerDiscriminator, gan_loss, init_weights)
from animateportrait_tpu_torch.models.perception import (
    MobileFaceNet, Sphere20a, crop_head_bbox, face_loss)
from animateportrait_tpu_torch.ops import instnorm, tps, warp
from animateportrait_tpu_torch.train import module2 as m2
from torch_port_helpers import maxdiff, nchw, nhwc


def _rng(seed=0):
    return np.random.default_rng(seed)


def _numpy_sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _seeded(module, seed):
    """``module`` with the port's random frozen-net init, and BatchNorm
    running statistics away from 0 / 1, in eval mode."""
    gen = torch.Generator().manual_seed(seed)
    m2._lecun_init_(module, gen)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                m.running_mean.uniform_(-0.3, 0.3, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.uniform_(-0.2, 0.2, generator=gen)
            if isinstance(m, torch.nn.PReLU):
                m.weight.uniform_(0.1, 0.4, generator=gen)
    return module.eval()


def _round_trip(sd, loader, converter):
    back = converter(loader(sd))
    keys = {k for k in sd if not k.endswith("num_batches_tracked")}
    assert keys == {k for k in back if not k.endswith("num_batches_tracked")}
    for k in keys:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)


# --- K2's gradient ----------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 8, 16, 16), (2, 4, 31, 31)])
@pytest.mark.parametrize("relu", [False, True])
def test_k2_gradient_matches_jax_vjp(shape, relu):
    from animateportrait_tpu.ops.pallas_instnorm import instance_norm as jin

    rng = _rng(1)
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    to_nhwc = (0, 2, 3, 1)
    y, vjp = jax.vjp(lambda v: jin(v, 1e-5, relu),
                     jnp.asarray(x.transpose(to_nhwc)))
    want = np.asarray(vjp(jnp.asarray(g.transpose(to_nhwc)))[0]).transpose(
        0, 3, 1, 2)
    xt = torch.from_numpy(x).requires_grad_()
    yt = instnorm.instance_norm(xt, relu=relu)      # CPU: the plain version
    (got,) = torch.autograd.grad(yt, xt, torch.from_numpy(g))
    assert maxdiff(yt.detach().numpy(),
                   np.asarray(y).transpose(0, 3, 1, 2)) <= 2e-5
    assert maxdiff(got.numpy(), want) <= 2e-5
    # K2b's plain version, from the statistics K2 saves, is the same
    # gradient
    stats = instnorm.instance_norm_stats_plain(torch.from_numpy(x))
    dx = instnorm.instance_norm_backward(torch.from_numpy(x),
                                         torch.from_numpy(g), stats, relu)
    assert maxdiff(dx.numpy(), want) <= 2e-5


def test_k2_stats_and_backward_plain_hold_planes_far_from_zero_mean():
    """The saved k + m (the mean) and rstd of planes at |mean|/std ~ 40
    against float64, and dx from them against float64 autograd."""
    rng = _rng(2)
    x = (rng.standard_normal((1, 3, 24, 24)) * 0.25
         + np.array([10.0, -4.0, 0.5])[None, :, None, None])
    g = rng.standard_normal(x.shape)
    x32 = torch.from_numpy(x.astype(np.float32))
    stats = instnorm.instance_norm_stats_plain(x32).numpy()
    x64 = torch.from_numpy(x.astype(np.float32).astype(np.float64))
    mean = x64.mean((2, 3)).reshape(-1).numpy()
    var = x64.var((2, 3), unbiased=False).reshape(-1).numpy()
    np.testing.assert_allclose(stats[:, 0] + stats[:, 1], mean, rtol=1e-6)
    np.testing.assert_allclose(stats[:, 2], 1 / np.sqrt(var + 1e-5),
                               rtol=1e-4)
    for relu in (False, True):
        xr = x64.clone().requires_grad_()
        y = torch.nn.functional.instance_norm(xr, eps=1e-5)
        if relu:
            y = torch.relu(y)
        (want,) = torch.autograd.grad(y, xr, torch.from_numpy(g))
        got = instnorm.instance_norm_backward_plain(
            x32, torch.from_numpy(g.astype(np.float32)),
            torch.from_numpy(stats), relu)
        assert maxdiff(got.numpy(), want.numpy()) <= 2e-4 * float(
            want.abs().max())


# --- discriminator, perception nets and converters ---------------------------


def test_nlayer_discriminator_matches_jax_and_round_trips():
    from animateportrait_tpu.models.gan import (
        NLayerDiscriminator as JD, load_nlayer_d_params)

    d = init_weights(NLayerDiscriminator(3, ndf=8, n_layers=3), "normal",
                     0.02, torch.Generator().manual_seed(5))
    with torch.no_grad():
        for n, p in d.named_parameters():
            if n.endswith("bias"):
                p.uniform_(-0.1, 0.1)
    sd = _numpy_sd(d)
    x = _rng(3).standard_normal((2, 64, 64, 3)).astype(np.float32)
    ref = JD(ndf=8, n_layers=3).apply(load_nlayer_d_params(sd), x)
    with torch.no_grad():
        got = d(nchw(x))
    assert got.shape == (2, 1, 6, 6)
    assert maxdiff(nhwc(got), ref) <= 2e-5
    _round_trip(sd, load_nlayer_d_params, from_jax.nlayer_d_state_dict)


def test_gan_loss_modes_match_jax():
    from animateportrait_tpu.models.gan import gan_loss as jgl

    p = _rng(4).standard_normal((2, 1, 6, 6)).astype(np.float32)
    for mode in ("lsgan", "vanilla", "wgangp"):
        for real in (True, False):
            np.testing.assert_allclose(
                float(gan_loss(torch.from_numpy(p), real, mode)),
                float(jgl(jnp.asarray(p), real, mode)), rtol=1e-6,
                err_msg=mode)


def test_mobilefacenet_matches_jax_and_round_trips():
    from animateportrait_tpu.models.perception import (
        MobileFaceNet as JM, load_mobilefacenet_params)

    net = _seeded(MobileFaceNet(), 8)
    sd = _numpy_sd(net)
    img = _rng(5).uniform(0, 1, (2, 112, 112, 3)).astype(np.float32)
    lm, feats = jax.jit(JM().apply)(load_mobilefacenet_params(sd), img)
    with torch.no_grad():
        tlm, tfeats = net(nchw(img))
    assert maxdiff(tlm.numpy(), lm) <= 5e-5
    assert maxdiff(nhwc(tfeats), feats) <= 5e-5
    _round_trip(sd, load_mobilefacenet_params,
                from_jax.mobilefacenet_state_dict)


@pytest.fixture(scope="module")
def sphere_pair():
    from animateportrait_tpu.models.perception import (
        Sphere20a as JS, load_sphere20a_params)

    net = _seeded(Sphere20a(), 9)
    sd = _numpy_sd(net)
    return net, sd, load_sphere20a_params(sd), jax.jit(JS().apply)


def test_sphere20a_and_face_loss_match_jax(sphere_pair):
    from animateportrait_tpu.models.perception import face_loss as jfl

    net, _, variables, apply = sphere_pair
    rng = _rng(6)
    img1 = rng.uniform(-1, 1, (2, 112, 96, 3)).astype(np.float32)
    img2 = rng.uniform(-1, 1, (2, 112, 96, 3)).astype(np.float32)
    feats = apply(variables, img1)
    with torch.no_grad():
        tfeats = net(nchw(img1))
    assert len(tfeats) == len(feats) == 5
    for a, b in zip(feats, tfeats):
        b = b.numpy() if b.dim() == 2 else nhwc(b)
        assert maxdiff(b, a) <= 1e-4
    ref, vjp = jax.vjp(lambda v: jfl(apply, variables, v, img2),
                       jnp.asarray(img1))
    x1 = nchw(img1).requires_grad_()
    got = face_loss(net, x1, nchw(img2))
    np.testing.assert_allclose(float(got), float(ref), atol=1e-4)
    # the gradient reaches img1 only: the reference side is detached
    (gx,) = torch.autograd.grad(got, x1)
    want = np.asarray(vjp(jnp.ones(()))[0])
    assert maxdiff(nhwc(gx), want) <= 1e-4 * np.abs(want).max()


def test_sphere20a_round_trip(sphere_pair):
    from animateportrait_tpu.models.perception import load_sphere20a_params

    _, sd, _, _ = sphere_pair
    _round_trip(sd, load_sphere20a_params, from_jax.sphere20a_state_dict)


def test_crop_head_bbox_matches_jax():
    from animateportrait_tpu.models.perception import crop_head_bbox as jc

    imgs = _rng(7).standard_normal((2, 64, 64, 3)).astype(np.float32)
    bbox = np.array([[10, 50, 8, 60], [-6, 40, 30, 75]], np.int32)
    ref = jc(jnp.asarray(imgs), jnp.asarray(bbox))
    got = crop_head_bbox(nchw(imgs), torch.from_numpy(bbox))
    assert got.shape == (2, 3, 112, 96)
    assert maxdiff(nhwc(got), ref) <= 1e-4


# --- samplers, warps, geometry ----------------------------------------------


def test_sample_bilinear_matches_jax():
    from animateportrait_tpu.ops.warp import sample_bilinear as jsb

    rng = _rng(8)
    img = rng.standard_normal((2, 20, 24, 3)).astype(np.float32)
    iy = rng.uniform(-4, 24, (2, 9, 7)).astype(np.float32)
    ix = rng.uniform(-4, 28, (2, 9, 7)).astype(np.float32)
    ref = jsb(jnp.asarray(img), jnp.asarray(iy), jnp.asarray(ix), "border")
    got = warp.sample_bilinear(nchw(img), torch.from_numpy(iy),
                               torch.from_numpy(ix))
    assert maxdiff(nhwc(got), ref) <= 1e-5


def test_sample_bicubic_matches_jax_and_torch():
    from animateportrait_tpu.ops.warp import sample_bicubic as jsc

    rng = _rng(9)
    img = rng.standard_normal((2, 20, 24, 3)).astype(np.float32)
    # within 1 px of the image, where clamping the base index and each
    # tap agree
    iy = rng.uniform(-1, 20, (2, 9, 7)).astype(np.float32)
    ix = rng.uniform(-1, 24, (2, 9, 7)).astype(np.float32)
    ref = jsc(jnp.asarray(img), jnp.asarray(iy), jnp.asarray(ix))
    got = warp.sample_bicubic(nchw(img), torch.from_numpy(iy),
                              torch.from_numpy(ix))
    assert maxdiff(nhwc(got), ref) <= 2e-5
    # the same samples as torch's bicubic grid_sample (border padding,
    # align_corners=True), away from the border
    gy, gx = torch.meshgrid(torch.arange(20.0), torch.arange(24.0),
                            indexing="ij")
    sy, sx = gy[None, 2:-2, 2:-2] + 0.37, gx[None, 2:-2, 2:-2] - 0.61
    grid = torch.stack([sx / 23 * 2 - 1, sy / 19 * 2 - 1], -1).expand(
        2, -1, -1, -1)
    lib = torch.nn.functional.grid_sample(nchw(img), grid, mode="bicubic",
                                          padding_mode="border",
                                          align_corners=True)
    ours = warp.sample_bicubic(nchw(img), sy.expand(2, -1, -1),
                               sx.expand(2, -1, -1))
    assert maxdiff(ours, lib) <= 2e-5


def test_dense_image_warp_matches_jax():
    from animateportrait_tpu.ops.warp import dense_image_warp as jd

    rng = _rng(10)
    img = rng.standard_normal((2, 16, 16, 2)).astype(np.float32)
    flow = rng.uniform(-5, 5, (2, 16, 16, 2)).astype(np.float32)
    ref = jd(jnp.asarray(img), jnp.asarray(flow))
    got = warp.dense_image_warp(nchw(img), torch.from_numpy(flow))
    assert maxdiff(nhwc(got), ref) <= 1e-5


def _face68(rng, size=64, jitter=1.5):
    from animateportrait_tpu_torch.utils.assets import std_face_landmarks

    std = std_face_landmarks()[:, :2] * np.array([1, -1])
    lm = (std - std.mean(0)) / np.ptp(std[:, 0]) * size * 0.45 + size / 2
    return (lm + rng.uniform(-jitter, jitter, lm.shape)).astype(np.float32)


def _spline64(tp, tv, q, reg=1e-6):
    """interpolate_spline (order 2) in float64: the same normalization,
    ridge and system, by numpy."""
    tp, tv, q = (np.asarray(a, np.float64) for a in (tp, tv, q))
    c = tp.mean(1, keepdims=True)
    s = np.maximum(tp.std(axis=(1, 2), keepdims=True), 1e-3)
    tpn, qn = (tp - c) / s, (q - c) / s

    def phi(d2):
        return 0.5 * d2 * np.log(np.maximum(d2, 1e-10))

    out = []
    for b in range(tp.shape[0]):
        n = tpn.shape[1]
        a = phi(((tpn[b][:, None] - tpn[b][None]) ** 2).sum(-1)) \
            + reg * np.eye(n)
        bb = np.concatenate([tpn[b], np.ones((n, 1))], 1)
        lhs = np.block([[a, bb], [bb.T, np.zeros((3, 3))]])
        sol = np.linalg.solve(lhs, np.concatenate(
            [tv[b], np.zeros((3, tv.shape[-1]))]))
        qp = np.concatenate([qn[b], np.ones((len(qn[b]), 1))], 1)
        out.append(phi(((qn[b][:, None] - tpn[b][None]) ** 2).sum(-1))
                   @ sol[:n] + qp @ sol[n:])
    return np.stack(out)


def _pixel_grid(size):
    gy, gx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    return np.stack([gy, gx], -1).reshape(1, -1, 2)


# Well-spread control points: the two fp32 solves agree to 4.9e-4 px
# (flows) and 8.6e-4 (warped images) at 128 px, measured.
TPS_ATOL = 1e-3
# Face landmarks (lip points ~1 px apart) make the 71 x 71 system
# ill-conditioned: either fp32 solve is then 0.01-0.4 px from the float64
# solution (measured at 64, 128 and 256 px), so each is held against
# float64 instead: the port no further from it than the JAX package (with
# 10% and 1e-3 px of slack).
TPS_VS_JAX = 1.1


def test_sparse_image_warp_matches_jax_on_spread_points():
    from animateportrait_tpu.ops.tps import sparse_image_warp as jw

    rng = _rng(20)
    size = 128
    gy, gx = np.meshgrid(np.linspace(6, size - 7, 8),
                         np.linspace(6, size - 7, 8), indexing="ij")
    src = (np.stack([gy, gx], -1).reshape(1, 64, 2)
           + rng.uniform(-1.5, 1.5, (2, 64, 2))).astype(np.float32)
    dst = (src + rng.uniform(-2, 2, src.shape)).astype(np.float32)
    img = rng.uniform(-1, 1, (2, size, size, 1)).astype(np.float32)
    ref_img, ref_flow = jw(jnp.asarray(img), jnp.asarray(src),
                           jnp.asarray(dst))
    got_img, got_flow = tps.sparse_image_warp(
        nchw(img), torch.from_numpy(src), torch.from_numpy(dst))
    assert maxdiff(got_flow, ref_flow) <= TPS_ATOL
    assert maxdiff(nhwc(got_img), ref_img) <= TPS_ATOL


@pytest.mark.parametrize("size", [64, 256])
def test_tps_on_face_landmarks_as_close_to_float64_as_jax(size):
    from animateportrait_tpu.ops.tps import (
        motion_grid_from_landmarks as jm, sparse_image_warp as jw)

    rng = _rng(11)
    a = np.stack([_face68(rng, size) for _ in range(2)])
    b = (a + rng.uniform(-2, 2, a.shape)).astype(np.float32)
    src, dst = a[..., ::-1].copy(), b[..., ::-1].copy()
    img = rng.uniform(-1, 1, (2, 8, 8, 1)).astype(np.float32)
    # sparse_image_warp's flows (at an 8 px image: the solve is the same)
    ref_flow = np.asarray(jw(jnp.asarray(img), jnp.asarray(src),
                             jnp.asarray(dst))[1])
    got_flow = tps.sparse_image_warp(nchw(img), torch.from_numpy(src),
                                     torch.from_numpy(dst))[1].numpy()
    truth = _spline64(dst, dst - src, np.broadcast_to(
        _pixel_grid(8), (2, 64, 2))).reshape(2, 8, 8, 2)
    err, jerr = maxdiff(got_flow, truth), maxdiff(ref_flow, truth)
    assert err <= TPS_VS_JAX * jerr + TPS_ATOL, (err, jerr)
    # motion grids, in pixels
    ref = np.asarray(jm(jnp.asarray(a), jnp.asarray(b), size))
    got = tps.motion_grid_from_landmarks(torch.from_numpy(a),
                                         torch.from_numpy(b), size)
    assert got.shape == (2, size, size, 2)
    anchors = np.broadcast_to(tps.tps_edge_anchors(size)[None], (2, 8, 2))
    m = _spline64(np.concatenate([dst, anchors], 1),
                  np.concatenate([src, anchors], 1),
                  np.broadcast_to(_pixel_grid(size), (2, size * size, 2)))
    half = (size - 1) / 2
    truth = np.stack([m[:, :, 1], m[:, :, 0]], -1).reshape(
        2, size, size, 2) / half - 1
    err = maxdiff(got, truth) * half
    jerr = maxdiff(ref, truth) * half
    assert err <= TPS_VS_JAX * jerr + TPS_ATOL, (err, jerr)


def test_extract_landmarks_matches_jax():
    from animateportrait_tpu.models.perception import (
        load_mobilefacenet_params)
    from animateportrait_tpu.train.module2 import extract_landmarks as je

    net = _seeded(MobileFaceNet(), 13)
    rng = _rng(13)
    imgs = rng.uniform(-1, 1, (2, 64, 64, 1)).astype(np.float32)
    wins = np.array([[8, 56, 4, 60], [-4, 50, 10, 70]], np.int32)
    ref = je(load_mobilefacenet_params(_numpy_sd(net)), jnp.asarray(imgs),
             jnp.asarray(wins), 64)
    with torch.no_grad():
        got = m2.extract_landmarks(net, nchw(imgs), torch.from_numpy(wins))
    assert got.shape == (2, 68, 2)
    assert maxdiff(got, ref) <= 1e-3        # pixels of 48-60 px windows


def test_lipline_mask_and_masked_match_jax():
    from animateportrait_tpu.train.module2 import lipline_mask as jl
    from animateportrait_tpu.train.module2 import masked as jmk
    from animateportrait_tpu.utils.assets import face_lmark_lookup

    rng = _rng(14)
    lm = np.stack([_face68(rng) for _ in range(2)])
    edges = face_lmark_lookup()[:20]
    ref = np.asarray(jl(jnp.asarray(lm), edges, 64))
    got = m2.lipline_mask(torch.from_numpy(lm), edges, 64)
    # a pixel at distance thickness/2 from an edge may fall either way
    assert int((nhwc(got) != ref).sum()) <= 2 and ref.sum() > 20
    a = rng.uniform(-1, 1, (2, 8, 8, 1)).astype(np.float32)
    m = rng.uniform(0, 1, (2, 8, 8, 1)).astype(np.float32)
    for mt in (0, 1, 2, 3):
        assert maxdiff(nhwc(m2.masked(nchw(a), nchw(m), mt)),
                       jmk(jnp.asarray(a), jnp.asarray(m), mt)) <= 1e-6


def test_flow_warp_fields_match_jax():
    from animateportrait_tpu.models.flowunet import load_flowunet_params
    from animateportrait_tpu.train.module2 import flow_warp_fields as jf
    from animateportrait_tpu_torch.models.flowunet import FlowUnet

    net = _seeded(FlowUnet(), 15)
    rng = _rng(15)
    lm1 = np.stack([_face68(rng, 256)])
    lm2 = lm1 + rng.uniform(-3, 3, lm1.shape).astype(np.float32)
    flow, mask = jf(load_flowunet_params(_numpy_sd(net)), jnp.asarray(lm1),
                    jnp.asarray(lm2), 64)
    with torch.no_grad():
        tflow, tmask = m2.flow_warp_fields(net, torch.from_numpy(lm1),
                                           torch.from_numpy(lm2), 64)
    assert maxdiff(nhwc(tmask), mask) <= 1e-5
    assert maxdiff(nhwc(tflow), flow) <= 1e-4 * max(
        1.0, float(np.abs(np.asarray(flow)).max()))


# --- pool, schedules, Adam, init ---------------------------------------------


def test_pool_matches_jax_on_jax_draws():
    """Fill, the query that fills the pool, then full queries with slot
    collisions: the port's pool_swap on the draws JAX's pool_query makes
    (the same jax.random splits) gives JAX's pool, count and images."""
    from animateportrait_tpu.train.module2 import pool_query as jq

    psize, b = 6, 4
    pool_j = jnp.zeros((psize, 2, 2, 1))
    count_j = jnp.zeros((), jnp.int32)
    pool_t, count_t = torch.zeros((psize, 1, 2, 2)), 0
    n_hist = 0
    for t in range(12):
        imgs = np.arange(b * 4, dtype=np.float32).reshape(b, 2, 2, 1) + 100 * (
            t + 1)
        key = jax.random.key(t)
        pool_j, count_j, out_j = jq(pool_j, count_j, jnp.asarray(imgs), key)
        k1, k2 = jax.random.split(key)
        u = torch.from_numpy(np.asarray(jax.random.uniform(k1, (b,))))
        slots = torch.from_numpy(np.asarray(
            jax.random.randint(k2, (b,), 0, psize)).astype(np.int64))
        pool_t, count_t, out_t = m2.pool_swap(pool_t, count_t, nchw(imgs),
                                              u, slots)
        np.testing.assert_array_equal(nhwc(out_t), np.asarray(out_j))
        np.testing.assert_array_equal(nhwc(pool_t), np.asarray(pool_j))
        assert count_t == int(count_j)
        n_hist += int((nhwc(out_t) != imgs).any(axis=(1, 2, 3)).sum())
    assert count_t == psize and n_hist > 0


def test_pool_query_draws_from_its_generator():
    pool = torch.zeros((2, 1, 2, 2))
    imgs = torch.arange(8.0).reshape(2, 1, 2, 2)
    p1, c1, o1 = m2.pool_query(pool, 0, imgs,
                               torch.Generator().manual_seed(0))
    assert c1 == 2 and torch.equal(o1, imgs) and torch.equal(p1, imgs)
    assert not pool.any()                           # not modified
    outs = [m2.pool_query(p1, c1, imgs + 10,
                          torch.Generator().manual_seed(s))[2]
            for s in range(8)]
    assert any(not torch.equal(o, imgs + 10) for o in outs)
    again = m2.pool_query(p1, c1, imgs + 10, torch.Generator().manual_seed(3))
    assert torch.equal(again[2], outs[3])


def _pool_loop(pool, count, imgs, u, slots):
    """The pool query as one image at a time (the form before the host plan
    and the device apply): the reference of the plan."""
    new_pool, out = pool.clone(), []
    for i in range(imgs.shape[0]):
        if count + i < pool.shape[0]:
            new_pool[count + i] = imgs[i]
            out.append(imgs[i])
        elif count >= pool.shape[0] and float(u[i]) > 0.5:
            s = int(slots[i])
            out.append(pool[s])
            new_pool[s] = imgs[i]
        else:
            out.append(imgs[i])
    return new_pool, min(count + imgs.shape[0], pool.shape[0]), \
        torch.stack(out)


@pytest.mark.parametrize("count, u, slots", [
    (0, [0.9, 0.1, 0.7], [1, 2, 3]),              # filling
    (5, [0.9, 0.2, 0.8], [4, 0, 2]),              # full: swaps and passes
    (5, [0.5, np.nextafter(np.float32(0.5), np.float32(1)), 0.4999999],
     [3, 1, 0]),                                  # u around 0.5
    (5, [0.75, 0.6], [2, 2]),                     # two images, one slot
    (3, [0.9, 0.9, 0.9], [0, 1, 2]),              # crossing the size
], ids=["filling", "full", "u_near_half", "same_slot", "crossing"])
def test_pool_plan_and_apply_match_the_loop(count, u, slots):
    """``pool_plan`` on the host and ``pool_apply`` (a new pool, and in
    place as the step's CUDA graph takes it) give the one-image-at-a-time
    loop's pool, count and images, bit for bit."""
    psize = 5
    pool = torch.rand((psize, 1, 3, 3), generator=torch.Generator()
                      .manual_seed(count))
    imgs = 10 + torch.rand((len(u), 1, 3, 3),
                           generator=torch.Generator().manual_seed(7))
    u = torch.tensor(u, dtype=torch.float32)
    slots = torch.tensor(slots)
    want_pool, want_count, want_out = _pool_loop(pool, count, imgs, u, slots)
    got_pool, got_count, got_out = m2.pool_swap(pool, count, imgs, u, slots)
    assert got_count == want_count
    assert torch.equal(got_pool, want_pool) and torch.equal(got_out, want_out)
    rows, plan_count = m2.pool_plan(count, psize, u, slots)
    in_place = pool.clone()
    kept, out = m2.pool_apply(in_place, imgs, torch.tensor(rows),
                              out=in_place)
    assert kept is in_place and plan_count == want_count
    assert torch.equal(in_place, want_pool) and torch.equal(out, want_out)
    if count == psize:
        # a swap returns the old image of its slot, and a later image wins
        # a slot that two share
        assert (out < 10).any() and not torch.equal(got_pool, pool)


@pytest.mark.parametrize("policy", ["linear", "step", "plateau", "cosine"])
def test_lr_schedule_and_adam_match_optax(policy):
    from animateportrait_tpu.train import module2 as j2
    import optax

    cfg = m2.Module2Config(lr=5e-5, niter=10, niter_decay=10,
                           lr_decay_iters=3, steps_per_epoch=1,
                           lr_policy=policy)
    tx = j2.make_optimizer(j2.Module2Config(**dataclasses.asdict(cfg)))
    probe = {"w": jnp.zeros((1,))}
    opt = tx.init(probe)
    update = jax.jit(tx.update)
    for step in range(24):
        # the first Adam step of a gradient of 1 is 1: the update is
        # -lr(step) for the schedule's count set to step
        st = (opt[0], opt[1]._replace(count=jnp.asarray(step, jnp.int32)))
        upd, _ = update({"w": jnp.ones((1,))}, st, probe)
        np.testing.assert_allclose(m2.lr_at(cfg, step), -float(upd["w"][0]),
                                   rtol=1e-5, err_msg=f"step {step}")
    # five Adam steps of torch.optim.Adam at lr_at(step) are optax's
    cfg = dataclasses.replace(cfg, steps_per_epoch=2, niter=1, niter_decay=4,
                              lr_decay_iters=1)
    update = jax.jit(j2.make_optimizer(
        j2.Module2Config(**dataclasses.asdict(cfg))).update)
    rng = _rng(16)
    w0 = rng.standard_normal(5).astype(np.float32)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt_t = m2.make_optimizer(cfg, [p])
    params = {"w": jnp.asarray(w0)}
    opt = tx.init(params)           # the same (zero) state for any schedule
    for step in range(5):
        g = rng.standard_normal(5).astype(np.float32)
        upd, opt = update({"w": jnp.asarray(g)}, opt, params)
        params = optax.apply_updates(params, upd)
        p.grad = torch.from_numpy(g)
        for group in opt_t.param_groups:
            group["lr"] = m2.lr_at(cfg, step)
        opt_t.step()
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(params["w"]), rtol=1e-6,
                                   atol=1e-9, err_msg=f"step {step}")


@pytest.mark.parametrize("init_type",
                         ["normal", "xavier", "kaiming", "orthogonal"])
def test_init_weights_modes(init_type):
    """The statistics of the JAX package's test of ``init_weights``."""
    net = torch.nn.Sequential(torch.nn.Conv2d(64, 128, 3),
                              torch.nn.BatchNorm2d(128))
    with torch.no_grad():
        net[0].bias.fill_(1.0)
        net[1].bias.fill_(1.0)
    init_weights(net, init_type, 0.02, torch.Generator().manual_seed(3))
    k = net[0].weight.detach().numpy()
    assert not net[0].bias.any() and not net[1].bias.any()
    np.testing.assert_allclose(float(net[1].weight.mean()), 1.0, atol=0.01)
    fan_in, fan_out = 3 * 3 * 64, 3 * 3 * 128
    if init_type == "normal":
        np.testing.assert_allclose(k.std(), 0.02, rtol=0.05)
    elif init_type == "xavier":
        np.testing.assert_allclose(
            k.std(), 0.02 * np.sqrt(2.0 / (fan_in + fan_out)), rtol=0.05)
    elif init_type == "kaiming":
        np.testing.assert_allclose(k.std(), np.sqrt(2.0 / fan_in), rtol=0.05)
    else:
        m = k.reshape(128, -1)
        np.testing.assert_allclose(m @ m.T / 0.02 ** 2, np.eye(128),
                                   atol=1e-4)
    with pytest.raises(ValueError, match="init_type"):
        init_weights(net, "uniform")
