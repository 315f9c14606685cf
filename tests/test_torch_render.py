"""The port's Module2 renderer (drawing style) against the JAX renderer on
the same weights, photo and landmarks, at small widths (generator ngf 8
with 3 blocks, FlowUnet nf 4 / 3 scales, static net ngf 8 with 2 blocks;
MODNet at its only width), frame batch 2 over 3 frames."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from animateportrait_tpu_torch.io import from_jax
from animateportrait_tpu.utils.smoke import random_variables
from torch_port_helpers import psnr

K = jax.random.key(0)
CS = 256


def _face(rng, jitter):
    from animateportrait_tpu.utils import assets

    std = assets.std_face_landmarks()[:, :2] * np.array([1, -1])
    lm = (std - std.mean(0)) / np.ptp(std[:, 0]) * 110 + 128
    return (lm + rng.uniform(-jitter, jitter, lm.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def renderers():
    from animateportrait_tpu.models.flowunet import FlowUnet as JF
    from animateportrait_tpu.models.gan import (
        ResnetStyle2Generator as JS, TridentGeneratorFullIFW as JT)
    from animateportrait_tpu.models.modnet import MODNet as JM
    from animateportrait_tpu.pipeline.render import (
        Module2Renderer as JR, RendererVariables)
    from animateportrait_tpu_torch.models.flowunet import FlowUnet
    from animateportrait_tpu_torch.models.gan import (
        ResnetStyle2Generator, TridentGeneratorFullIFW)
    from animateportrait_tpu_torch.models.modnet import MODNet
    from animateportrait_tpu_torch.pipeline.render import Module2Renderer

    z = lambda *s: jnp.zeros(s)  # noqa: E731
    gen_v = random_variables(lambda: JT(output_nc=1, ngf=8, n_blocks=3, div=3,
                                disp=3).init(
        K, z(1, CS, CS, 3), z(1, CS, CS, 1), z(1, CS, CS, 1),
        z(1, CS, CS, 2), z(1, CS, CS, 2), z(1, CS, CS, 1)), seed=1)
    flow_v = random_variables(lambda: JF(nf=4, num_scale=3, max_nf=64).init(
        K, z(1, 224, 224, 136)), seed=2)
    mod_v = random_variables(lambda: JM().init(K, z(1, CS, CS, 3)), seed=3)
    static_v = random_variables(lambda: JS(ngf=8, n_blocks=2).init(
        K, z(1, 512, 512, 3), z(1, 128, 128, 3)), seed=4)
    jr = JR(RendererVariables(generator=gen_v, flowunet=flow_v,
                              modnet=mod_v, static_drawing=static_v),
            style="drawing", ngf=8, n_blocks=3, div=3, disp=3,
            frame_batch=2, flowunet=JF(nf=4, num_scale=3, max_nf=64),
            static_g=JS(ngf=8, n_blocks=2))

    gen = TridentGeneratorFullIFW(output_nc=1, ngf=8, n_blocks=3, div=3,
                                  disp=3)
    gen.load_state_dict(from_jax.trident_state_dict(gen_v, 3, 3, 3))
    flow = FlowUnet(nf=4, num_scale=3, max_nf=64)
    flow.load_state_dict(from_jax.flowunet_state_dict(flow_v, 3))
    mod = MODNet()
    mod.load_state_dict(from_jax.modnet_state_dict(mod_v))
    static = ResnetStyle2Generator(ngf=8, n_blocks=2)
    static.load_state_dict(from_jax.style2_state_dict(static_v, 2))
    tr = Module2Renderer(gen, flow, mod, static, frame_batch=2,
                         device="cpu")
    return jr, tr


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:CS, 0:CS] / CS
    photo = np.stack([np.sin(6 * x + 1) * np.cos(4 * y), x - y,
                      np.cos(5 * x * y)], -1)
    photo = (0.8 * photo + 0.1 * rng.standard_normal(photo.shape)).clip(
        -1, 1).astype(np.float32)
    a68 = _face(rng, 0.0)
    tb68 = np.stack([_face(rng, 2.0) for _ in range(3)])
    return photo, a68, tb68


def test_renderer_with_injected_motion_matches_jax(renderers, scene):
    from animateportrait_tpu.ops.tps import (
        linear_motion_grid, triangulate_frames)

    jr, tr = renderers
    photo, a68, tb68 = scene
    motions = np.asarray(linear_motion_grid(
        jnp.asarray(np.repeat(a68[None], 3, 0)), jnp.asarray(tb68),
        jnp.asarray(triangulate_frames(tb68, CS)), CS))
    ref = np.asarray(jr(photo, a68, tb68, motions=motions))
    with torch.no_grad():
        got = tr(photo, a68, tb68, motions=motions)
    assert got.shape == ref.shape == (3, CS, CS, 1)
    # the composed render chain's bound (tests/test_composed_parity.py)
    assert psnr(got, ref) >= 40.0


def test_renderer_linear_grid_and_uint8_match_jax(renderers, scene):
    jr, tr = renderers
    photo, a68, tb68 = scene
    ref = np.asarray(jr(photo, a68, tb68))
    with torch.no_grad():
        got = tr(photo, a68, tb68)
        tr.output_uint8 = True
        try:
            got8 = tr(photo, a68, tb68)
        finally:
            tr.output_uint8 = False
    assert psnr(got, ref) >= 40.0
    assert got8.dtype == np.uint8 and got8.shape == (3, CS, CS, 1)
    ref8 = np.clip((ref + 1.0) * 127.5, 0, 255).astype(np.uint8)
    assert psnr(got8, ref8, peak=255.0) >= 40.0
