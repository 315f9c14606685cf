"""The whole slice: the port's TalkingPortraitPipeline against the JAX one
with the same stub detector, photo, WAV, numpy rng and weights (JAX
random variables carried over), at small widths; plus the alignment
stage, which the port does without OpenCV."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from animateportrait_tpu_torch.io import from_jax
from animateportrait_tpu_torch.utils.smoke import StubDetector, make_wav
from animateportrait_tpu.utils.smoke import random_variables
from torch_port_helpers import maxdiff, psnr

K = jax.random.key(0)
CS = 256


def _pipelines():
    from animateportrait_tpu.models import audio2landmark as ja
    from animateportrait_tpu.models.autovc import AutoVCGenerator as JV
    from animateportrait_tpu.models.flowunet import FlowUnet as JF
    from animateportrait_tpu.models.gan import (
        ResnetStyle2Generator as JS, TridentGeneratorFullIFW as JT)
    from animateportrait_tpu.models.modnet import MODNet as JM
    from animateportrait_tpu.pipeline.audio import AudioPipeline as JAudio
    from animateportrait_tpu.pipeline.end2end import (
        TalkingPortraitPipeline as JPipe)
    from animateportrait_tpu.pipeline.landmark import LandmarkPredictor as JL
    from animateportrait_tpu.pipeline.render import (
        Module2Renderer as JR, RendererVariables)
    from animateportrait_tpu_torch.models.audio2landmark import (
        Audio2landmarkContent, Audio2landmarkPos)
    from animateportrait_tpu_torch.models.autovc import AutoVCGenerator
    from animateportrait_tpu_torch.models.flowunet import FlowUnet
    from animateportrait_tpu_torch.models.gan import (
        ResnetStyle2Generator, TridentGeneratorFullIFW)
    from animateportrait_tpu_torch.models.modnet import MODNet
    from animateportrait_tpu_torch.utils.smoke import build_pipeline

    z = lambda *s: jnp.zeros(s)  # noqa: E731
    v = {
        "autovc": random_variables(lambda: JV().init(
            K, z(1, 32, 80), z(1, 256), z(1, 256), z(1, 32, 257)), seed=1),
        "pos": random_variables(lambda: ja.Audio2landmarkPos().init(
            K, z(4, 18, 80), z(4, 256), z(1, 204), z(4, 128)), seed=2),
        "content": random_variables(lambda: ja.Audio2landmarkContent().init(
            K, z(4, 18, 80), z(1, 204)), seed=3),
        "generator": random_variables(lambda: JT(output_nc=1, ngf=8, n_blocks=3,
                                         div=3, disp=3).init(
            K, z(1, CS, CS, 3), z(1, CS, CS, 1), z(1, CS, CS, 1),
            z(1, CS, CS, 2), z(1, CS, CS, 2), z(1, CS, CS, 1)), seed=4),
        "flowunet": random_variables(lambda: JF(nf=4, num_scale=3, max_nf=64).init(
            K, z(1, 224, 224, 136)), seed=5),
        "modnet": random_variables(lambda: JM().init(K, z(1, CS, CS, 3)), seed=6),
        "static_g": random_variables(lambda: JS(ngf=8, n_blocks=2).init(
            K, z(1, 512, 512, 3), z(1, 128, 128, 3)), seed=7),
    }
    jpipe = JPipe(
        StubDetector(), JL(v["pos"], v["content"]),
        JAudio(v["autovc"], chunk=512),
        JR(RendererVariables(generator=v["generator"],
                             flowunet=v["flowunet"], modnet=v["modnet"],
                             static_drawing=v["static_g"]),
           style="drawing", ngf=8, n_blocks=3, div=3, disp=3, frame_batch=2,
           flowunet=JF(nf=4, num_scale=3, max_nf=64),
           static_g=JS(ngf=8, n_blocks=2), output_uint8=True))

    nets = {
        "autovc": (AutoVCGenerator(), from_jax.autovc_state_dict),
        "pos": (Audio2landmarkPos(), from_jax.pos_state_dict),
        "content": (Audio2landmarkContent(), from_jax.content_state_dict),
        "generator": (TridentGeneratorFullIFW(output_nc=1, ngf=8, n_blocks=3,
                                              div=3, disp=3),
                      lambda x: from_jax.trident_state_dict(x, 3, 3, 3)),
        "flowunet": (FlowUnet(nf=4, num_scale=3, max_nf=64),
                     lambda x: from_jax.flowunet_state_dict(x, 3)),
        "modnet": (MODNet(), from_jax.modnet_state_dict),
        "static_g": (ResnetStyle2Generator(ngf=8, n_blocks=2),
                     lambda x: from_jax.style2_state_dict(x, 2)),
    }
    for name, (net, convert) in nets.items():
        net.load_state_dict(convert(v[name]))
    tpipe = build_pipeline({k: n for k, (n, _) in nets.items()}, "cpu",
                           frame_batch=2, output_uint8=True)
    return jpipe, tpipe


def test_whole_slice_matches_jax():
    jpipe, tpipe = _pipelines()
    photo = np.random.default_rng(0).uniform(0, 255, (512, 512, 3)).astype(
        np.uint8)
    wav = make_wav(1.0, seed=2)
    ref = jpipe(photo, wav, rng=np.random.default_rng(5))
    with torch.inference_mode():
        got = tpipe(photo, wav, rng=np.random.default_rng(5))
    T = ref.frames.shape[0]
    assert T == 45
    assert got.frames.shape == ref.frames.shape == (T, CS, CS, 1)
    assert got.frames.dtype == np.uint8
    # aligned photo: the OpenCV-free bicubic is within one uint8 level
    assert np.abs(got.aligned_photo.astype(int)
                  - ref.aligned_photo.astype(int)).max() <= 1
    # landmarks in aligned-512 pixels: the target is <= 0.05 px
    assert got.landmarks.shape == ref.landmarks.shape == (T, 68, 3)
    assert maxdiff(got.landmarks, ref.landmarks) <= 0.05
    assert psnr(got.frames, ref.frames, peak=255.0) >= 35.0


def test_alignment_matches_jax():
    from animateportrait_tpu.pipeline import align as ja
    from animateportrait_tpu_torch.pipeline import align as ta

    img = np.random.default_rng(1).integers(0, 256, (300, 280, 3)).astype(
        np.uint8)
    det = StubDetector()
    a_t, five_t = ta.detect_and_align(img, det)
    a_j, five_j = ja.detect_and_align(img, det)
    np.testing.assert_array_equal(five_t, five_j)
    assert np.abs(a_t.astype(int) - a_j.astype(int)).max() <= 1
    np.testing.assert_array_equal(ta.estimate_landmarks_from_5pt(five_t),
                                  ja.estimate_landmarks_from_5pt(five_j))
    with pytest.raises(ValueError, match="no face"):
        ta.align_face(img, np.zeros((0, 5)))
