"""The whole slice a user starts from, against the JAX package: the port's
``TalkingPortraitPipeline`` with ``MTCNNDetector`` (seeded face-biased
weights) and the cartoon renderer, against the JAX pipeline with the same
weights (JAX random variables carried over), photo, WAV and numpy rng, at
small widths."""
import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

from animateportrait_tpu_torch.io import from_jax
from animateportrait_tpu_torch.utils.smoke import (
    make_wav, write_mtcnn_weights)
from animateportrait_tpu.utils.smoke import random_variables
from torch_port_helpers import maxdiff, psnr

K = jax.random.key(0)
CS = 256


def _pipelines(mtcnn_dir):
    from animateportrait_tpu.models import audio2landmark as ja
    from animateportrait_tpu.models import mtcnn as jmt
    from animateportrait_tpu.models.autovc import AutoVCGenerator as JV
    from animateportrait_tpu.models.flowunet import FlowUnet as JF
    from animateportrait_tpu.models.gan import TridentGeneratorFullIFW as JT
    from animateportrait_tpu.models.modnet import MODNet as JM
    from animateportrait_tpu.models.photo2cartoon import (
        Photo2CartoonGenerator as JP)
    from animateportrait_tpu.pipeline.audio import AudioPipeline as JAudio
    from animateportrait_tpu.pipeline.end2end import (
        TalkingPortraitPipeline as JPipe)
    from animateportrait_tpu.pipeline.landmark import LandmarkPredictor as JL
    from animateportrait_tpu.pipeline.render import (
        Module2Renderer as JR, RendererVariables)
    from animateportrait_tpu_torch.models import mtcnn
    from animateportrait_tpu_torch.models.audio2landmark import (
        Audio2landmarkContent, Audio2landmarkPos)
    from animateportrait_tpu_torch.models.autovc import AutoVCGenerator
    from animateportrait_tpu_torch.models.flowunet import FlowUnet
    from animateportrait_tpu_torch.models.gan import TridentGeneratorFullIFW
    from animateportrait_tpu_torch.models.modnet import MODNet
    from animateportrait_tpu_torch.models.photo2cartoon import (
        Photo2CartoonGenerator)
    from animateportrait_tpu_torch.utils.smoke import build_pipeline

    z = lambda *s: jnp.zeros(s)  # noqa: E731
    v = {
        "autovc": random_variables(lambda: JV().init(
            K, z(1, 32, 80), z(1, 256), z(1, 256), z(1, 32, 257)), seed=1),
        "pos": random_variables(lambda: ja.Audio2landmarkPos().init(
            K, z(4, 18, 80), z(4, 256), z(1, 204), z(4, 128)), seed=2),
        "content": random_variables(lambda: ja.Audio2landmarkContent().init(
            K, z(4, 18, 80), z(1, 204)), seed=3),
        "generator": random_variables(lambda: JT(
            output_nc=3, ngf=8, n_blocks=3, div=3, disp=3).init(
            K, z(1, CS, CS, 3), z(1, CS, CS, 1), z(1, CS, CS, 1),
            z(1, CS, CS, 2), z(1, CS, CS, 2), z(1, CS, CS, 1)), seed=4),
        "flowunet": random_variables(lambda: JF(
            nf=4, num_scale=3, max_nf=64).init(K, z(1, 224, 224, 136)),
            seed=5),
        "modnet": random_variables(lambda: JM().init(K, z(1, CS, CS, 3)),
                                   seed=6),
        "photo2cartoon": random_variables(lambda: JP(ngf=8).init(
            K, z(1, CS, CS, 3)), seed=7),
    }
    paths = [os.path.join(mtcnn_dir, f"{n}.npy")
             for n in ("pnet", "rnet", "onet")]
    jpipe = JPipe(
        jmt.MTCNNDetector(jmt.load_pnet_params(paths[0]),
                          jmt.load_rnet_params(paths[1]),
                          jmt.load_onet_params(paths[2])),
        JL(v["pos"], v["content"]), JAudio(v["autovc"], chunk=512),
        JR(RendererVariables(generator=v["generator"],
                             flowunet=v["flowunet"], modnet=v["modnet"],
                             photo2cartoon=v["photo2cartoon"]),
           style="cartoon", ngf=8, n_blocks=3, div=3, disp=3, frame_batch=2,
           flowunet=JF(nf=4, num_scale=3, max_nf=64), cartoon_g=JP(ngf=8),
           output_uint8=True))

    nets = {
        "autovc": (AutoVCGenerator(), from_jax.autovc_state_dict),
        "pos": (Audio2landmarkPos(), from_jax.pos_state_dict),
        "content": (Audio2landmarkContent(), from_jax.content_state_dict),
        "generator": (TridentGeneratorFullIFW(output_nc=3, ngf=8, n_blocks=3,
                                              div=3, disp=3),
                      lambda x: from_jax.trident_state_dict(x, 3, 3, 3)),
        "flowunet": (FlowUnet(nf=4, num_scale=3, max_nf=64),
                     lambda x: from_jax.flowunet_state_dict(x, 3)),
        "modnet": (MODNet(), from_jax.modnet_state_dict),
        "photo2cartoon": (Photo2CartoonGenerator(ngf=8),
                          from_jax.photo2cartoon_state_dict),
    }
    for name, (net, convert) in nets.items():
        net.load_state_dict(convert(v[name]))
    detector = mtcnn.MTCNNDetector(mtcnn.load_pnet(paths[0]),
                                   mtcnn.load_rnet(paths[1]),
                                   mtcnn.load_onet(paths[2]), device="cpu")
    tpipe = build_pipeline({k: n for k, (n, _) in nets.items()}, "cpu",
                           frame_batch=2, output_uint8=True, style="cartoon",
                           detector=detector)
    return jpipe, tpipe


def test_detect_cartoon_slice_matches_jax(tmp_path):
    jpipe, tpipe = _pipelines(write_mtcnn_weights(str(tmp_path / "mtcnn")))
    photo = np.random.default_rng(0).uniform(0, 255, (200, 180, 3)).astype(
        np.uint8)
    wav = make_wav(1.0, seed=2)
    ref = jpipe(photo, wav, rng=np.random.default_rng(5))
    with torch.inference_mode():
        got = tpipe(photo, wav, rng=np.random.default_rng(5))
    T = ref.frames.shape[0]
    assert T == 45
    assert got.frames.shape == ref.frames.shape == (T, CS, CS, 3)
    assert got.frames.dtype == np.uint8
    assert list(got.stage_seconds) == ["detect", "align", "audio",
                                       "landmarks", "render"]
    # the same face, so the same crop: within one level of the bicubic
    assert np.abs(got.aligned_photo.astype(int)
                  - ref.aligned_photo.astype(int)).max() <= 1
    # the whole slice's bounds (tests/test_torch_pipeline.py:108-109)
    assert maxdiff(got.landmarks, ref.landmarks) <= 0.05
    assert psnr(got.frames, ref.frames, peak=255.0) >= 35.0
