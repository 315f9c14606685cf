"""Inputs and weights for smoke runs of the slice (no checkpoints needed):
the fixed-box stub detector and the synthetic speech WAV that the JAX
package's ``bench.py:bench_e2e`` uses, seeded random weights, seeded
random MTCNN weights biased to detect faces, and a seeded synthetic
UMLVD-IFW training tree (``write_umlvd_tree``)."""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn as nn


class StubDetector:
    """Fixed face box + 5-point landmarks for any image (detection runs
    once per photo and is not part of the per-frame work)."""

    def __call__(self, img_rgb: np.ndarray):
        h, w = img_rgb.shape[:2]
        box = np.array([[w * 0.25, h * 0.25, w * 0.75, h * 0.80, 0.99]])
        cx, cy = w * 0.5, h * 0.5
        xs = [cx - w * 0.12, cx + w * 0.12, cx, cx - w * 0.08, cx + w * 0.08]
        ys = [cy - h * 0.08, cy - h * 0.08, cy, cy + h * 0.12, cy + h * 0.12]
        return box, np.array([xs + ys])


def make_wav(seconds: float, seed: int = 0) -> np.ndarray:
    """Speech-band synthetic audio at 16 kHz: a wandering 110-210 Hz buzz
    with harmonics and amplitude modulation (keeps the f0 path busy)."""
    sr = 16000
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    f0 = 160 + 50 * np.sin(2 * np.pi * 0.7 * t + rng.uniform(0, 6))
    ph = 2 * np.pi * np.cumsum(f0) / sr
    x = sum(np.sin(h * ph) / h for h in range(1, 6))
    am = 0.55 + 0.45 * np.sin(2 * np.pi * 1.3 * t + rng.uniform(0, 6))
    x = x * am + 0.01 * rng.standard_normal(t.shape)
    return (0.3 * x / np.abs(x).max()).astype(np.float64)


_NORMS = (nn.BatchNorm1d, nn.BatchNorm2d, nn.GroupNorm)


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator
                 ) -> nn.Module:
    """Fill a module's weights in place from ``generator``, like the JAX
    package's ``utils.smoke.random_variables``: norm scales and running
    variances 1, biases and running means 0, every other weight
    N(0, 0.05^2). Numerically tame, not init-faithful."""
    for m in module.modules():
        for name, t in list(m.named_parameters(recurse=False)) + list(
                m.named_buffers(recurse=False)):
            if (not t.is_floating_point()
                    or name in m._non_persistent_buffers_set):
                continue   # counters and derived tables (the PE table)
            if (isinstance(m, _NORMS) and name == "weight") or (
                    name == "running_var"):
                t.fill_(1.0)
            elif name in ("bias", "running_mean"):
                t.zero_()
            else:
                t.copy_(torch.randn(t.shape, generator=generator,
                                    dtype=t.dtype, device="cpu") * 0.05)
    return module


def full_width_nets(seed: int = 0, style: str = "drawing"
                    ) -> dict[str, nn.Module]:
    """The slice's nets at full width with seeded random weights, on the
    CPU: AutoVC, both landmark branches, the trident generator (ngf 64,
    9 blocks, div 3, disp 3; output_nc 1 for drawing, 3 for cartoon),
    FlowUnet, MODNet, the static net of the style (the drawing net,
    ``static_g``, or Photo2Cartoon ngf 32, ``photo2cartoon``) and the
    speaker encoder. With style "drawing" these are the nets of the
    configuration ``bench.py:bench_e2e`` times."""
    from animateportrait_tpu_torch.models.audio2landmark import (
        Audio2landmarkContent, Audio2landmarkPos)
    from animateportrait_tpu_torch.models.autovc import AutoVCGenerator
    from animateportrait_tpu_torch.models.flowunet import FlowUnet
    from animateportrait_tpu_torch.models.gan import (
        ResnetStyle2Generator, TridentGeneratorFullIFW)
    from animateportrait_tpu_torch.models.modnet import MODNet
    from animateportrait_tpu_torch.models.photo2cartoon import (
        Photo2CartoonGenerator)
    from animateportrait_tpu_torch.models.speaker_encoder import VoiceEncoder

    g = torch.Generator().manual_seed(seed)
    nets = {
        "autovc": AutoVCGenerator(),
        "pos": Audio2landmarkPos(),
        "content": Audio2landmarkContent(),
        "generator": TridentGeneratorFullIFW(
            output_nc=1 if style == "drawing" else 3, ngf=64, n_blocks=9,
            div=3, disp=3),
        "flowunet": FlowUnet(),
        "modnet": MODNet(),
        "voice_encoder": VoiceEncoder(),
    }
    if style == "drawing":
        nets["static_g"] = ResnetStyle2Generator()
    else:
        nets["photo2cartoon"] = Photo2CartoonGenerator(ngf=32)
    for net in nets.values():
        init_random_(net, g).eval()
    return nets


# gain on the random weights of each MTCNN classifier head: it spreads the
# face logit over about +-1 across an image. Without it every cell scores
# within a few fp32 ulps of the next, score ties decide which boxes NMS
# keeps, and two correct implementations keep different boxes.
_MTCNN_HEAD_GAIN = 100.0


def write_mtcnn_weights(directory: str, seed: int = 0,
                        face_bias: float = 1.25) -> str:
    """Seeded random ``pnet/rnet/onet.npy`` in the reference format (a
    pickled {key: array} dict each) under ``directory``. Each classifier
    head (``conv4_1``/``conv5_1``/``conv6_1``) gets its weights scaled by
    ``_MTCNN_HEAD_GAIN`` and +face_bias on the face logit, -face_bias on
    the other: random weights alone give p(face) ~ 0.5, under the
    0.6/0.7/0.8 thresholds, and nothing would be detected."""
    from animateportrait_tpu_torch.models.mtcnn import ONet, PNet, RNet

    os.makedirs(directory, exist_ok=True)
    g = torch.Generator().manual_seed(seed)
    for name, net, head in (("pnet", PNet(), "conv4_1"),
                            ("rnet", RNet(), "conv5_1"),
                            ("onet", ONet(), "conv6_1")):
        sd = {k: v.numpy().copy()
              for k, v in init_random_(net, g).state_dict().items()}
        sd[f"{head}.weight"] *= _MTCNN_HEAD_GAIN
        sd[f"{head}.bias"] += np.float32([-face_bias, face_bias])
        np.save(os.path.join(directory, f"{name}.npy"), sd,
                allow_pickle=True)
    return directory


def build_pipeline(nets: dict[str, nn.Module], device: torch.device | str,
                   frame_batch: int = 8, output_uint8: bool = True,
                   style: str = "drawing", detector=None,
                   use_bf16: bool = False):
    """The slice's ``TalkingPortraitPipeline`` on ``device``: ``detector``
    (the fixed-box stub when None), ``AudioPipeline(chunk=512)`` without a
    voice encoder, default landmark amplifiers, and the renderer of
    ``style`` (the static net ``nets["static_g"]`` for drawing,
    ``nets["photo2cartoon"]`` for cartoon), its per-frame nets in bf16 with
    ``use_bf16`` (``--render_bf16``)."""
    from animateportrait_tpu_torch.pipeline.audio import AudioPipeline
    from animateportrait_tpu_torch.pipeline.end2end import (
        TalkingPortraitPipeline)
    from animateportrait_tpu_torch.pipeline.landmark import LandmarkPredictor
    from animateportrait_tpu_torch.pipeline.render import Module2Renderer

    return TalkingPortraitPipeline(
        detector or StubDetector(),
        LandmarkPredictor(nets["pos"], nets["content"], device=device),
        AudioPipeline(nets["autovc"], chunk=512, device=device),
        Module2Renderer(nets["generator"], nets["flowunet"], nets["modnet"],
                        nets.get("static_g"), frame_batch=frame_batch,
                        output_uint8=output_uint8, device=device,
                        style=style, cartoon_g=nets.get("photo2cartoon"),
                        use_bf16=use_bf16))


def _face_landmarks(rng: np.random.Generator, size: int) -> np.ndarray:
    """A face-like 68-point set (x, y) in pixels of a size^2 image: the
    canonical face shape, scaled to about half the image, shifted and
    jittered. Its points span two dimensions, so never all collinear."""
    from animateportrait_tpu_torch.utils.assets import std_face_landmarks

    base = std_face_landmarks()[:, :2] - np.array([0.0, 0.45])
    # the canonical mouth is closed (inner-lip points 61-63 on 67-65, the
    # inner corners next to the outer ones); open it as in speech, so no
    # two points coincide
    base[[55, 56, 57, 58, 59, 65, 66, 67], 1] += rng.uniform(0.08, 0.2)
    base[[60, 64], 0] *= 0.9
    scale = size * 0.3 * rng.uniform(0.9, 1.1)
    centre = size * (np.array([0.5, 0.55]) + rng.uniform(-0.03, 0.03, 2))
    lm = centre + scale * base + rng.normal(0, size * 0.004, base.shape)
    return lm.astype(np.float32)


def _region_mask(lm: np.ndarray, size: int, idx: slice,
                 pad: float) -> np.ndarray:
    """A filled ellipse over the bounding box of ``lm[idx]`` widened by
    ``pad`` pixels, as 0/255 uint8."""
    pts = lm[idx]
    (x0, y0), (x1, y1) = pts.min(0) - pad, pts.max(0) + pad
    y, x = np.mgrid[0:size, 0:size] + 0.5
    inside = (((x - (x0 + x1) / 2) / max((x1 - x0) / 2, 1)) ** 2
              + ((y - (y0 + y1) / 2) / max((y1 - y0) / 2, 1)) ** 2) <= 1
    return inside.astype(np.uint8) * 255


def _portrait(rng: np.random.Generator, lm: np.ndarray, size: int,
              gray: bool) -> np.ndarray:
    """A synthetic portrait: colour ramps, a bright face oval around the
    landmarks, darker eyes and lips, and seeded noise (which keeps the
    PNG's rows incompressible, as photos are)."""
    y, x = np.mgrid[0:size, 0:size] / size
    tint = rng.uniform(0.5, 1.5, 3)
    img = np.stack([90 + 80 * x * tint[0], 70 + 90 * y * tint[1],
                    110 + 50 * np.sin(6 * x * y * tint[2])], -1)
    for idx, gain in ((slice(0, 68), 70.0), (slice(36, 48), -60.0),
                      (slice(48, 68), -50.0)):
        img += gain * (_region_mask(lm, size, idx, size * 0.02)[..., None]
                       / 255.0)
    img += rng.normal(0, 8, img.shape)
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img.mean(2).astype(np.uint8)[..., None].repeat(3, 2) \
        if gray else img


def write_umlvd_tree(root: str, n_photos: int = 3, n_styles: int = 3,
                     clips: int = 1, frames: int = 3, size: int = 128,
                     seed: int = 0, png_filter: int = 1) -> str:
    """A seeded synthetic training tree in the reference's UMLVD-IFW layout
    under ``root``, written with ``utils/image.py:write_png`` with every
    row filtered by ``png_filter``: ``n_photos`` RGB photos (``Photo``,
    their landmark dot images ``Alm/MTCNN``, 68-point txts
    ``Alm_txt/MTCNN``, nose/eyes/lips masks ``Amask/*`` and static
    stylizations ``fakeB_static``), ``n_styles`` style images
    (``Drawing``, ``Blm``, ``Blm_txt``, ``Bmask``), and ``clips`` film
    clips of ``frames`` frames (``Drawing/scanner_frag_<k>_MTCNN`` with
    their ``_win.txt`` face windows). Images are size^2; style images are
    gray-toned RGB; zlib level 1. Returns ``root``."""
    from animateportrait_tpu_torch.utils.image import draw_dots, write_png

    rng = np.random.default_rng(seed)
    parts = (("nose", slice(27, 36)), ("eyes", slice(36, 48)),
             ("lips", slice(48, 68)))

    def put(rel: str, img: np.ndarray) -> None:
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_png(path, img, png_filter=png_filter, level=1)

    def put_txt(rel: str, rows) -> None:
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.writelines(" ".join(repr(float(v)) for v in r) + "\n"
                         for r in rows)

    def group(kind: str, rel: str, gray: bool) -> np.ndarray:
        lm = _face_landmarks(rng, size)
        src = "Photo" if kind == "A" else "Drawing"
        put(f"{src}/{rel}.png", _portrait(rng, lm, size, gray))
        dots = draw_dots(lm, size)[..., 0]
        put(f"{kind}lm/MTCNN/{rel}.png", ((dots + 1) * 127.5).astype(
            np.uint8))
        put_txt(f"{kind}lm_txt/MTCNN/{rel}.txt", lm)
        for part, idx in parts:
            put(f"{kind}mask/{part}/{rel}.png",
                _region_mask(lm, size, idx, size * 0.01))
        return lm

    for i in range(n_photos):
        lm = group("A", f"a{i}", gray=False)
        put(f"fakeB_static/a{i}.png", _portrait(rng, lm, size, gray=True))
    for i in range(n_styles):
        group("B", f"b{i}", gray=True)
    for k in range(clips):
        for j in range(frames):
            rel = f"scanner_frag_{k}_MTCNN/f{j}"
            lm = group("B", rel, gray=True)
            (x0, y0), (x1, y1) = lm.min(0), lm.max(0)
            put_txt(f"Blm_txt/MTCNN/{rel}_win.txt", [[x0, x1, y0, y1]])
    return root
