"""Inputs and weights for smoke runs of the slice (no checkpoints needed):
the fixed-box stub detector and the synthetic speech WAV that the JAX
package's ``bench.py:bench_e2e`` uses, and seeded random weights."""
from __future__ import annotations

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


def full_width_nets(seed: int = 0) -> dict[str, nn.Module]:
    """The slice's nets at full width with seeded random weights, on the
    CPU: AutoVC, both landmark branches, the trident generator
    (output_nc 1, ngf 64, 9 blocks, div 3, disp 3), FlowUnet, MODNet and
    the drawing-style static net — the configuration ``bench.py:bench_e2e``
    times."""
    from animateportrait_tpu_torch.models.audio2landmark import (
        Audio2landmarkContent, Audio2landmarkPos)
    from animateportrait_tpu_torch.models.autovc import AutoVCGenerator
    from animateportrait_tpu_torch.models.flowunet import FlowUnet
    from animateportrait_tpu_torch.models.gan import (
        ResnetStyle2Generator, TridentGeneratorFullIFW)
    from animateportrait_tpu_torch.models.modnet import MODNet

    g = torch.Generator().manual_seed(seed)
    nets = {
        "autovc": AutoVCGenerator(),
        "pos": Audio2landmarkPos(),
        "content": Audio2landmarkContent(),
        "generator": TridentGeneratorFullIFW(output_nc=1, ngf=64, n_blocks=9,
                                             div=3, disp=3),
        "flowunet": FlowUnet(),
        "modnet": MODNet(),
        "static_g": ResnetStyle2Generator(),
    }
    for net in nets.values():
        init_random_(net, g).eval()
    return nets


def build_pipeline(nets: dict[str, nn.Module], device: torch.device | str,
                   frame_batch: int = 8, output_uint8: bool = True):
    """The slice's ``TalkingPortraitPipeline`` on ``device``: stub
    detector, ``AudioPipeline(chunk=512)`` without a voice encoder, default
    landmark amplifiers, drawing-style renderer."""
    from animateportrait_tpu_torch.pipeline.audio import AudioPipeline
    from animateportrait_tpu_torch.pipeline.end2end import (
        TalkingPortraitPipeline)
    from animateportrait_tpu_torch.pipeline.landmark import LandmarkPredictor
    from animateportrait_tpu_torch.pipeline.render import Module2Renderer

    return TalkingPortraitPipeline(
        StubDetector(),
        LandmarkPredictor(nets["pos"], nets["content"], device=device),
        AudioPipeline(nets["autovc"], chunk=512, device=device),
        Module2Renderer(nets["generator"], nets["flowunet"], nets["modnet"],
                        nets["static_g"], frame_batch=frame_batch,
                        output_uint8=output_uint8, device=device))
