"""The benchmark's inputs, all made from ``--seed``: synthetic speech and
its WAV file, a synthetic face photo and its baseline JPEG, and every
net's weights (made on the device in one draw a net; the drawing
configuration writes them as the checkpoints the port's CLI loads). Frozen copies of the port's makers
(``utils/smoke.py:make_wav``, ``write_mtcnn_weights``, the portrait of
``write_umlvd_tree``), so that a later change to the port cannot change
the benchmark's inputs."""
from __future__ import annotations

import math
import wave
import zlib

import numpy as np
import torch
import torch.nn as nn

SR = 16000
# the bias toward "face" on each MTCNN classifier head: with random
# weights alone p(face) ~ 0.5 swings with the sign of a random projection,
# and on some photos no window passes all three of MTCNN's thresholds
# (0.6, 0.7, 0.8), so the clip fails. At +3 / -3 every window's p(face) is
# ~0.99: the cascade keeps as many candidates as its capacities allow, and
# no clip fails.
MTCNN_FACE_BIAS = 3.0


def sub_seed(seed: int, name: str) -> int:
    """A seed of its own for each input and net, from the run's seed."""
    return (int(seed) * 1_000_003 + zlib.crc32(name.encode())) % (2 ** 62)


def make_wav(seconds: float, seed: int) -> np.ndarray:
    """Speech-band synthetic audio at 16 kHz: a wandering 110-210 Hz buzz
    with harmonics and amplitude modulation."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(round(SR * seconds))) / SR
    f0 = 160 + 50 * np.sin(2 * np.pi * 0.7 * t + rng.uniform(0, 6))
    ph = 2 * np.pi * np.cumsum(f0) / SR
    x = sum(np.sin(h * ph) / h for h in range(1, 6))
    am = 0.55 + 0.45 * np.sin(2 * np.pi * 1.3 * t + rng.uniform(0, 6))
    x = x * am + 0.01 * rng.standard_normal(t.shape)
    return (0.3 * x / np.abs(x).max()).astype(np.float64)


def write_wav(path: str, wav: np.ndarray) -> str:
    """Float samples in [-1, 1) -> 16-bit mono PCM WAV."""
    pcm = np.clip(np.round(wav * 32767.0), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(pcm.tobytes())
    return path


def face_landmarks(rng: np.random.Generator, size: int) -> np.ndarray:
    """A face-like 68-point set (x, y) in pixels of a size^2 image."""
    from portbench.reference.frozen.utils.assets import std_face_landmarks

    base = std_face_landmarks()[:, :2] - np.array([0.0, 0.45])
    base[[55, 56, 57, 58, 59, 65, 66, 67], 1] += rng.uniform(0.08, 0.2)
    base[[60, 64], 0] *= 0.9
    scale = size * 0.3 * rng.uniform(0.9, 1.1)
    centre = size * (np.array([0.5, 0.55]) + rng.uniform(-0.03, 0.03, 2))
    return (centre + scale * base
            + rng.normal(0, size * 0.004, base.shape)).astype(np.float32)


def _region(lm: np.ndarray, size: int, idx: slice, pad: float
            ) -> np.ndarray:
    """A filled ellipse over the bounding box of ``lm[idx]`` widened by
    ``pad`` pixels, in {0, 1}."""
    pts = lm[idx]
    (x0, y0), (x1, y1) = pts.min(0) - pad, pts.max(0) + pad
    y, x = np.mgrid[0:size, 0:size] + 0.5
    return ((((x - (x0 + x1) / 2) / max((x1 - x0) / 2, 1)) ** 2
             + ((y - (y0 + y1) / 2) / max((y1 - y0) / 2, 1)) ** 2)
            <= 1).astype(np.float64)


def face_photo(seed: int, size: int = 512) -> np.ndarray:
    """A synthetic portrait, BGR uint8 (size, size, 3): colour ramps, a
    bright face oval, darker eyes and lips, and noise."""
    rng = np.random.default_rng(seed)
    lm = face_landmarks(rng, size)
    y, x = np.mgrid[0:size, 0:size] / size
    tint = rng.uniform(0.5, 1.5, 3)
    img = np.stack([90 + 80 * x * tint[0], 70 + 90 * y * tint[1],
                    110 + 50 * np.sin(6 * x * y * tint[2])], -1)
    for idx, gain in ((slice(0, 68), 70.0), (slice(36, 48), -60.0),
                      (slice(48, 68), -50.0)):
        img += gain * _region(lm, size, idx, size * 0.02)[..., None]
    img += rng.normal(0, 8, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_jpeg(path: str, img_bgr: np.ndarray, quality: int) -> str:
    """A baseline JPEG (4:2:0, as ``cv2.imwrite`` writes it) of a BGR
    image, by the frozen copy of the port's encoder."""
    from portbench.reference.frozen.utils.jpeg import encode_jpeg

    with open(path, "wb") as f:
        f.write(encode_jpeg(img_bgr, quality))
    return path


# --- weights ------------------------------------------------------------

_LINEAR = (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear)
_NORMS = (nn.BatchNorm1d, nn.BatchNorm2d, nn.GroupNorm, nn.InstanceNorm2d)


def _fan_in(t: torch.Tensor) -> int:
    return nn.init._calculate_fan_in_and_fan_out(t)[0]


def _leaf_rule(module: nn.Module, name: str, t: torch.Tensor, rule: str):
    """How one leaf is filled: ("normal", std, mean) or ("const", value),
    or None to keep it."""
    if not t.is_floating_point() or name in module._non_persistent_buffers_set:
        return None
    if name == "running_var":
        return ("const", 1.0)
    if name == "running_mean":
        return ("const", 0.0)
    if rule == "smoke":
        # utils/smoke.py:init_random_: norm scales 1, biases 0, else
        # N(0, 0.05^2)
        if isinstance(module, _NORMS) and name == "weight":
            return ("const", 1.0)
        if name == "bias":
            return ("const", 0.0)
        return ("normal", 0.05, 0.0)
    if rule == "gan_normal":
        # models/gan.py:init_weights("normal", 0.02)
        if isinstance(module, _LINEAR):
            return ("normal", 0.02, 0.0) if name == "weight" else (
                "const", 0.0)
        if isinstance(module, _NORMS):
            return ("normal", 0.02, 1.0) if name == "weight" else (
                "const", 0.0)
    if rule == "lecun":
        # train/module2.py:_lecun_init_: N(0, 1/fan_in), biases 0, norms
        # reset, PReLU slopes 0.25
        if isinstance(module, _LINEAR):
            return ("normal", 1.0 / math.sqrt(_fan_in(t)), 0.0) \
                if name == "weight" else ("const", 0.0)
        if isinstance(module, _NORMS):
            return ("const", 1.0 if name == "weight" else 0.0)
        if isinstance(module, nn.PReLU):
            return ("const", 0.25)
    raise ValueError(f"no {rule!r} rule for {type(module).__name__}.{name}")


@torch.no_grad()
def fill_(net: nn.Module, seed: int, rule: str) -> nn.Module:
    """Fill every floating leaf of ``net`` (on its device) by ``rule``
    from one draw of a generator on that device seeded with ``seed``."""
    leaves = []
    for m in net.modules():
        for name, t in (list(m.named_parameters(recurse=False))
                        + list(m.named_buffers(recurse=False))):
            how = _leaf_rule(m, name, t, rule)
            if how is not None:
                leaves.append((t, how))
    dev = leaves[0][0].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = sum(t.numel() for t, how in leaves if how[0] == "normal")
    draws = torch.randn(n, generator=gen, device=dev)
    at = 0
    for t, (kind, *args) in leaves:
        if kind == "const":
            t.fill_(args[0])
        else:
            t.copy_(draws[at:at + t.numel()].view(t.shape) * args[0]
                    + args[1])
            at += t.numel()
    return net


def build(ctor, seed: int, rule: str, device) -> nn.Module:
    """A frozen-reference net made on ``device`` and filled by ``rule``."""
    with torch.device(device):
        net = ctor()
    return fill_(net, seed, rule).eval()
