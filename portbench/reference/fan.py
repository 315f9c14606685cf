"""The ``fan_awing_train`` configuration's weights, faces, batches and plain
reference step, and the comparison that decides ``correct``.

The reference step (``FANStep``) is one training step of the Adaptive
Wing FAN in plain ``torch``, fp32, over ``frozen/models/fan.py``: the
stacked hourglasses in training mode (every BatchNorm on the batch's
statistics, folding them into its running ones), the weighted Adaptive
Wing loss ``loss * (W weights + 1)`` averaged over each stack's 99 maps
and summed over the stacks, its gradient by autograd, and Adam
(torch.optim.Adam's update written out, ``reference/pose.py:Adam``). It
imports nothing of the port, and its comparison run sets TF32 off for
cuBLAS and cuDNN.

The batches: a smooth seeded image in [0, 1] a face, and the training
targets of a 98-point face in WFLW's layout (``face98``), jittered and
moved from the seed, by the frozen copy of the data loader's target
builder (``frozen/models/fan.py:fan_targets``).

``compare`` (``reference/pose.py:compare``) holds what the port's first
three steps left against the reference's from the same weights and
batches: each step's loss, the first step's gradient norm per leaf
(worst and median leaf), each leaf's change over the three steps, and
the BatchNorm running statistics after them."""
from __future__ import annotations

import numpy as np
import torch

from portbench import inputs
from portbench.reference.pose import Adam, compare  # noqa: F401

# the configuration's keys that ``FANTrainConfig`` takes
TRAINER_KEYS = ("lr", "loss_w", "num_modules", "num_landmarks")
# what the port's trainer implements, beyond those
SUPPORTED = {"hg_depth": 4, "features": 256, "end_relu": False,
             "in_channels": 3, "awing_omega": 14.0, "awing_theta": 0.5,
             "awing_epsilon": 1.0, "awing_alpha": 2.1, "beta1": 0.9,
             "beta2": 0.999, "heatmap_stride": 4}
LOSSES = ("loss",)
# the smooth image: box-filter passes over seeded uniform noise
SMOOTH_PASSES = 3
# the faces' spread: scale and centre as a share of the image, the
# rotation in degrees, the per-point jitter as a share of the image
FACE_SCALE = 0.3
FACE_TURN = 10.0
FACE_JITTER = 0.004


def check_config(cfg: dict) -> None:
    """Refuse a configuration outside what the port's trainer runs."""
    bad = {k: cfg.get(k) for k, v in SUPPORTED.items() if cfg.get(k) != v}
    if bad or cfg["num_landmarks"] != 98:
        raise ValueError(f"the FAN reference implements 98 landmarks and "
                         f"{SUPPORTED}, not {bad}")


def make_net(cfg: dict, device):
    """The reference's FAN on ``device``, unfilled."""
    from portbench.reference.frozen.models.fan import FAN

    check_config(cfg)
    with torch.device(device):
        return FAN(cfg["num_modules"], cfg["num_landmarks"],
                   end_relu=cfg["end_relu"])


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The FAN's state dict on ``device``, LeCun normal (each conv N(0,
    1 / fan_in), biases 0, BatchNorm scales 1 and shifts 0, statistics
    reset), from one draw of the seed's own generator."""
    net = inputs.fill_(make_net(cfg, device), inputs.sub_seed(seed, "fan"),
                       "lecun")
    return net.state_dict()


def _resample(pts: np.ndarray, n: int) -> np.ndarray:
    """``n`` points evenly spaced by arc length along the polyline
    ``pts``, its ends kept."""
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    at = np.concatenate([[0.0], np.cumsum(seg)])
    want = np.linspace(0.0, at[-1], n)
    return np.stack([np.interp(want, at, pts[:, k]) for k in (0, 1)], 1)


def _brow(upper: np.ndarray, thickness: float) -> np.ndarray:
    """WFLW's nine eyebrow points from the 68-point set's five along its
    upper edge: the upper edge resampled to five, then the lower edge, four
    points under its inner stretch, from the far end back."""
    top = _resample(upper, 5)
    lower = _resample(upper, 6)[1:5][::-1] + np.array([0.0, thickness])
    return np.concatenate([top, lower])


def _eye(ring: np.ndarray) -> np.ndarray:
    """WFLW's eight eye points from the 68-point set's six (corner, two
    upper, corner, two lower): the upper lid resampled to five from corner
    to corner, the lower lid's three inner points from the far corner
    back."""
    upper = _resample(ring[[0, 1, 2, 3]], 5)
    lower = _resample(ring[[3, 4, 5, 0]], 5)[1:4]
    return np.concatenate([upper, lower])


def face98() -> np.ndarray:
    """The 68-point standard face (the benchmark's assets) in WFLW's
    98-point layout, (x, y) in the face's own units: the contour resampled
    along its arc length from 17 points to 33, each eyebrow's five to
    nine (``_brow``), the nose as it is, each eye's six to eight
    (``_eye``), the lips as they are, and the two pupils, each eye's
    centre."""
    from portbench.reference.frozen.utils.assets import std_face_landmarks

    p = std_face_landmarks()[:, :2] - np.array([0.0, 0.45])
    thick = 0.3 * float(np.linalg.norm(p[21] - p[17])) / 4
    parts = [_resample(p[0:17], 33), _brow(p[17:22], thick),
             _brow(p[22:27], thick), p[27:31], p[31:36],
             _eye(p[36:42]), _eye(p[42:48]), p[48:60], p[60:68],
             p[36:42].mean(0, keepdims=True),
             p[42:48].mean(0, keepdims=True)]
    return np.concatenate(parts).astype(np.float64)


def face_landmarks98(rng: np.random.Generator, size: int) -> np.ndarray:
    """A 98-point face (x, y) in pixels of a size^2 image: ``face98``
    turned, scaled and moved, each point jittered."""
    base = face98()
    t = np.deg2rad(rng.uniform(-FACE_TURN, FACE_TURN))
    rot = np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]])
    scale = size * FACE_SCALE * rng.uniform(0.9, 1.1)
    centre = size * (np.array([0.5, 0.55]) + rng.uniform(-0.03, 0.03, 2))
    return (centre + scale * base @ rot.T
            + rng.normal(0, size * FACE_JITTER, base.shape)
            ).astype(np.float32)


def make_batches(cfg: dict, seed: int, n: int, device) -> list[dict]:
    """``n`` resident batches of ``batch_size`` faces, each batch from its
    own seed: ``images`` (N, 3, S, S), a smooth image in [0, 1]; ``gt``
    and ``weights`` (N, 99, S/4, S/4), the training targets of the faces
    (``face_landmarks98``)."""
    from portbench.reference.frozen.models.fan import fan_targets

    s, k = cfg["size"], cfg["batch_size"]
    hm = s // cfg["heatmap_stride"]
    out = []
    for i in range(n):
        rng = np.random.default_rng(inputs.sub_seed(seed, f"fan_batch{i}"))
        img = rng.uniform(0, 1, (k, 3, s, s)).astype(np.float32)
        for _ in range(SMOOTH_PASSES):
            img = (img + np.roll(img, 1, 2) + np.roll(img, 1, 3)) / 3
        lms = np.stack([face_landmarks98(rng, s) for _ in range(k)])
        targets = [fan_targets(lm, hm) for lm in lms]
        arrays = (("images", img),
                  ("gt", np.stack([t[0] for t in targets])),
                  ("weights", np.stack([t[1] for t in targets])))
        out.append({name: torch.as_tensor(
            np.ascontiguousarray(a, dtype=np.float32), device=device)
            for name, a in arrays})
    return out


def batch_args(batch: dict) -> tuple:
    """A batch as the trainers' ``step`` takes it."""
    return batch["images"], batch["gt"], batch["weights"]


class FANStep:
    """The reference step over ``net`` (``make_net``, weights loaded):
    ``losses`` -> {"loss"}; ``step(images, gt, weights)`` also leaves the
    gradients in ``.grad`` and applies Adam, as the port's
    ``FANTrainer.step``."""

    def __init__(self, cfg: dict, net):
        check_config(cfg)
        self.cfg = cfg
        self.model = net.train()
        self.adam = Adam(net.parameters(), cfg["lr"], cfg["beta1"],
                         cfg["beta2"], 0.0)

    def losses(self, images, gt, weights) -> dict:
        from portbench.reference.frozen.models.fan import adaptive_wing_map

        cfg = self.cfg
        outputs, _ = self.model(images)
        scale = weights * cfg["loss_w"] + 1.0
        loss = sum(torch.mean(adaptive_wing_map(
            pred, gt, cfg["awing_omega"], cfg["awing_theta"],
            cfg["awing_epsilon"], cfg["awing_alpha"]) * scale)
            for pred in outputs)
        return {"loss": loss}

    def step(self, images, gt, weights) -> dict:
        m = self.losses(images, gt, weights)
        params = list(self.model.parameters())
        grads = torch.autograd.grad(m["loss"], params)
        for p, g in zip(params, grads):
            p.grad = g
        self.adam.step(grads)
        return {k: v.detach() for k, v in m.items()}


def running_stats(net) -> dict:
    """Every BatchNorm statistic of the net, by name, on the host."""
    return {k: b.detach().double().cpu() for k, b in net.named_buffers()}


def run_steps(step, net, batches: list, n: int) -> dict:
    """``n`` steps of ``step`` (the port's trainer or ``FANStep``) over
    ``batches``: each step's loss, the first step's gradient norm per leaf
    (from ``.grad``), each leaf's change, the running statistics."""
    start = {k: p.detach().clone() for k, p in net.named_parameters()}
    losses, grad1 = [], None
    for i in range(n):
        m = step.step(*batch_args(batches[i]))
        losses.append({k: float(m[k]) for k in LOSSES})
        if i == 0:
            grad1 = {k: float(p.grad.norm())
                     for k, p in net.named_parameters()}
    change = {k: float((p.detach() - start[k]).norm())
              for k, p in net.named_parameters()}
    return {"losses": losses, "grad1": grad1, "change": change,
            "stats": running_stats(net)}


def reference_steps(cfg: dict, seed: int, batches: list, device,
                    n: int = 3) -> dict:
    """The reference's first ``n`` steps from the seed's weights, in fp32
    with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = make_net(cfg, device)
    net.load_state_dict(make_weights(cfg, seed, device))
    return run_steps(FANStep(cfg, net), net, batches, n)
