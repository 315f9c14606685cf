"""Convergence runs of the ported Module1-side trainers: short overfit runs
on synthetic but coherent data, the port of the JAX package's
``tools/module1_convergence.py`` with its seven runs, on the same data
built from the same numpy seeds and with the same table of first and last
metrics:

- content branch (``train/module1.py``): audio windows whose energy opens
  the mouth;
- speaker-aware branch: the same audio with a head-pose trajectory for
  the quaternion + translation head;
- face_of_art heatmap net (``train/face_of_art.py``): four rendered face
  blobs, the argmax-decode NME before and after ``train_foa``;
- flow regression (``train/flow_regression.py``): keypoint pairs with a
  constant flow, masked EPE;
- image translation (``train/image_translation.py``): ResUnet + VGG on
  landmark-dot images -> rendered faces, L1;
- pose transfer (``train/pose_transfer.py``): shifted-appearance pairs, L1
  and PSNR;
- FAN/AWing (``train/fan.py``): the rendered blobs, the argmax-decode NME
  of ``evaluate_fan`` before and after the weighted-AWing steps.

Weights are torch's default init drawn under a fixed seed; ``weights`` (a
state dict per net) replaces them, as the tests do with the JAX tool's own
initial weights.

    python -m animateportrait_tpu_torch.train.convergence [--steps N]
        [--md out.md] [--only content,speaker,foa,flow,imtrans,pose,fan]
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys
from typing import Callable

import numpy as np
import torch

from animateportrait_tpu_torch.utils.assets import std_face_landmarks
from animateportrait_tpu_torch.utils.device import (
    DEFAULT_DEVICE, resolve_device)

RUNS = ("content", "speaker", "foa", "flow", "imtrans", "pose", "fan")


def _window(sig: np.ndarray, w: int) -> np.ndarray:
    """(T + w, d) -> (T, w, d) stride-1 windows."""
    return np.stack([sig[i:i + w] for i in range(sig.shape[0] - w)])


def audio_landmark_signals(n_frames: int, seed: int = 0):
    """A coherent audio/landmark pair of ``n_frames`` frames: the audio
    energy e(t) opens the mouth. (au (n,80), fls (n,204), face_id (1,204),
    e (n,)), float64."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_frames, dtype=np.float64)
    e = 0.5 + 0.5 * np.sin(2 * np.pi * t / 25.0)
    au = (e[:, None] * np.abs(np.sin(np.linspace(0, np.pi, 80)))[None, :]
          + 0.05 * rng.standard_normal((n_frames, 80)))
    std = std_face_landmarks().reshape(68, 3)
    fls = np.tile(std.reshape(1, 204), (n_frames, 1))
    for i in (55, 56, 57, 58, 59, 65, 66, 67):     # the lower lip's y
        fls[:, 3 * i + 1] += 0.08 * e
    return au, fls, std.reshape(1, 204).astype(np.float32), e


def synth_audio_landmarks(T: int = 140, w: int = 18, seed: int = 0):
    """The JAX tool's windows: (aus (T,w,80), fls (T,w,204), face_id
    (1,204), e (T,)) of a (T + w)-frame pair."""
    au, fls, face_id, e = audio_landmark_signals(T + w, seed)
    return (_window(au, w).astype(np.float32),
            _window(fls, w).astype(np.float32), face_id, e[:T])


def speaker_pose_targets(T: int):
    """The speaker-aware run's embeddings and head pose: (embs (T,256),
    rot_quat (T,4), rot_trans (T,3,4)), a slow yaw sine."""
    rng = np.random.default_rng(1)
    embs = np.tile(rng.standard_normal((1, 256)).astype(np.float32) * 0.1,
                   (T, 1))
    yaw = 0.1 * np.sin(2 * np.pi * np.arange(T) / 60.0)
    rot_quat = np.stack([np.cos(yaw / 2), np.zeros(T), np.sin(yaw / 2),
                         np.zeros(T)], 1).astype(np.float32)
    rot_trans = np.zeros((T, 3, 4), np.float32)
    rot_trans[:, 0, 3] = 5.0 * yaw
    return embs, rot_quat, rot_trans


def render_face(lms_yx: np.ndarray, size: int) -> np.ndarray:
    """A shaded blob with dark strokes at the landmarks, (size, size, 3)
    float32 in [0, 1]."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    c = lms_yx.mean(0)
    img = 0.8 * np.exp(-(((yy - c[0]) / (size * 0.4)) ** 2
                         + ((xx - c[1]) / (size * 0.33)) ** 2))
    for y, x in lms_yx:
        img += -0.6 * np.exp(-(((yy - y) ** 2 + (xx - x) ** 2)
                               / (2 * 1.5 ** 2)))
    img = np.clip(img + 0.1, 0, 1)
    return np.repeat(img[..., None], 3, axis=2).astype(np.float32)


def flow_batch():
    """kp1, kp2 (4,68,2), flow_gt (4,224,224,2), vis_gt (4,224,224): four
    rigid shifts of a keypoint ring, every pixel visible."""
    theta = np.linspace(0, 2 * np.pi, 68, endpoint=False)
    base = np.stack([112 + 52 * np.cos(theta), 112 + 48 * np.sin(theta)],
                    -1).astype(np.float32)
    shifts = np.array([[6, 0], [0, 6], [-5, 4], [4, -5]], np.float32)
    kp1 = np.tile(base[None], (4, 1, 1))
    kp2 = kp1 + shifts[:, None, :]
    flow_gt = np.tile(shifts[:, None, None, :], (1, 224, 224, 1))
    return kp1, kp2, flow_gt, np.ones((4, 224, 224), np.int32)


def blob_faces(size: int = 64) -> tuple[np.ndarray, np.ndarray]:
    """The face_of_art and FAN runs' data: four rendered faces (4, size,
    size, 3) at jittered landmarks (4, 68, 2) (y, x)."""
    rng = np.random.default_rng(0)
    base = std_face_landmarks().reshape(68, 3)[:, :2]
    base = base - base.min(0)
    base = base / base.max() * (0.55 * size) + 0.22 * size
    base = base[:, ::-1]
    lms = [base + rng.uniform(-2, 2, (68, 2)) for _ in range(4)]
    return np.stack([render_face(lm, size) for lm in lms]), np.stack(lms)


def image_translation_batch(size: int = 64):
    """(image_in (4,size,size,6), image_out (4,size,size,3)) in [-1, 1]:
    landmark dots + the static face -> the face at the jittered
    landmarks."""
    rng = np.random.default_rng(0)
    base = std_face_landmarks().reshape(68, 3)[:, :2]
    base = base - base.min(0)
    base = base / base.max() * (0.55 * size) + 0.22 * size
    base = base[:, ::-1]
    ins, outs = [], []
    for _ in range(4):
        lms = base + rng.uniform(-2, 2, (68, 2))
        dots = np.zeros((size, size, 3), np.float32)
        iy = np.clip(lms[:, 0].astype(int), 0, size - 1)
        ix = np.clip(lms[:, 1].astype(int), 0, size - 1)
        dots[iy, ix] = 1.0
        ins.append(np.concatenate([dots, render_face(base, size)], -1))
        outs.append(render_face(lms, size))
    return np.stack(ins) * 2 - 1, np.stack(outs) * 2 - 1


def pose_batch(n: int = 4, s: int = 32, j: int = 6) -> dict:
    """img_1 (smoothed noise), img_2 = img_1 rolled down by dy (2, -2, 4,
    0, repeated), and the keypoints moved by the same dy."""
    rng = np.random.default_rng(0)
    img1 = rng.uniform(-1, 1, (n, s, s, 3)).astype(np.float32)
    for _ in range(2):
        img1 = (img1 + np.roll(img1, 1, 1) + np.roll(img1, 1, 2)) / 3.0
    dy = np.resize(np.array([2, -2, 4, 0]), n)
    img2 = np.stack([np.roll(img1[i], dy[i], axis=0) for i in range(n)])
    kp1 = rng.uniform(8, s - 8, (n, j, 2)).astype(np.float32)
    kp2 = kp1 + np.stack([dy, np.zeros(n)], -1)[:, None, :]
    return {"img_1": img1, "img_2": img2, "kp_1": kp1,
            "kp_2": kp2.astype(np.float32)}


def _nchw(x: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev).permute(
        0, 3, 1, 2).contiguous()


def _t(x: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def seeded(make: Callable[[], torch.nn.Module], seed: int
           ) -> torch.nn.Module:
    """``make()`` with torch's default init drawn under ``seed`` on the
    CPU: the same weights wherever the module then goes."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return make()


def _build(make: Callable[[], torch.nn.Module], seed: int,
           weights: dict | None, name: str) -> torch.nn.Module:
    """``seeded(make, seed)``, or with ``weights[name]`` when given."""
    net = seeded(make, seed)
    if weights and name in weights:
        net.load_state_dict(weights[name])
    return net


def _loop(steps: int, step: Callable[[int], float]) -> tuple[float, float]:
    vals = [step(i) for i in range(steps)]
    return vals[0], vals[-1]


def run_content(steps: int, device=DEFAULT_DEVICE,
                weights: dict | None = None) -> tuple[float, float]:
    from animateportrait_tpu_torch.models.audio2landmark import (
        Audio2landmarkContent)
    from animateportrait_tpu_torch.train.module1 import (
        ContentConfig, ContentTrainer)

    dev = resolve_device(device)
    aus, fls, face_id, _ = synth_audio_landmarks()
    tr = ContentTrainer(ContentConfig(lr=1e-3), _build(
        Audio2landmarkContent, 0, weights, "content"), device=dev)
    f, a, fi = (_t(x, dev) for x in (fls, aus, face_id))
    return _loop(steps, lambda i: float(tr.step(f, a, fi)["loss"]))


def run_speaker_aware(steps: int, device=DEFAULT_DEVICE,
                      weights: dict | None = None,
                      z_of_step: Callable[[int], np.ndarray] | None = None
                      ) -> tuple[float, float]:
    """``z_of_step(i)`` gives step i's unit normal speaker noise (the JAX
    tool draws it from ``jax.random.key(i)``); by default a
    ``torch.Generator`` seeded 0 draws it."""
    from animateportrait_tpu_torch.models.audio2landmark import (
        Audio2landmarkSpeakerAware)
    from animateportrait_tpu_torch.train.module1 import (
        SpeakerAwareConfig, SpeakerAwareTrainer)

    dev = resolve_device(device)
    aus, fls, face_id, _ = synth_audio_landmarks()
    embs, rot_quat, rot_trans = speaker_pose_targets(aus.shape[0])
    tr = SpeakerAwareTrainer(SpeakerAwareConfig(lr=1e-3), _build(
        Audio2landmarkSpeakerAware, 0, weights, "speaker"), device=dev)
    args = tuple(_t(x, dev) for x in (aus, embs, face_id, fls[:, 0, :],
                                      rot_quat, rot_trans))
    gen = torch.Generator(device=dev).manual_seed(0)

    def step(i):
        z = None if z_of_step is None else _t(z_of_step(i), dev)
        return float(tr.step(*args, z=z, generator=gen)["loss"])
    return _loop(steps, step)


def run_foa(steps: int, device=DEFAULT_DEVICE,
            weights: dict | None = None, size: int = 64
            ) -> tuple[float, float]:
    """``train_foa`` over the four blobs (batch 2, sigma 4, no
    augmentation, shuffled by ``default_rng(0)``); the NME before and
    after."""
    from animateportrait_tpu_torch.data.face_of_art import FOAItem
    from animateportrait_tpu_torch.models.face_of_art import (
        ArtisticHeatmapNet)
    from animateportrait_tpu_torch.train.face_of_art import (
        FOATrainConfig, FOATrainer, evaluate_foa, train_foa)

    dev = resolve_device(device)
    imgs, lms = blob_faces(size)
    items = [FOAItem(path=f"synt{i}", lms=lms[i], image=imgs[i])
             for i in range(4)]
    cfg = FOATrainConfig(lr=3e-4)
    tr = FOATrainer(cfg, _build(ArtisticHeatmapNet, 0, weights, "foa"),
                    device=dev)
    nme0 = evaluate_foa(tr.model, imgs, lms)
    train_foa(items, cfg, train_iter=steps, batch_size=2, image_size=size,
              sigma=4.0, augment=False, print_every=0, seed=0, trainer=tr,
              device=dev)
    return nme0, evaluate_foa(tr.model, imgs, lms)


def run_fan(steps: int, device=DEFAULT_DEVICE,
            weights: dict | None = None, size: int = 64,
            dtype: torch.dtype = torch.float32) -> tuple[float, float]:
    """FAN (1 stack, 68 points, lr 1e-3) on the four blobs, all four a
    batch; the ``evaluate_fan`` NME before and after. At 64^2 the
    innermost hourglass level is 1x1, so its BatchNorms see 4 values a
    channel (mean/std up to ~2000): fp32 rounding alone moves the third
    step's NME by percent, in either package; ``dtype`` float64 gives the
    exact-arithmetic run."""
    from animateportrait_tpu_torch.train.fan import (
        FANTrainConfig, FANTrainer, build_fan, evaluate_fan,
        make_fan_targets)

    dev = resolve_device(device)
    imgs, lms = blob_faces(size)
    lms_xy = lms[:, :, ::-1].copy()
    cfg = FANTrainConfig(num_modules=1, num_landmarks=68, lr=1e-3)
    tr = FANTrainer(cfg, _build(lambda: build_fan(cfg), 0, weights,
                                "fan").to(dtype), device=dev)
    nme0 = evaluate_fan(tr.model, imgs, lms_xy, cfg)
    targets = [make_fan_targets(lm, hm_size=size // 4) for lm in lms_xy]
    gt, w = (_t(np.stack([tg[j] for tg in targets]), dev).to(dtype)
             for j in (0, 1))
    x = _nchw(imgs, dev).to(dtype)
    for _ in range(steps):
        tr.step(x, gt, w)
    return nme0, evaluate_fan(tr.model, imgs, lms_xy, cfg)


def run_flow(steps: int, device=DEFAULT_DEVICE,
             weights: dict | None = None) -> tuple[float, float]:
    """Masked EPE (flow_regression_model.py:119-129) at num_scale 3."""
    from animateportrait_tpu_torch.models.flowunet import FlowUnet
    from animateportrait_tpu_torch.train.flow_regression import (
        FlowRegConfig, FlowRegTrainer)

    dev = resolve_device(device)
    tr = FlowRegTrainer(FlowRegConfig(num_scale=3, lr=2e-4), _build(
        lambda: FlowUnet(num_scale=3), 0, weights, "flow"), device=dev)
    kp1, kp2, flow_gt, vis_gt = flow_batch()
    args = (_t(kp1, dev), _t(kp2, dev), _nchw(flow_gt, dev),
            _t(vis_gt, dev).long())
    return _loop(steps, lambda i: float(tr.step(*args)["epe"]))


def run_image_translation(steps: int, device=DEFAULT_DEVICE,
                          weights: dict | None = None
                          ) -> tuple[float, float]:
    """L1 of ResUnet (ngf 8, num_downs 5) + a random-weight VGG at 64^2."""
    from animateportrait_tpu_torch.models.image_translation import (
        Vgg19Features)
    from animateportrait_tpu_torch.train.image_translation import (
        ImageTranslationConfig, ImageTranslationTrainer, build_generator)

    dev = resolve_device(device)
    cfg = ImageTranslationConfig(num_downs=5, ngf=8, lr=1e-3, use_vgg=True)
    tr = ImageTranslationTrainer(
        cfg, _build(lambda: build_generator(cfg), 0, weights, "imtrans"),
        _build(Vgg19Features, 1, weights, "vgg"), device=dev)
    x, y = (_nchw(a.astype(np.float32), dev)
            for a in image_translation_batch())
    return _loop(steps, lambda i: float(tr.step(x, y)["l1"]))


def run_pose_transfer(steps: int, device=DEFAULT_DEVICE,
                      weights: dict | None = None
                      ) -> tuple[float, float, float, float]:
    """(l1_first, l1_last, psnr_first, psnr_last) of the dual-Unet GAN at
    the tool's small widths."""
    from animateportrait_tpu_torch.models.flowunet import FlowUnet
    from animateportrait_tpu_torch.models.image_translation import (
        Vgg19Features)
    from animateportrait_tpu_torch.train.pose_transfer import (
        PoseTransferConfig, PoseTransferTrainer, build_d, build_g)

    dev = resolve_device(device)
    cfg = PoseTransferConfig(G_nf=8, G_max_nf=32, G_n_scale=3,
                             G_n_warp_scale=2, joint_nc=6, size=32, D_nf=8,
                             D_n_layers=2, lr=1e-3)
    tr = PoseTransferTrainer(
        cfg, _build(lambda: build_g(cfg), 0, weights, "pose_g"),
        _build(lambda: FlowUnet(input_nc=2 * cfg.joint_nc), 3, weights,
               "pose_netf"),
        _build(Vgg19Features, 4, weights, "pose_vgg"),
        d=_build(lambda: build_d(cfg), 2, weights, "pose_d"), device=dev)
    batch = {k: _nchw(v, dev) if v.ndim == 4 else _t(v, dev)
             for k, v in pose_batch(j=cfg.joint_nc).items()}
    rows = []
    for _ in range(steps):
        m = tr.step(batch)
        rows.append((float(m["loss_l1"]), float(m["PSNR"])))
    return rows[0][0], rows[-1][0], rows[0][1], rows[-1][1]


def run_all(steps: int, device=DEFAULT_DEVICE, only=RUNS,
            weights: dict | None = None,
            z_of_step: Callable[[int], np.ndarray] | None = None,
            say: Callable[[str], None] = print) -> list[tuple]:
    """The table's rows (name, first, last) of the runs in ``only``, in
    the JAX tool's order."""
    for name in only:
        if name not in RUNS:
            raise ValueError(f"--only {name}: not one of {', '.join(RUNS)}")
    rows = []
    if "content" in only:
        say("content branch ...")
        f, l = run_content(steps, device, weights)
        rows.append(("content L1+motion+laplacian", f, l))
    if "speaker" in only:
        say("speaker-aware branch ...")
        f, l = run_speaker_aware(steps, device, weights, z_of_step)
        rows.append(("speaker-aware reg+lap+pos", f, l))
    if "foa" in only:
        say("face_of_art heatmap net ...")
        f, l = run_foa(steps, device, weights)
        rows.append(("face_of_art valid NME (argmax decode)", f, l))
    if "flow" in only:
        say("flow regressor ...")
        f, l = run_flow(steps, device, weights)
        rows.append(("flow_regression masked EPE", f, l))
    if "imtrans" in only:
        say("image translation ...")
        f, l = run_image_translation(steps, device, weights)
        rows.append(("image_translation L1 (ResUnet+VGG)", f, l))
    if "pose" in only:
        say("pose transfer ...")
        f, l, p0, p1 = run_pose_transfer(steps, device, weights)
        rows.append(("pose_transfer L1", f, l))
        # PSNR rises: its negation descends like every other row
        rows.append(("pose_transfer -PSNR (dB)", -p0, -p1))
    if "fan" in only:
        say("FAN (AWing) ...")
        f, l = run_fan(steps, device, weights)
        rows.append(("FAN/AWing NME (argmax decode)", f, l))
    return rows


def table(rows: list[tuple]) -> str:
    md = ["| trainer / metric | first | last |", "|---|---|---|"]
    md += [f"| {n} | {f:.4f} | {l:.4f} |" for n, f, l in rows]
    return "\n".join(md)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--md", default="")
    ap.add_argument("--only", default="",
                    help="comma list of " + ",".join(RUNS) + " (default: all)")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    only = tuple(args.only.split(",")) if args.only else RUNS
    dev = resolve_device(args.device)
    print("device:", dev, flush=True)
    rows = run_all(args.steps, dev, only,
                   say=lambda m: print(m, flush=True))
    body = table(rows)
    print(body)
    if args.md:
        with open(args.md, "w") as fp:
            fp.write(body + "\n")
    if not all(l < f for _, f, l in rows):
        print("FAIL: a trainer did not descend", file=sys.stderr)
        return 1
    print(f"OK: all {len(rows)} metrics descend")
    return 0


if __name__ == "__main__":
    sys.exit(main())
