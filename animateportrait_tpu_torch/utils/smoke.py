"""Inputs and weights for smoke runs of the slice (no checkpoints needed):
the fixed-box stub detector and the synthetic speech WAV that the JAX
package's ``bench.py:bench_e2e`` uses, seeded random weights, seeded
random MTCNN weights biased to detect faces, seeded random face_alignment
FAN and depth checkpoints (``write_fan_checkpoints``), a seeded
synthetic UMLVD-IFW training tree (``write_umlvd_tree``), and the layout
the reference driver leaves for ``test_cli`` (``write_test_layout``)."""
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


def write_fan_checkpoints(directory: str, seed: int = 0,
                          num_modules: int = 4,
                          depth_layers: tuple = (3, 8, 36, 3)
                          ) -> tuple[str, str]:
    """Seeded random face_alignment checkpoints under ``directory``, by the
    public package's names: ``3DFAN4-7835d9f11d.pth.tar`` (FAN3D of
    ``num_modules``) and ``depth-2a464da4ea.pth.tar`` (ResNetDepth of
    ``depth_layers``), each a plain state dict. The weights are torch's
    default init from ``torch.manual_seed(seed)``, whose scale keeps the
    deep nets' activations finite; the BatchNorm statistics are the
    init's (mean 0, var 1)."""
    from animateportrait_tpu_torch.models.fan3d import FAN3D, ResNetDepth

    os.makedirs(directory, exist_ok=True)
    torch.manual_seed(seed)
    paths = (os.path.join(directory, "3DFAN4-7835d9f11d.pth.tar"),
             os.path.join(directory, "depth-2a464da4ea.pth.tar"))
    for path, net in zip(paths, (FAN3D(num_modules=num_modules),
                                 ResNetDepth(layers=depth_layers))):
        torch.save(net.state_dict(), path)
    return paths


def build_pipeline(nets: dict[str, nn.Module], device: torch.device | str,
                   frame_batch: int = 8, output_uint8: bool = True,
                   style: str = "drawing", detector=None,
                   use_bf16: bool = False, motion_mode: str = "linear",
                   data_parallel: bool = False, devices: list | None = None):
    """The slice's ``TalkingPortraitPipeline`` on ``device``: ``detector``
    (the fixed-box stub when None), ``AudioPipeline(chunk=512)`` without a
    voice encoder, default landmark amplifiers, and the renderer of
    ``style`` (the static net ``nets["static_g"]`` for drawing,
    ``nets["photo2cartoon"]`` for cartoon), its per-frame nets in bf16 with
    ``use_bf16`` (``--render_bf16``), its motion grids by ``motion_mode``
    (``--warp_mode``), its per-frame nets replicated over ``devices`` (or
    every visible card) with ``data_parallel`` (``--render_dp``)."""
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
                        use_bf16=use_bf16, motion_mode=motion_mode,
                        data_parallel=data_parallel, devices=devices))


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


def write_test_layout(root: str, db: str = "portrait_MTCNN",
                      n_frames: int = 16, size: int = 512,
                      seed: int = 0) -> str:
    """The files the reference driver leaves for ``Module2/test.py``
    (main_end2end_module2.py:71-87), seeded and synthetic, under ``root``:
    one size^2 photo ``Data/Photo/<db>/ori.png`` and its 68 points in
    ``Data/Alm_txt/MTCNN/<db>/ori.txt``; ``n_frames`` landmark frames
    ``Data/Alm/MTCNN/<db>/NNNNN.png`` (their dot images) with their points,
    the photo's with the mouth opening and closing as in speech, in
    ``Data/Alm_txt/MTCNN/<db>/NNNNN.txt``; and the list files
    ``datasets/list/testA|B/<db>.txt`` (absolute paths), which
    ``test_cli`` reads from the working directory. Returns ``db``."""
    from animateportrait_tpu_torch.utils.image import draw_dots, write_png

    rng = np.random.default_rng(seed)
    root = os.path.abspath(root)
    photo_dir = os.path.join(root, "Data", "Photo", db)
    alm_dir = os.path.join(root, "Data", "Alm", "MTCNN", db)
    txt_dir = os.path.join(root, "Data", "Alm_txt", "MTCNN", db)
    for d in (photo_dir, alm_dir, txt_dir, os.path.join(
            root, "datasets", "list", "testA"), os.path.join(
            root, "datasets", "list", "testB")):
        os.makedirs(d, exist_ok=True)

    def put_txt(path, lm):
        with open(path, "w") as f:
            f.writelines(f"{x!r} {y!r}\n" for x, y in lm.tolist())

    lm = _face_landmarks(rng, size)
    photo = os.path.join(photo_dir, "ori.png")
    write_png(photo, _portrait(rng, lm, size, gray=False), level=1)
    put_txt(os.path.join(txt_dir, "ori.txt"), lm)
    lower = [5, 6, 7, 8, 9, 10, 11, 55, 56, 57, 58, 59, 65, 66, 67]
    frames = []
    for i in range(n_frames):
        f = lm.copy()
        f[lower, 1] += size * 0.02 * (1 + np.sin(i * 0.8))
        f += rng.normal(0, size * 0.001, f.shape).astype(np.float32)
        path = os.path.join(alm_dir, f"{i:05d}.png")
        write_png(path, ((draw_dots(f, size)[..., 0] + 1) * 127.5).astype(
            np.uint8), level=1)
        put_txt(os.path.join(txt_dir, f"{i:05d}.txt"), f)
        frames.append(path)
    for kind, paths in (("testA", [photo] * n_frames), ("testB", frames)):
        with open(os.path.join(root, "datasets", "list", kind, db + ".txt"),
                  "w") as fp:
            fp.writelines(p + "\n" for p in paths)
    return db


# --- the Module1-side trainers (train/{module1,flow_regression,
# image_translation,pose_transfer,fan,face_of_art}.py) at full width -----

TRAINERS = ("content", "speaker", "flow", "imtrans", "pose", "fan", "foa")


class TrainerSmoke:
    """One ported trainer with its seeded synthetic batch: ``run()`` runs
    one training step and returns its metrics as the trainer does (tensors,
    no wait for the card), ``step()`` as floats; ``nets`` are the
    trained modules by name (their ``.grad`` hold the last step's
    gradients); ``what`` names the configuration."""

    def __init__(self, what: str, trainer, step, nets: dict):
        self.what, self.trainer, self._step, self.nets = \
            what, trainer, step, nets

    def run(self) -> dict:
        return self._step()

    def step(self) -> dict[str, float]:
        return {k: float(v) for k, v in self.run().items()}

    def grads(self) -> dict[str, torch.Tensor]:
        return {f"{n}.{k}": p.grad for n, net in self.nets.items()
                for k, p in net.named_parameters() if p.grad is not None}


def trainer_smoke(name: str, device: torch.device | str, small: bool = False,
                  dtype: torch.dtype = torch.float32) -> TrainerSmoke:
    """The trainer ``name`` (one of ``TRAINERS``) on ``device`` with seeded
    weights and a seeded synthetic batch. Full width (``small=False``):

    - content: ``Audio2landmarkContent`` over all 341 stride-1 18-frame
      windows of a 358-frame clip;
    - speaker: ``Audio2landmarkSpeakerAware`` (256-d embedding) over the
      same windows, with a fixed seeded z;
    - flow: ``FlowRegConfig`` (num_scale 4), 136 keypoint-map channels at
      224^2, batch 4;
    - imtrans: ResUnet ngf 64, num_downs 6, at 256^2 with VGG19, batch 4;
    - pose: ``PoseTransferConfig`` (dual_unet, G_nf 32, max 128, 7 scales,
      5 warp scales, 68 joints, D on) at 256^2, batch 4 (7 scales need a
      side divisible by 2^7; the config's 224 is not, in the JAX package
      either);
    - fan: ``FANTrainConfig`` (4 stacks, 98 points) at 256^2 with 64^2
      heatmaps, batch 4, on seeded noise images and seeded 98-point
      layouts through ``make_fan_targets``;
    - foa: ``ArtisticHeatmapNet`` (68 points) at 256^2, batch 4 (Adam,
      lr 1e-3, ``train_foa``'s defaults), on the convergence tool's blob
      faces and their ``make_foa_targets`` maps (sigma 6).

    ``small`` takes the card-against-host widths: 24 windows; num_scale 3,
    batch 2; ngf 8, num_downs 5, 64^2, batch 2 on seeded uniform noise;
    the JAX convergence tool's pose widths, batch 2; FAN with 1 stack and
    68 points at 256^2, batch 2 (its innermost level 4x4: at 64^2 it is
    1x1, where BatchNorm over 2 values a channel makes any fp32 step a
    coin flip); face_of_art at 64^2, batch 2. ``dtype`` float64 gives the
    host's exact stand-in."""
    from animateportrait_tpu_torch.models.audio2landmark import (
        Audio2landmarkContent, Audio2landmarkSpeakerAware)
    from animateportrait_tpu_torch.models.flowunet import FlowUnet
    from animateportrait_tpu_torch.models.image_translation import (
        Vgg19Features)
    from animateportrait_tpu_torch.train import convergence as cv
    from animateportrait_tpu_torch.train import (
        flow_regression as fr, image_translation as it, module1 as m1,
        pose_transfer as pt)

    dev = torch.device(device)

    def t(x):
        x = torch.from_numpy(np.ascontiguousarray(x))
        return (x.to(dtype) if x.is_floating_point() else x).to(dev)

    def nchw(x):
        return t(x).permute(0, 3, 1, 2).contiguous()

    def place(net):
        return net.to(dtype)

    if name in ("content", "speaker"):
        n_frames = 41 if small else 358
        au, fls, face_id, _ = cv.audio_landmark_signals(n_frames)
        win = [np.stack([x[i:i + 18] for i in range(n_frames - 17)]
                        ).astype(np.float32) for x in (au, fls)]
        aus, flw = (t(x) for x in win)
        fid = t(face_id)
        if name == "content":
            tr = m1.ContentTrainer(m1.ContentConfig(), place(cv.seeded(
                Audio2landmarkContent, 0)), device=dev)
            return TrainerSmoke(
                f"content: Audio2landmarkContent, {aus.shape[0]} windows",
                tr, lambda: tr.step(flw, aus, fid), {"content": tr.model})
        n = aus.shape[0]
        embs, quat, trans = (t(x) for x in cv.speaker_pose_targets(n))
        z = t(np.random.default_rng(5).standard_normal((n, 128)).astype(
            np.float32))
        tr = m1.SpeakerAwareTrainer(m1.SpeakerAwareConfig(), place(cv.seeded(
            Audio2landmarkSpeakerAware, 0)), device=dev)
        return TrainerSmoke(
            f"speaker: Audio2landmarkSpeakerAware, {n} windows, 256-d emb",
            tr, lambda: tr.step(aus, embs, fid, flw[:, 0, :], quat, trans,
                                z=z), {"speaker": tr.model})
    if name == "flow":
        cfg = fr.FlowRegConfig(num_scale=3 if small else 4)
        kp1, kp2, flow_gt, vis_gt = cv.flow_batch()
        k = 2 if small else 4
        tr = fr.FlowRegTrainer(cfg, place(cv.seeded(
            lambda: FlowUnet(num_scale=cfg.num_scale), 0)), device=dev)
        batch = (t(kp1[:k]), t(kp2[:k]), nchw(flow_gt[:k]),
                 t(vis_gt[:k]).long())
        return TrainerSmoke(
            f"flow: FlowUnet num_scale {cfg.num_scale}, 136 ch, 224^2, "
            f"batch {k}", tr, lambda: tr.step(*batch), {"flow": tr.model})
    if name == "imtrans":
        cfg = it.ImageTranslationConfig(num_downs=5, ngf=8) if small \
            else it.ImageTranslationConfig()
        size, k = (64, 2) if small else (256, 4)
        tr = it.ImageTranslationTrainer(
            cfg, place(cv.seeded(lambda: it.build_generator(cfg), 0)),
            place(cv.seeded(Vgg19Features, 1)), device=dev)
        if small:
            # seeded noise: the convergence tool's flat synthetic faces
            # put exact ties in VGG's max-pools, which rounding and each
            # implementation break their own way
            r = np.random.default_rng(3)
            x, y = (t(r.uniform(-1, 1, (k, c, size, size)).astype(
                np.float32)) for c in (6, 3))
        else:
            x, y = (nchw(a[:k].astype(np.float32))
                    for a in cv.image_translation_batch(size))
        return TrainerSmoke(
            f"imtrans: ResUnet ngf {cfg.ngf}, num_downs {cfg.num_downs}, "
            f"{size}^2, VGG19, batch {k}", tr, lambda: tr.step(x, y),
            {"imtrans": tr.model})
    if name == "pose":
        if small:
            cfg = pt.PoseTransferConfig(G_nf=8, G_max_nf=32, G_n_scale=3,
                                        G_n_warp_scale=2, joint_nc=6,
                                        size=32, D_nf=8, D_n_layers=2,
                                        lr=1e-3)
            k = 2
        else:
            cfg, k = pt.PoseTransferConfig(size=256), 4
        tr = pt.PoseTransferTrainer(
            cfg, place(cv.seeded(lambda: pt.build_g(cfg), 0)),
            place(cv.seeded(lambda: FlowUnet(input_nc=2 * cfg.joint_nc), 3)),
            place(cv.seeded(Vgg19Features, 4)),
            d=place(cv.seeded(lambda: pt.build_d(cfg), 2)), device=dev)
        batch = {kk: nchw(v) if v.ndim == 4 else t(v) for kk, v in
                 cv.pose_batch(k, cfg.size, cfg.joint_nc).items()}
        return TrainerSmoke(
            f"pose: {cfg.which_model_G} G_nf {cfg.G_nf}, max {cfg.G_max_nf}, "
            f"{cfg.G_n_scale} scales, {cfg.G_n_warp_scale} warp scales, "
            f"{cfg.joint_nc} joints, D on, {cfg.size}^2, batch {k}", tr,
            lambda: tr.step(batch), {"g": tr.g, "d": tr.d})
    if name == "fan":
        from animateportrait_tpu_torch.train import fan as tf
        cfg = tf.FANTrainConfig(num_modules=1, num_landmarks=68) if small \
            else tf.FANTrainConfig()
        k = 2 if small else 4
        r = np.random.default_rng(7)
        lms = r.uniform(48, 208, (k, cfg.num_landmarks, 2))
        targets = [tf.make_fan_targets(lm) for lm in lms]
        gt, w = (t(np.stack([tg[j] for tg in targets])) for j in (0, 1))
        x = t(r.uniform(0, 1, (k, 3, 256, 256)).astype(np.float32))
        tr = tf.FANTrainer(cfg, place(cv.seeded(lambda: tf.build_fan(cfg),
                                                0)), device=dev)
        return TrainerSmoke(
            f"fan: FAN {cfg.num_modules} stacks, {cfg.num_landmarks} points, "
            f"256^2, batch {k}", tr, lambda: tr.step(x, gt, w),
            {"fan": tr.model})
    if name == "foa":
        from animateportrait_tpu_torch.train import face_of_art as tfa
        cfg = tfa.FOATrainConfig()
        size, k = (64, 2) if small else (256, 4)
        imgs, lms = cv.blob_faces(size)
        maps = [tfa.make_foa_targets(lm, size) for lm in lms[:k]]
        small_maps, large = (t(np.stack([m[j] for m in maps]))
                             for j in (0, 1))
        x = nchw(imgs[:k])
        tr = tfa.FOATrainer(cfg, place(tfa.seeded_foa_net(cfg, 0)),
                            device=dev)
        return TrainerSmoke(
            f"foa: ArtisticHeatmapNet 68 points, {size}^2, batch {k}", tr,
            lambda: tr.step(x, small_maps, large), {"foa": tr.model})
    raise ValueError(f"unknown trainer {name!r}: one of {TRAINERS}")


def cancelled_biases(net: nn.Module, norms: tuple | None = None) -> set:
    """The biases whose gradient is 0 in exact arithmetic in a training
    step, so that their fp32 gradients are rounding noise: those of the
    convs and linears that one of ``norms`` follows (the norm removes any
    constant; by default BatchNorm on batch statistics and InstanceNorm),
    and the attention key biases (a key bias adds one q.b to every score
    of a query, which the softmax removes)."""
    from animateportrait_tpu_torch.nn import InstanceNorm2d

    norms = norms or (nn.BatchNorm1d, nn.BatchNorm2d, InstanceNorm2d)
    out = set()
    for name, mod in net.named_modules():
        kids = list(mod.named_children())
        for (a, m), (_, nxt) in zip(kids, kids[1:]):
            if isinstance(m, (nn.modules.conv._ConvNd, nn.Linear)) \
                    and isinstance(nxt, norms) and m.bias is not None:
                out.add(f"{name}.{a}.bias".lstrip("."))
    return out | {k for k, _ in net.named_parameters()
                  if k.endswith("k_linear.bias")}


def grad_parity(got: dict, ref: dict, ref64: dict | None, noise: set,
                bar: float = 1e-3) -> dict[str, float]:
    """Each gradient leaf of ``got`` against ``ref`` (tensors or arrays by
    key), as a number to be held to ``bar`` (1e-3; the same rule holds
    parameters after a few steps at 1e-4):

    - a leaf whose gradient is 0 in exact arithmetic, one in ``noise`` (a
      cancelled bias) or one whose float64 value (``ref64``, else ``ref``)
      is below 1e-12 of the tree's largest |g|: max |got - ref| over the
      tree's largest |ref|;
    - any other leaf: max |got - ref| over its own largest |ref|; or, given
      ``ref64`` (a float64 run of the same step) and where ``ref``'s own
      distance d from it is above ``bar`` of its scale (the step is
      ill-conditioned in fp32 there, or ``ref``'s is not repeatable),
      got's distance from ``ref64`` over 3 d, times ``bar``: the leaf
      passes when it is no farther from float64 than 3x ``ref``'s own
      fp32 distance.

    Each leaf is judged on its own numbers only."""
    def arr(x):
        return (x.detach().double().cpu() if torch.is_tensor(x)
                else torch.as_tensor(np.asarray(x, np.float64)))

    def amax(x):
        return float(x.abs().max()) if x.numel() else 0.0

    def rel(a, b):
        d = float((a - b).abs().max()) if a.numel() else 0.0
        return d / amax(b) if amax(b) > 0 else d

    got = {k: arr(v) for k, v in got.items()}
    ref = {k: arr(ref[k]) for k in got}
    exact = ref if ref64 is None else {k: arr(ref64[k]) for k in got}
    top = max(amax(r) for r in ref.values())
    top64 = max(amax(r) for r in exact.values())
    out = {}
    for k, g in got.items():
        if k in noise or amax(exact[k]) < 1e-12 * top64:
            out[k] = float((g - ref[k]).abs().max()) / top
            continue
        out[k] = rel(g, ref[k])
        if ref64 is not None:
            d = rel(ref[k], exact[k])
            if d > bar:
                out[k] = bar * rel(g, exact[k]) / (3 * d)
    return out


# --- the multi-card paths' ranks (``utils/distributed.py:spawn``) -----------


def _kept_instance_norm_inputs(nets: list) -> tuple[dict, list]:
    """Pre-hooks that keep the first input of each shape that an
    InstanceNorm2d of ``nets`` sees, with its ReLU flag."""
    from animateportrait_tpu_torch.nn import InstanceNorm2d

    kept, hooks = {}, []
    for net in nets:
        for mod in net.modules():
            if isinstance(mod, InstanceNorm2d):
                def keep(mod, args):
                    key = (tuple(args[0].shape), mod.relu)
                    if key not in kept:
                        kept[key] = args[0].detach().clone()
                hooks.append(mod.register_forward_pre_hook(keep))
    return kept, hooks


def k2_against_plain(kept: dict) -> float:
    """The largest |K2 - its plain version| on the kept InstanceNorm
    inputs (0 on the CPU, where the wrapper is the plain version)."""
    from animateportrait_tpu_torch.ops.instnorm import (
        instance_norm, instance_norm_plain)

    err = 0.0
    with torch.inference_mode():
        for (_, relu), x in kept.items():
            got = instance_norm(x, relu=relu)
            want = instance_norm_plain(x, relu=relu)
            err = max(err, float((got.float() - want.float()).abs().max()))
    return err


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def dp_step_run(cfg, batch: dict, steps: int, device: torch.device,
                group=None, fsdp_min_size: int | None = None,
                ckpt_dir: str | None = None, decompose: int | None = None
                ) -> dict:
    """``steps`` Module2 training steps from ``train_cli``'s seeded state
    and frozen nets (seeds 0 and 1) on ``batch`` (a dict of numpy arrays,
    the global batch), each step's pool drawn from a generator seeded by
    the step on ``device``, as ``train_cli`` draws it. With a process
    ``group``, this rank's contiguous slice of the batch in the
    data-parallel step; without, the whole batch in one process, or with
    ``decompose`` the step of that many ranks emulated in one process
    (``decomposed_grads``). With ``fsdp_min_size`` too, the state FSDP-sharded over the group at that
    ``min_size`` (``train/fsdp.py``). Returns each step's losses and
    gradients, the pool and its count after each step, the parameters
    before and after each step (all on the host, whole), K2's and K2b's
    launches in the steps, each step's ms (host clock to a synchronize),
    the bytes a step all-reduces (and, sharded, reduce-scatters; it
    all-gathers as many), the peak memory on a card, and the largest |K2 - its
    plain version| on the first step's InstanceNorm inputs of G and the
    Ds; sharded, also this rank's bytes of parameters plus moments
    (``FSDPShards.nbytes``) and the shape of each master and moment.
    With ``ckpt_dir``, the state after the steps is saved there through
    ``io/checkpoint.py`` by rank 0 (a sharded one gathered whole on every
    rank first)."""
    import time

    import torch.distributed as dist

    from animateportrait_tpu_torch.ops.instnorm import (
        instance_norm, instance_norm_backward)
    from animateportrait_tpu_torch.train import module2 as m2
    from animateportrait_tpu_torch.train.fsdp import (
        gather_state, shard_state_fsdp)

    def host(tree):
        return {k: v.detach().cpu().clone() for k, v in tree.items()}

    def params(state):
        whole = gather_state(state)
        return {"g": host(dict(whole.g.named_parameters())),
                "d": host(dict(whole.d.named_parameters()))}

    rank, world = (0, 1) if group is None else (dist.get_rank(group),
                                                dist.get_world_size(group))
    n = next(iter(batch.values())).shape[0] // world
    local = {k: torch.as_tensor(v[rank * n:(rank + 1) * n]).to(device)
             for k, v in batch.items()}
    state = m2.init_state(cfg, torch.Generator().manual_seed(0), device)
    frozen = m2.init_frozen_random(torch.Generator().manual_seed(1), device)
    step_fn = m2.build_train_step(cfg)
    kept, hooks = _kept_instance_norm_inputs([state.g, state.d])
    sizes = [p.numel() for net in (state.g, state.d)
             for p in net.parameters()]
    if fsdp_min_size is not None:
        shard_state_fsdp(state, group, fsdp_min_size)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    out = {"metrics": [], "grads": [], "pools": [], "pool_counts": [],
           "ms": [], "params": [params(state)]}
    instance_norm.launches = instance_norm_backward.launches = 0
    for i in range(steps):
        _sync(device)
        t0 = time.perf_counter()
        gen = torch.Generator(device=device).manual_seed(state.step)
        grads = (step_fn.grads(state, local, frozen, gen, group)
                 if decompose is None else decomposed_grads(
                     step_fn, state, local, frozen, gen, decompose))
        step_fn.apply_grads(state, grads)
        _sync(device)
        out["ms"].append(1e3 * (time.perf_counter() - t0))
        for h in hooks:
            h.remove()
        hooks = []
        if i == 0 and device.type == "cuda":
            out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
        g, d = grads.g, grads.d
        if state.fsdp is not None:
            g, d = (state.fsdp.gather_tree("g", g),
                    state.fsdp.gather_tree("d", d))
        out["grads"].append({"g": host(g), "d": host(d)})
        out["metrics"].append({k: float(v) for k, v in grads.metrics.items()})
        out["pools"].append(grads.pool.cpu())
        out["pool_counts"].append(grads.pool_count)
        out["params"].append(params(state))
    out["launches"] = {"instance_norm": instance_norm.launches,
                       "instance_norm_backward":
                       instance_norm_backward.launches}
    # G's and the Ds' gradients, and the step's losses, in fp32
    out["allreduce_bytes"] = 0 if group is None else 4 * (
        sum(sizes) + len(out["metrics"][0]))
    if state.fsdp is not None:
        fs = state.fsdp
        shard = 4 * sum(m.numel() for *_, m, _ in fs.sharded())
        # the sharded leaves leave the all-reduce for a reduce-scatter of
        # the whole gradients and an all-gather of the slices
        out["allreduce_bytes"] -= shard * fs.world
        out["reduce_scatter_bytes"] = shard * fs.world
        out["fsdp_bytes"] = fs.nbytes()
        out["shapes"] = {
            f"{key}.{name}": (tuple(m.shape), axis, tuple(
                v.shape for k, v in fs.opts[key].state[m].items()
                if k != "step"))
            for key, name, _, m, axis in fs.sharded()}
    out["k2_err"] = k2_against_plain(kept)
    if ckpt_dir is not None:
        from animateportrait_tpu_torch.io.checkpoint import (
            CheckpointManager, train_state_dict)

        obj = train_state_dict(state)
        if rank == 0:
            CheckpointManager(ckpt_dir).save(state.step, obj)
    return out


def decomposed_grads(step_fn, state, batch: dict, frozen, gen, n: int):
    """The data-parallel ``Grads`` of n ranks emulated in one process:
    each rank's contiguous slice of ``batch`` through ``step_fn.grads``
    alone, the gradients and losses averaged, the pool filled in the
    ranks' order. While the pool fills (it returns each query's own
    images, so a slice's pass needs no other rank's fakes) this is the n
    ranks' computation, each conv at a rank's batch; a step that would
    fill the pool raises."""
    from animateportrait_tpu_torch.train.module2 import Grads

    per = next(iter(batch.values())).shape[0] // n
    c = state.pool_count
    if c + 2 * n * per > state.pool.shape[0]:
        raise ValueError(f"the pool ({c} of {state.pool.shape[0]}) would "
                         f"fill: the slices' passes need the other ranks' "
                         f"fakes")
    parts = [step_fn.grads(state, {k: v[r * per:(r + 1) * per]
                                   for k, v in batch.items()}, frozen, gen)
             for r in range(n)]
    pool = state.pool.clone()
    for r, gr in enumerate(parts):
        # a rank's slice of each query (fake_B, then fake_B2) in rank order
        for q in range(2):
            at = c + q * n * per + r * per
            pool[at:at + per] = gr.pool[c + q * per:c + (q + 1) * per]

    def mean(key):
        return {k: sum(getattr(gr, key)[k] for gr in parts) / n
                for k in getattr(parts[0], key)}

    return Grads(g=mean("g"), d=mean("d"), pool=pool,
                 pool_count=c + 2 * n * per, metrics=mean("metrics"))


def dp_step_rank(rank: int, world: int, device: torch.device, cfg,
                 batch: dict, steps: int, out_dir: str) -> None:
    """``dp_step_run`` as one rank of the default group; its result goes
    to ``<out_dir>/rank<rank>.pt``."""
    import torch.distributed as dist

    res = dp_step_run(cfg, batch, steps, device, dist.group.WORLD)
    res["backend"] = dist.get_backend()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def fsdp_steps(rank: int, world: int, device: torch.device, cfg,
               batch: dict, steps: int, min_size: int,
               ckpt_root: str | None = None) -> dict:
    """``dp_step_run`` data-parallel, then with the state FSDP-sharded at
    ``min_size``, over the default group: ``{"dp": ..., "fsdp": ...,
    "backend": ...}``; with ``ckpt_root``, each run's final state goes to
    the checkpoint directory ``<ckpt_root>/<mode>``."""
    import torch.distributed as dist

    res = {mode: dp_step_run(cfg, batch, steps, device, dist.group.WORLD,
                             size, None if ckpt_root is None
                             else os.path.join(ckpt_root, mode))
           for mode, size in (("dp", None), ("fsdp", min_size))}
    res["backend"] = dist.get_backend()
    return res


def jobs_rank(rank: int, world: int, device: torch.device, jobs: dict,
              out_dir: str) -> None:
    """One rank of ``utils/distributed.py:spawn`` that runs record
    functions (``fsdp_steps``, ``gpipe_run``, ``multichip.py:tp_run``,
    ``sp_run``), several in one spawn: ``jobs`` maps a name to (fn, args),
    each ``fn(rank, world, device, *args)`` returning its record (None on
    a rank it leaves out), run in order; ``{name: record}`` goes to
    ``<out_dir>/rank<rank>.pt``."""
    torch.save({name: fn(rank, world, device, *args)
                for name, (fn, args) in jobs.items()},
               os.path.join(out_dir, f"rank{rank}.pt"))


def resnet_blocks(dim: int, n: int, seed: int = 0) -> list[dict]:
    """The state dicts of ``n`` seeded random ``models/gan.py:
    ResnetBlock(dim)``s (``init_random_``)."""
    from animateportrait_tpu_torch.models.gan import ResnetBlock

    gen = torch.Generator().manual_seed(seed)
    return [init_random_(ResnetBlock(dim), gen).state_dict()
            for _ in range(n)]


def gpipe_run(rank: int, world: int, device: torch.device,
              blocks: list[dict], x: np.ndarray, microbatches: list,
              stages: int | None = None) -> dict | None:
    """One stage of a ``parallel.gpipe_apply`` run of the ResNet blocks
    ``blocks`` (state dicts, split over the stages by ``stage_blocks``) on
    ``x`` (NCHW numpy), once for each count of ``microbatches``, over the
    first ``stages`` ranks of the world (default all; every rank must
    call, and the others return None). Returns the output of each count,
    K2's launches in them, ms each (host clock to a synchronize), the
    error of an indivisible batch, the largest |K2 - its plain version|
    on this stage's InstanceNorm inputs, and the backend."""
    import time

    import torch.distributed as dist

    from animateportrait_tpu_torch.models.gan import ResnetBlock
    from animateportrait_tpu_torch.ops.instnorm import instance_norm
    from animateportrait_tpu_torch.parallel import (
        gpipe_apply, resnet_stage, stage_blocks)

    stages = stages or world
    group = None
    if stages < world:
        # new_group is collective: every rank of the world builds it
        group = dist.new_group(list(range(stages)))
        if rank >= stages:
            return None
    dim = x.shape[1]
    mods = []
    for sd in stage_blocks(blocks, stages, rank):
        block = ResnetBlock(dim)
        block.load_state_dict(sd)
        mods.append(block)
    stage = resnet_stage(mods).to(device).eval()
    xt = torch.as_tensor(x).to(device)
    kept, hooks = _kept_instance_norm_inputs([stage])
    out = {"y": {}, "launches": {}, "ms": {}}
    for m in microbatches:
        instance_norm.launches = 0
        _sync(device)
        t0 = time.perf_counter()
        y = gpipe_apply(stage, xt, group, num_microbatches=m)
        _sync(device)
        out["ms"][m] = 1e3 * (time.perf_counter() - t0)
        out["launches"][m] = instance_norm.launches
        out["y"][m] = y.cpu()
        for h in hooks:
            h.remove()
        hooks = []
    try:
        gpipe_apply(stage, xt[:1], group, num_microbatches=stages + 1)
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    out["k2_err"] = k2_against_plain(kept)
    out["backend"] = dist.get_backend()
    return out


def adam_update_parity(new: dict, ref: dict, old: dict, decisive_by: dict,
                       lr: float, steps: int = 1) -> tuple[float, float]:
    """Parameters after ``steps`` Adam updates from ``old`` (``new``)
    against a reference run's (``ref``), by name, as
    ``tests/test_torch_train.py`` holds an update: Adam moves an element
    whose gradient is rounding noise by up to lr a step with the noise's
    sign, so the updates are held where they are decided, on the elements
    whose ``decisive_by`` (a gradient of the run) exceeds 5e-2 of the
    tree's largest. Returns (the largest |update| over 1.5 lr a step, the
    largest |update - ref's update| on the decisive elements over
    2e-2 |ref's| + 2e-2 lr): each passes at <= 1."""
    def t(x):
        return torch.as_tensor(x).detach().double().cpu()

    top = max(float(t(g).abs().max()) for g in decisive_by.values())
    step_bound, decided = 0.0, 0.0
    for k, p0 in old.items():
        d, r = t(new[k]) - t(p0), t(ref[k]) - t(p0)
        step_bound = max(step_bound, float(d.abs().max()) / (1.5 * lr
                                                             * steps))
        mask = t(decisive_by[k]).abs() > 5e-2 * top
        if bool(mask.any()):
            decided = max(decided, float(((d - r).abs() / (
                2e-2 * r.abs() + 2e-2 * lr))[mask].max()))
    return step_bound, decided
