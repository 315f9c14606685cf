"""Stand-in frozen perception nets for the GAN convergence run: the port of
the JAX package's ``tools/train_standin_frozen.py``.

The reference's geometry and identity supervision (MobileFaceNet's
landmarks, Sphere20a's identity features) relies on shipped frozen
checkpoints that are not in the repository. With random frozen nets,
``geom_B`` and ``iden_B`` are noise through a random projection. This
module trains small stand-ins on the constructed-face family of
``train/gan_convergence.py``:

- ``mobilefacenet.flax.npz``: the port's ``MobileFaceNet`` (BatchNorm in
  eval mode, as the frozen net runs) trained through
  ``train/module2.py:extract_landmarks``, the crop / resize / BGR /
  reprojection the GAN's geometry loss applies, to regress the 68
  landmarks of rendered line drawings;
- ``sphere.flax.npz``: the port's ``Sphere20a`` trained as an identity
  classifier (cosine logits and a feature-scale anchor, as the JAX tool)
  over constructed identities drawn as line drawings, cropped with
  ``models/perception.py:crop_head_bbox`` as the FaceLoss crops them; the
  classifier head is dropped, the five feature levels kept.

Both are written as flax variable trees with ``io/checkpoint.py:
save_flax_npz``, so that ``io/reference.py:load_frozen`` (``train_cli
--frozen_dir``) takes them before any reference checkpoint, as the JAX
``train_cli`` does; the JAX package reads them too. The data generators
draw the JAX tool's numpy streams (the same landmarks, windows and
labels); the drawings are the port's primitives without anti-aliasing
(``train/gan_convergence.py``), ``cv2.INTER_CUBIC`` is
``utils/image.py:resize_bicubic``, and ``cv2.GaussianBlur(5x5, sigma)`` a
separable reflect-101 blur in float, rounded.

    python -m animateportrait_tpu_torch.train.standin_frozen [outdir]
        [--steps 3000] [--sphere_steps 1500] [--n_faces 3000] [--ids 48]
        [--per_id 40] [--seed 0] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
import time

import numpy as np
import torch

from animateportrait_tpu_torch.train.gan_convergence import (
    STROKES, _face_landmarks, _points, polyline_mask)
from animateportrait_tpu_torch.utils.device import (
    DEFAULT_DEVICE, resolve_device)

LOAD, CROP, WIN = 286, 256, 200  # dataset defaults: load 286, crop 256,
# face window rs=.7*286=200 at rx=.15/ry=.2 (data/umlvd_ifw.py)
BATCH = 32


def gaussian_blur5(img: np.ndarray, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (5, 5), sigma)`` of a uint8 plane, as a
    separable float blur with the reflect-101 border, rounded (OpenCV's
    uint8 path sums in fixed point, so values may differ by a level)."""
    k = np.exp(-(np.arange(5) - 2.0) ** 2 / (2 * sigma * sigma))
    k /= k.sum()
    x = np.pad(img.astype(np.float64), 2, mode="reflect")
    x = sum(k[i] * x[:, i: i + img.shape[1]] for i in range(5))
    x = sum(k[i] * x[i: i + img.shape[0]] for i in range(5))
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def _render_drawing_aug(lm, size, rng):
    """Line drawing with appearance augmentation (stroke width, gray
    level, blur, noise) so the stand-in is robust to imperfect GAN
    outputs, not just clean renders."""
    thick = int(rng.integers(1, 4))
    gray = int(rng.integers(0, 90))
    mask = np.zeros((size, size), np.uint8)
    for idx, closed in STROKES:
        polyline_mask(mask, _points(lm[list(idx)]), closed, thick)
    img = np.full((size, size), 255, np.uint8)
    img[mask > 0] = gray
    if rng.random() < 0.5:
        sigma = rng.uniform(0.3, 1.2)
        img = gaussian_blur5(img, sigma)
    out = img.astype(np.float32)
    if rng.random() < 0.5:
        out = out + rng.normal(0, rng.uniform(2, 12), img.shape)
    return np.clip(out, 0, 255).astype(np.uint8)


def _identity_landmarks(id_rng, size):
    """A per-identity face shape: the base constructed face plus
    identity-specific group deformations (jaw width, eye spacing, brow
    height, nose length, mouth width) that persist across samples."""
    base = _face_landmarks(id_rng, size, mouth_open=5.0)
    d = base.copy()
    cx = d[:, 0].mean()
    jaw_w = id_rng.uniform(0.85, 1.15)
    d[0:17, 0] = cx + (d[0:17, 0] - cx) * jaw_w
    eye_sp = id_rng.uniform(0.85, 1.15)
    for sl in (slice(36, 42), slice(42, 48)):
        ec = d[sl].mean(0)
        d[sl] += (ec - [cx, ec[1]]) * (eye_sp - 1.0)
    d[17:27, 1] += id_rng.uniform(-6, 6)          # brow height
    d[27:31, 1] = (d[27, 1]
                   + (d[27:31, 1] - d[27, 1]) * id_rng.uniform(0.85, 1.2))
    mouth_w = id_rng.uniform(0.85, 1.15)
    mc = d[48:68].mean(0)
    d[48:68, 0] = mc[0] + (d[48:68, 0] - mc[0]) * mouth_w
    return d


def _vary(lm, rng, size):
    """Within-identity variation: mouth opening, small rigid motion."""
    d = lm.copy()
    gap = rng.uniform(0, 9)
    my = d[60:68, 1].mean()
    d[60:68, 1] = my + np.sign(d[60:68, 1] - my) * gap / 2
    d[48:60, 1] += np.sign(d[48:60, 1] - d[48:60, 1].mean()) * gap * 0.25
    ang = rng.uniform(-0.06, 0.06)
    c, s = np.cos(ang), np.sin(ang)
    ctr = d.mean(0)
    d = (d - ctr) @ np.array([[c, -s], [s, c]]).T + ctr
    d += rng.uniform(-6, 6, 2)
    return d


def _to_crop(lm300, img300, rng):
    """size-300 render -> load 286 -> random 256 crop, landmark + face
    window transforms exactly as data/umlvd_ifw.py (no flip)."""
    from animateportrait_tpu_torch.utils.image import resize_bicubic

    img = resize_bicubic(img300, (LOAD, LOAD))
    tx = int(rng.integers(0, LOAD - CROP + 1))
    ty = int(rng.integers(0, LOAD - CROP + 1))
    crop = img[ty:ty + CROP, tx:tx + CROP]
    lm = lm300 * (LOAD / 300.0) - [tx, ty]
    x1 = int(round(0.15 * LOAD - tx))
    y1 = int(round(0.20 * LOAD - ty))
    win = np.array([x1, x1 + WIN, y1, y1 + WIN], np.int32)
    return crop, lm.astype(np.float32), win


def build_landmark_set(n, seed):
    rng = np.random.default_rng(seed)
    imgs = np.empty((n, CROP, CROP), np.uint8)
    lms = np.empty((n, 68, 2), np.float32)
    wins = np.empty((n, 4), np.int32)
    for i in range(n):
        lm300 = _vary(_identity_landmarks(
            np.random.default_rng(seed * 70001 + i), 300), rng, 300)
        img300 = _render_drawing_aug(lm300, 300, rng)
        imgs[i], lms[i], wins[i] = _to_crop(lm300, img300, rng)
    return imgs, lms, wins


def build_identity_set(n_ids, per_id, seed):
    rng = np.random.default_rng(seed + 9)
    n = n_ids * per_id
    imgs = np.empty((n, CROP, CROP), np.uint8)
    wins = np.empty((n, 4), np.int32)
    labels = np.empty((n,), np.int32)
    k = 0
    for i in range(n_ids):
        base = _identity_landmarks(np.random.default_rng(seed * 31 + i), 300)
        for _ in range(per_id):
            lm300 = _vary(base, rng, 300)
            img300 = _render_drawing_aug(lm300, 300, rng)
            imgs[k], _, wins[k] = _to_crop(lm300, img300, rng)
            labels[k] = i
            k += 1
    # shuffle: samples are generated grouped by identity, and the
    # trainers hold out the FIRST n_val samples — an unshuffled split
    # would hold out whole identities the classifier never saw
    perm = rng.permutation(n)
    return imgs[perm], wins[perm], labels[perm]


def cosine_lr(init: float, steps: int, step: int, alpha: float = 1e-2
              ) -> float:
    """``optax.cosine_decay_schedule(init, steps, alpha)`` at ``step``."""
    t = min(step, steps) / steps
    return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t)) + alpha)


def _unit(u8: torch.Tensor) -> torch.Tensor:
    """(N, H, W) uint8 -> (N, 1, H, W) in [-1, 1]."""
    return u8.to(torch.float32)[:, None] / 127.5 - 1.0


def mfn_loss(net, img_u8, lm, win) -> torch.Tensor:
    """The JAX tool's MobileFaceNet loss: mean((pred - lm) / CROP)^2 of
    the landmarks ``extract_landmarks`` reads off a batch."""
    from animateportrait_tpu_torch.train.module2 import extract_landmarks

    pred = extract_landmarks(net, _unit(img_u8), win)
    return torch.mean(torch.square((pred - lm) / CROP))


def init_mobilefacenet(seed: int, device) -> torch.nn.Module:
    """The stand-in's starting point: flax-style LeCun weights drawn from
    ``seed``, BatchNorm in eval mode (running mean 0, variance 1)."""
    from animateportrait_tpu_torch.models.perception import MobileFaceNet
    from animateportrait_tpu_torch.train.module2 import _lecun_init_

    return _lecun_init_(MobileFaceNet(), torch.Generator().manual_seed(
        seed)).to(device).eval()


def train_mobilefacenet(imgs, lms, wins, steps, seed, log,
                        device=DEFAULT_DEVICE):
    """Adam under the JAX tool's cosine schedule (1e-3, alpha 1e-2), batch
    32 from the samples after the first ``n_val``, which are held out.
    Returns (the net, the held-out mean landmark error in px)."""
    from animateportrait_tpu_torch.train.module2 import extract_landmarks
    from animateportrait_tpu_torch.train.optim import adam

    dev = resolve_device(device)
    n = imgs.shape[0]
    n_val = min(n // 2, max(64, n // 20))
    net = init_mobilefacenet(seed, dev)
    opt = adam(net.parameters(), 1e-3)
    imgs_t, lms_t, wins_t = (torch.as_tensor(a, device=dev)
                             for a in (imgs, lms, wins))

    @torch.no_grad()
    def val_err():
        pred = extract_landmarks(net, _unit(imgs_t[:n_val]), wins_t[:n_val])
        return float(torch.linalg.norm(pred - lms_t[:n_val], dim=-1).mean())

    rng = np.random.default_rng(seed)
    t0 = time.time()
    for it in range(steps):
        idx = torch.as_tensor(rng.integers(n_val, n, BATCH), device=dev)
        for g in opt.param_groups:
            g["lr"] = cosine_lr(1e-3, steps, it)
        opt.zero_grad(set_to_none=True)
        loss = mfn_loss(net, imgs_t[idx], lms_t[idx], wins_t[idx])
        loss.backward()
        opt.step()
        if it % 200 == 0 or it == steps - 1:
            ve = val_err()
            log(f"[mfn {it:5d}] loss {float(loss.detach()):.3e} "
                f"val px-err {ve:.2f} NME {ve / WIN * 100:.2f}% "
                f"({time.time() - t0:.0f}s)")
    return net.requires_grad_(False), val_err()


def cos_logits(f: torch.Tensor, w: torch.Tensor, scale: float = 16.0
               ) -> torch.Tensor:
    """Normalized (cosine) logits: raw fc5 magnitudes explode the cross
    entropy of plain softmax on this from-scratch PReLU stack (the JAX
    tool measured CE rising past chance at lr 5e-4)."""
    f = f / (torch.linalg.norm(f, dim=-1, keepdim=True) + 1e-6)
    w = w / (torch.linalg.norm(w, dim=0, keepdim=True) + 1e-6)
    return scale * (f @ w)


def sphere_loss(net, head, img_u8, win, lab) -> torch.Tensor:
    """Cosine cross entropy plus the feature-scale anchor: each level's
    log-RMS pulled toward 0, so every FaceLoss level lands at RMS ~1 (the
    scale the reference's FaceLoss runs at); cosine CE alone is
    scale-invariant, and the raw features drifted to O(1e4) in the JAX
    tool's first attempt."""
    from animateportrait_tpu_torch.models.perception import crop_head_bbox

    feats = net(crop_head_bbox(_unit(img_u8).repeat(1, 3, 1, 1), win))
    ce = torch.nn.functional.cross_entropy(cos_logits(feats[4], head),
                                           lab.long())
    fs = sum(torch.square(torch.log(torch.sqrt(
        torch.mean(torch.square(f)) + 1e-12))) for f in feats)
    return ce + 0.05 * fs


def init_sphere(n_ids: int, seed: int, device
                ) -> tuple[torch.nn.Module, torch.Tensor]:
    """Sphere20a with flax-style LeCun weights from ``seed`` and the
    classifier head N(0, 0.02^2) (512, n_ids) from ``seed + 1``."""
    from animateportrait_tpu_torch.models.perception import Sphere20a
    from animateportrait_tpu_torch.train.module2 import _lecun_init_

    net = _lecun_init_(Sphere20a(), torch.Generator().manual_seed(seed))
    head = torch.randn((512, n_ids), generator=torch.Generator().manual_seed(
        seed + 1)) * 0.02
    return net.to(device), head.to(device).requires_grad_(True)


def train_sphere(imgs, wins, labels, n_ids, steps, seed, log,
                 device=DEFAULT_DEVICE):
    """Adam under a cosine schedule (2e-4, alpha 1e-2), batch 32 from the
    samples after the first ``n_val``. Returns (the net, the held-out
    identity accuracy)."""
    from animateportrait_tpu_torch.models.perception import crop_head_bbox
    from animateportrait_tpu_torch.train.optim import adam

    dev = resolve_device(device)
    n = imgs.shape[0]
    n_val = min(n // 2, max(64, n // 10))
    net, head = init_sphere(n_ids, seed, dev)
    opt = adam(list(net.parameters()) + [head], 2e-4)
    imgs_t, wins_t, labels_t = (torch.as_tensor(a, device=dev)
                                for a in (imgs, wins, labels))

    def crops(sl):
        return crop_head_bbox(_unit(imgs_t[sl]).repeat(1, 3, 1, 1),
                              wins_t[sl])

    @torch.no_grad()
    def val_acc():
        feats = net(crops(slice(0, n_val)))
        hit = torch.argmax(cos_logits(feats[4], head), -1) == labels_t[:n_val]
        return float(hit.to(torch.float32).mean())

    rng = np.random.default_rng(seed)
    t0 = time.time()
    for it in range(steps):
        idx = torch.as_tensor(rng.integers(n_val, n, BATCH), device=dev)
        for g in opt.param_groups:
            g["lr"] = cosine_lr(2e-4, steps, it)
        opt.zero_grad(set_to_none=True)
        loss = sphere_loss(net, head, imgs_t[idx], wins_t[idx],
                           labels_t[idx])
        loss.backward()
        opt.step()
        if it % 200 == 0 or it == steps - 1:
            log(f"[sphere {it:5d}] ce {float(loss.detach()):.3f} val id-acc "
                f"{val_acc() * 100:.1f}% ({time.time() - t0:.0f}s)")
    acc = val_acc()
    with torch.no_grad():
        rms = [float(torch.sqrt(torch.mean(torch.square(f))))
               for f in net(crops(slice(0, 32)))]
    log("[sphere] feature RMS per level: "
        + " ".join(f"{r:.3f}" for r in rms)
        + " (FaceLoss operates on raw L1 of these)")
    return net.requires_grad_(False), acc


def main(argv=None) -> dict:
    from animateportrait_tpu_torch.io import to_flax
    from animateportrait_tpu_torch.io.checkpoint import save_flax_npz

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("outdir", nargs="?", default=os.path.join(
        tempfile.gettempdir(), "standin_frozen"))
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--sphere_steps", type=int, default=1500)
    ap.add_argument("--n_faces", type=int, default=3000)
    ap.add_argument("--ids", type=int, default=48)
    ap.add_argument("--per_id", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip_mfn", action="store_true",
                    help="keep an existing mobilefacenet.flax.npz")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    os.makedirs(args.outdir, exist_ok=True)
    logf = open(os.path.join(args.outdir, "train_log.txt"), "a")

    def log(msg):
        print(msg, flush=True)
        print(msg, file=logf, flush=True)

    ve = None
    if not args.skip_mfn:
        log(f"[data] rendering {args.n_faces} landmark faces...")
        imgs, lms, wins = build_landmark_set(args.n_faces, args.seed)
        mfn, ve = train_mobilefacenet(imgs, lms, wins, args.steps,
                                      args.seed, log, dev)
        save_flax_npz(os.path.join(args.outdir, "mobilefacenet.flax.npz"),
                      to_flax.mobilefacenet_variables(mfn.state_dict()))
        log(f"[mfn] saved; held-out px-err {ve:.2f} "
            f"(NME {ve / WIN * 100:.2f}% of the {WIN}px face window)")

    log(f"[data] rendering {args.ids}x{args.per_id} identity faces...")
    id_imgs, id_wins, id_labels = build_identity_set(
        args.ids, args.per_id, args.seed)
    sphere, acc = train_sphere(id_imgs, id_wins, id_labels, args.ids,
                               args.sphere_steps, args.seed, log, dev)
    save_flax_npz(os.path.join(args.outdir, "sphere.flax.npz"),
                  to_flax.sphere20a_variables(sphere.state_dict()))
    log(f"[sphere] saved; held-out identity accuracy {acc * 100:.1f}%")
    logf.close()
    summary = {"mfn_val_px_err": ve,
               "mfn_nme_pct": None if ve is None else ve / WIN * 100,
               "sphere_val_acc": acc, "steps": args.steps,
               "sphere_steps": args.sphere_steps}
    with open(os.path.join(args.outdir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
