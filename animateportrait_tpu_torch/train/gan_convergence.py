"""Module2 GAN convergence run: the port of the JAX package's
``tools/overfit_convergence.py``.

Builds a small constructed dataset whose drawings are a deterministic
function of face geometry (white background and black strokes drawn along
the 68 landmarks; photos are shaded face blobs of the same geometry),
then drives the port's trainer (``python -m
animateportrait_tpu_torch.train_cli``: the full GAN step, G twice, the five
discriminators, the frozen nets, the TPS warps, both Adams and the image
pool) for a few hundred steps, stopping once at half the steps and resuming
with ``--continue_train --epoch latest``. ``summarize`` then reads
``metrics.jsonl`` and writes the first- and last-window loss means, and
asserts that every loss stayed finite and that ``warp_B`` fell (reference
loop: Module2/train.py:19-63).

The landmarks and the order of every draw from the numpy generator are the
JAX tool's, so the two datasets have the same geometry. The drawing is the
port's own, with ``utils/image.py``'s OpenCV primitives (``draw_thick_line``
and ``_line2`` for strokes, ``_fill_convex`` for the hulls and polygons,
``_fill_disc`` for the dots, a max filter for ``cv2.dilate``): the dots and
the part masks, which OpenCV draws 8-connected, are the JAX tool's bytes;
its ``LINE_AA`` anti-aliasing of the strokes and the photos' fills is not
drawn, so those differ at their edges. The run is a learning curve, not a
parity check.

    python -m animateportrait_tpu_torch.train.gan_convergence [workdir]
        [--steps 300] [--crop 128] [--ngf 32] [--steps_per_epoch 50]
        [--frozen_dir DIR] [--out FILE] [--device cuda]

``--frozen_dir`` takes the stand-in frozen nets of
``train/standin_frozen.py``; without it the frozen nets are random.
``--out`` defaults to ``<workdir>/convergence.md``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

from animateportrait_tpu_torch.utils.device import DEFAULT_DEVICE

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SHIFT = 16                          # OpenCV drawing's fixed point


def _face_landmarks(rng, size, mouth_open):
    """A coherent 68-pt face: jaw arc, brows, nose, eyes, mouth whose
    inner-lip gap follows ``mouth_open`` (the learnable motion)."""
    cx, cy = size / 2 + rng.uniform(-8, 8), size / 2 + rng.uniform(-8, 8)
    w, h = size * 0.30, size * 0.38
    t = np.linspace(0, np.pi, 17)
    jaw = np.stack([cx - w * np.cos(t), cy - h * 0.15 + h * np.sin(t)], 1)
    brow_l = np.stack([np.linspace(cx - w * .7, cx - w * .2, 5),
                       np.full(5, cy - h * .45)], 1)
    brow_r = np.stack([np.linspace(cx + w * .2, cx + w * .7, 5),
                       np.full(5, cy - h * .45)], 1)
    nose_v = np.stack([np.full(4, cx), np.linspace(cy - h * .3, cy, 4)], 1)
    nose_b = np.stack([np.linspace(cx - w * .15, cx + w * .15, 5),
                       np.full(5, cy + h * .08)], 1)
    a6 = np.linspace(0, 2 * np.pi, 7)[:6]
    eye_l = np.stack([cx - w * .45 + w * .12 * np.cos(a6),
                      cy - h * .28 + h * .04 * np.sin(a6)], 1)
    eye_r = np.stack([cx + w * .45 + w * .12 * np.cos(a6),
                      cy - h * .28 + h * .04 * np.sin(a6)], 1)
    a12 = np.linspace(0, 2 * np.pi, 13)[:12]
    my = cy + h * .45
    mouth_o = np.stack([cx + w * .32 * np.cos(a12),
                        my + (h * .06 + mouth_open) * np.sin(a12)], 1)
    a8 = np.linspace(0, 2 * np.pi, 9)[:8]
    mouth_i = np.stack([cx + w * .18 * np.cos(a8),
                        my + mouth_open * np.sin(a8)], 1)
    lm = np.concatenate([jaw, brow_l, brow_r, nose_v, nose_b,
                         eye_l, eye_r, mouth_o, mouth_i], 0)
    return lm.astype(np.float64)


# --- drawing (OpenCV's primitives without anti-aliasing) ---------------------

# the strokes of a drawing: (landmark indices, closed)
STROKES = ((range(0, 17), False), (range(17, 22), False),
           (range(22, 27), False), (range(27, 31), False),
           (range(31, 36), False), (range(36, 42), True),
           (range(42, 48), True), (range(48, 60), True),
           (range(60, 68), True))


def _points(lm: np.ndarray) -> list[tuple[int, int]]:
    return [tuple(int(v) for v in p) for p in lm.round().astype(np.int32)]


def polyline_mask(mask: np.ndarray, pts: list, closed: bool,
                  thickness: int) -> None:
    """``cv2.polylines`` of integer ``pts`` into ``mask`` (255), each
    segment as OpenCV draws it: a thick line, or an 8-connected one of
    thickness 1."""
    from animateportrait_tpu_torch.utils.image import _line2, draw_thick_line

    segs = list(zip(pts[:-1], pts[1:])) + ([(pts[-1], pts[0])] if closed
                                            else [])
    for p0, p1 in segs:
        if thickness >= 2:
            draw_thick_line(mask, p0, p1, thickness)
        else:
            _line2(mask, (p0[0] << _SHIFT, p0[1] << _SHIFT),
                   (p1[0] << _SHIFT, p1[1] << _SHIFT))


def convex_hull(pts: list) -> list:
    """The convex hull of integer points, its vertices in order (Andrew's
    monotone chain; the polygon ``cv2.convexHull`` returns)."""
    pts = sorted(set(pts))
    if len(pts) < 3:
        return pts

    def half(seq):
        out = []
        for p in seq:
            while len(out) >= 2 and (
                    (out[-1][0] - out[-2][0]) * (p[1] - out[-2][1])
                    - (out[-1][1] - out[-2][1]) * (p[0] - out[-2][0])) <= 0:
                out.pop()
            out.append(p)
        return out

    lower, upper = half(pts), half(pts[::-1])
    return lower[:-1] + upper[:-1]


def fill_convex_mask(mask: np.ndarray, pts: list) -> None:
    """``cv2.fillConvexPoly`` of integer ``pts`` into ``mask`` (255)."""
    from animateportrait_tpu_torch.utils.image import _fill_convex

    _fill_convex(mask, [(x << _SHIFT, y << _SHIFT) for x, y in pts],
                 integer=True)


def dilate(mask: np.ndarray, k: int = 9) -> np.ndarray:
    """``cv2.dilate(mask, np.ones((k, k)))``: the max over each k x k
    window (pixels outside the image do not count)."""
    r = k // 2
    out = np.pad(mask, r)
    out = np.max([out[:, i: i + mask.shape[1]] for i in range(k)], axis=0)
    return np.max([out[i: i + mask.shape[0]] for i in range(k)], axis=0)


def _render_drawing(lm, size):
    """Line-drawing style: white bg, black strokes along landmark loops."""
    mask = np.zeros((size, size), np.uint8)
    for idx, closed in STROKES:
        polyline_mask(mask, _points(lm[list(idx)]), closed, 2)
    img = np.full((size, size), 255, np.uint8)
    img[mask > 0] = 0
    return img


def _render_photo(lm, size, rng):
    """Shaded 'photo': gradient bg + filled face hull + dark features, as
    (size, size, 3) BGR (the JAX tool's channel order)."""
    gy = np.linspace(90, 170, size, dtype=np.float32)
    img = np.repeat(gy[:, None], size, 1)
    img = np.stack([img, img * 0.9, img * 0.8], -1).astype(np.uint8)
    parts = [(convex_hull(_points(lm)), (205, 185, 165))] + [
        (_points(lm[a:b]), (70, 50, 40)) for a, b in ((36, 42), (42, 48),
                                                      (48, 60))]
    for pts, colour in parts:
        mask = np.zeros((size, size), np.uint8)
        fill_convex_mask(mask, pts)
        img[mask > 0] = colour
    return img


def build_dataset(root, n_a=6, n_b=6, n_clip=6, size=300, seed=0):
    """The JAX tool's constructed UMLVD-IFW tree under ``root``, written
    with the port's PNG writer."""
    from animateportrait_tpu_torch.utils.image import _fill_disc, write_png

    rng = np.random.default_rng(seed)

    def put(path, arr):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # the JAX tool's arrays are BGR, as cv2.imwrite takes them
        write_png(path, arr[:, :, ::-1] if arr.ndim == 3 else arr)

    def lm_files(prefix, name, lm):
        txt = f"{root}/{prefix}_txt/MTCNN/{name}.txt"
        os.makedirs(os.path.dirname(txt), exist_ok=True)
        with open(txt, "w") as f:
            for (x, y) in lm:
                print(x, y, file=f)
        mask = np.zeros((size, size), np.uint8)
        for (x, y) in lm.round().astype(int):
            _fill_disc(mask, int(x), int(y), 2)
        dots = np.full((size, size), 255, np.uint8)
        dots[mask > 0] = 0
        put(f"{root}/{prefix}/MTCNN/{name}.png", dots)

    def masks(side, name, lm):
        for part, idx in (("nose", range(27, 36)), ("eyes", range(36, 48)),
                          ("lips", range(48, 68))):
            m = np.zeros((size, size), np.uint8)
            fill_convex_mask(m, convex_hull(_points(lm[list(idx)])))
            put(f"{root}/{side}mask/{part}/{name}.png", dilate(m))

    for i in range(n_a):
        lm = _face_landmarks(rng, size, mouth_open=rng.uniform(1, 10))
        put(f"{root}/Photo/a{i}.png", _render_photo(lm, size, rng))
        lm_files("Alm", f"a{i}", lm)
        masks("A", f"a{i}", lm)
        put(f"{root}/fakeB_static/a{i}.png", _render_drawing(lm, size))
    for i in range(n_b):
        lm = _face_landmarks(rng, size, mouth_open=rng.uniform(1, 10))
        put(f"{root}/Drawing/b{i}.png", _render_drawing(lm, size))
        lm_files("Blm", f"b{i}", lm)
        masks("B", f"b{i}", lm)
    # one film clip: a mouth-opening sequence (consecutive-frame pairs
    # for the coherence D)
    base = _face_landmarks(rng, size, mouth_open=1.0)
    for i in range(n_clip):
        lm = base.copy()
        lm[60:68, 1] += np.sin(i / (n_clip - 1) * np.pi) * 8 * np.sign(
            lm[60:68, 1] - lm[60:68, 1].mean())
        name = f"scanner_frag_0_MTCNN/f{i}"
        put(f"{root}/Drawing/{name}.png", _render_drawing(lm, size))
        lm_files("Blm", name, lm)
        with open(f"{root}/Blm_txt/MTCNN/{name}_win.txt", "w") as f:
            mn, mx = lm.min(0), lm.max(0)
            print(mn[0], mx[0], mn[1], mx[1], file=f)
        masks("B", name, lm)


# --- training and the record -------------------------------------------------

def train_argv(root, ckpt_dir, crop, steps_per_epoch, ngf, print_freq=10,
               frozen_dir=None, device=DEFAULT_DEVICE) -> list[str]:
    """The JAX tool's ``train_cli`` flags (the readme's drawing command at
    ``crop`` and ``ngf``), the port's ``--device``, and one card
    (``--data_parallel 1``: the flag's default takes every visible card,
    and the record is the one-card trainer's)."""
    return [
        "--dataroot", root, "--name", "overfit", "--model",
        "geomgm_ifw_fore", "--netG", "resnet_9blocks_rcatland32_full_ifw",
        "--netg_resb_div", "3", "--netg_resb_disp", "3",
        "--output_nc", "1", "--lr", "0.00005",
        "--lambda_geom", "50", "--lambda_geom_lipline", "50",
        "--more_weight_for_lip", "2", "--lambda_face", "3.0",
        "--lambda_warp_inter", "10", "--blendbg", "1",
        "--select_target12_thre", "0.3", "--niter", "100",
        "--niter_decay", "0",
        "--crop_size", str(crop), "--load_size", str(int(crop * 286 / 256)),
        "--ngf", str(ngf), "--ndf", str(ngf),
        "--checkpoints_dir", ckpt_dir,
        "--steps_per_epoch", str(steps_per_epoch),
        "--print_freq", str(print_freq),
        "--display_freq", str(steps_per_epoch),
        "--save_latest_freq", str(steps_per_epoch),
        # a nonexistent dir -> random frozen nets; pass --frozen_dir with
        # train/standin_frozen.py's output to give geom_B / iden_B a
        # meaningful frozen signal
        "--frozen_dir", frozen_dir or os.path.join(ckpt_dir, "frozen-none"),
        "--device", str(device), "--data_parallel", "1",
    ]


def run_training(root, ckpt_dir, crop, steps_phase1, steps_total,
                 steps_per_epoch, ngf, print_freq=10, frozen_dir=None,
                 device=DEFAULT_DEVICE, in_process=False):
    """Train to ``steps_phase1``, then resume to ``steps_total``: each
    phase a ``python -m animateportrait_tpu_torch.train_cli`` process, or,
    ``in_process``, a ``train_cli.main`` call in this one (whose kernel
    counters then count its launches)."""
    # absolute paths: the processes run from the repository's root
    common = train_argv(os.path.abspath(root), os.path.abspath(ckpt_dir),
                        crop, steps_per_epoch, ngf, print_freq,
                        frozen_dir and os.path.abspath(frozen_dir), device)
    phases = (("phase 1", common + ["--max_steps", str(steps_phase1)]),
              ("phase 2 (resume)", common + [
                  "--max_steps", str(steps_total), "--continue_train",
                  "--epoch", "latest"]))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    for what, argv in phases:
        print(f"[overfit] {what}: -> {argv[argv.index('--max_steps') + 1]} "
              "steps")
        if in_process:
            from animateportrait_tpu_torch import train_cli
            train_cli.main(argv)
        else:
            subprocess.run([sys.executable, "-m",
                            "animateportrait_tpu_torch.train_cli", *argv],
                           check=True, env=env, cwd=REPO)


def read_metrics(ckpt_dir) -> list[dict]:
    with open(os.path.join(ckpt_dir, "overfit", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def summarize(ckpt_dir, out_md, window=8):
    rows = read_metrics(ckpt_dir)
    keys = [k for k in rows[0] if k not in ("epoch", "iters")]
    first = {k: float(np.mean([r[k] for r in rows[:window]])) for k in keys}
    last = {k: float(np.mean([r[k] for r in rows[-window:]])) for k in keys}
    lines = [
        "# Module2 GAN convergence run (constructed dataset)",
        "",
        f"Full `train_cli` 5-discriminator step, {rows[-1]['iters']} steps"
        f" (resume exercised mid-run), reduced resolution.",
        "Loss means over the first vs last "
        f"{window} log windows (`metrics.jsonl`):",
        "",
        "| loss | first | last | delta |",
        "|---|---|---|---|",
    ]
    for k in sorted(keys):
        d = last[k] - first[k]
        lines.append(f"| {k} | {first[k]:.4f} | {last[k]:.4f} | "
                     f"{d:+.4f} |")
    verdicts = []
    for k in ("warp_B", "iden_B", "geom_B"):
        if k in first:
            ok = last[k] < first[k]
            word = "DECREASED" if ok else "did NOT decrease"
            verdicts.append(f"- `{k}` {word} ({first[k]:.4f} -> "
                            f"{last[k]:.4f})")
    ga = [r.get("G_A") for r in rows if "G_A" in r]
    da = [r.get("D_A") for r in rows if "D_A" in r]
    if da:
        verdicts.append(
            f"- adversarial pair stayed finite and in the lsgan band: "
            f"D_A in [{min(da):.3f}, {max(da):.3f}], "
            f"G_A in [{min(ga):.3f}, {max(ga):.3f}]")
    lines += ["", *verdicts, "",
              "Landmark-overlay visuals (`fake_B_lm_68_vis*`) are under "
              f"`{os.path.join(ckpt_dir, 'overfit', 'web', 'images')}`."]
    with open(out_md, "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    # hard assertions: the run is evidence only if these hold
    assert all(np.isfinite(list(r[k] for k in keys)).all() for r in rows)
    assert last.get("warp_B", 0) < first.get("warp_B", 1), "warp_B rose"
    return first, last


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("workdir", nargs="?", default=os.path.join(
        tempfile.gettempdir(), "overfit_run"))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--crop", type=int, default=128)
    ap.add_argument("--ngf", type=int, default=32)
    ap.add_argument("--steps_per_epoch", type=int, default=50)
    ap.add_argument("--out", default=None,
                    help="the summary (default <workdir>/convergence.md)")
    ap.add_argument("--frozen_dir", default=None,
                    help="trained stand-in frozen nets "
                         "(train/standin_frozen.py output)")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)

    root = os.path.join(args.workdir, "drawing")
    ckpt = os.path.join(args.workdir, "ckpt")
    if not os.path.isdir(root):
        print("[overfit] building constructed dataset")
        build_dataset(root)
    run_training(root, ckpt, args.crop, args.steps // 2, args.steps,
                 args.steps_per_epoch, args.ngf, frozen_dir=args.frozen_dir,
                 device=args.device)
    return summarize(ckpt, args.out or os.path.join(args.workdir,
                                                    "convergence.md"))


if __name__ == "__main__":
    main()
