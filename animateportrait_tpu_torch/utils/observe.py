"""Observability of the trainer: the loss log, the visual gallery, the
landmark overlays and the step timer. Port of
``animateportrait_tpu/utils/observe.py`` (reference: the Visualizer of
Module2/util/visualizer.py without its visdom server): losses go to stdout,
``loss_log.txt`` in the reference's format (:91-94, 176+) and
``metrics.jsonl``; snapshots go to a static HTML gallery
(``<dir>/web/index.html``, util/html.py), written with the port's PNG
writer. The JAX package's compile cache and profiler helpers belong to JAX
and are not carried over.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np

from animateportrait_tpu_torch.utils.image import write_png


class LossLogger:
    """Append-only scalar log: stdout + loss_log.txt + metrics.jsonl."""

    def __init__(self, directory: str, name: str = "experiment"):
        self.dir = os.path.join(directory, name)
        os.makedirs(self.dir, exist_ok=True)
        self.log_path = os.path.join(self.dir, "loss_log.txt")
        self.jsonl_path = os.path.join(self.dir, "metrics.jsonl")
        with open(self.log_path, "a") as f:
            now = time.strftime("%c")
            f.write(f"================ Training Loss ({now}) ================\n")
        self._t_last = time.time()

    def log(self, epoch: int, iters: int, losses: dict,
            t_comp: float | None = None, t_data: float | None = None):
        """Reference print format (visualizer.py:176-190)."""
        t_comp = t_comp if t_comp is not None else time.time() - self._t_last
        self._t_last = time.time()
        msg = "(epoch: %d, iters: %d, time: %.3f, data: %.3f) " % (
            epoch, iters, t_comp, t_data or 0.0)
        for k, v in losses.items():
            msg += "%s: %.3f " % (k, float(v))
        print(msg)
        with open(self.log_path, "a") as f:
            f.write(msg + "\n")
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(
                {"epoch": epoch, "iters": iters,
                 **{k: float(v) for k, v in losses.items()}}) + "\n")

    def save_visuals(self, visuals: dict, epoch: int,
                     iters: int | None = None, update_html: bool = True):
        """Image snapshot gallery: <dir>/web/images + index.html.

        Reference visualizer parity (visualizer.py:107-143 + util/html.py,
        no visdom server): each call saves one labeled snapshot row; the
        HTML index lists snapshots newest-first like the reference's
        epoch-header gallery. ``iters`` distinguishes mid-epoch snapshots
        (display_freq cadence); ``update_html`` gates the index rewrite
        (update_html_freq / --no_html). The PNGs come from ``write_png``."""
        img_dir = os.path.join(self.dir, "web", "images")
        os.makedirs(img_dir, exist_ok=True)
        tag = (f"epoch{epoch:03d}_iter{iters:07d}" if iters is not None
               else f"epoch{epoch:03d}")
        for label, img in visuals.items():
            arr = np.asarray(img)
            if arr.ndim == 4:
                arr = arr[0]
            if arr.dtype != np.uint8:
                arr = np.clip((arr + 1.0) * 127.5, 0, 255).astype(np.uint8)
            if arr.shape[-1] == 1:
                arr = np.repeat(arr, 3, axis=-1)
            write_png(os.path.join(img_dir, f"{tag}_{label}.png"), arr)
        if update_html:
            self.write_html_index()

    def write_html_index(self):
        """(Re)write <dir>/web/index.html with ALL snapshots on disk,
        newest first (util/html.py gallery equivalent).

        Rebuilt from the images directory, not the in-memory list: the
        reference gallery accumulates every epoch header for the life of
        the experiment, so a resumed run (fresh logger) or a run past
        the in-memory cap must not drop older snapshots from the index.
        """
        import re

        index = os.path.join(self.dir, "web", "index.html")
        img_dir = os.path.join(self.dir, "web", "images")
        os.makedirs(img_dir, exist_ok=True)
        pat = re.compile(r"^(epoch(\d+)(?:_iter(\d+))?)_(.+)\.png$")
        groups: dict[tuple, list] = {}
        for fn in os.listdir(img_dir):
            m = pat.match(fn)
            if not m:
                continue
            tag, ep, it, label = m.groups()
            key = (int(ep), -1 if it is None else int(it), tag)
            groups.setdefault(key, []).append((label, fn))
        with open(index, "w") as f:
            f.write("<html><body><h1>Training results</h1>\n")
            for (ep, it, tag) in sorted(groups, reverse=True):
                title = (f"epoch [{ep}] iters [{it}]" if it >= 0
                         else f"epoch [{ep}]")
                f.write(f"<h3>{title}</h3><table><tr>\n")
                for label, fn in sorted(groups[(ep, it, tag)]):
                    f.write(f"<td><p>{label}</p>"
                            f"<img src='images/{fn}' width=256></td>\n")
                f.write("</tr></table>\n")
            f.write("</body></html>\n")


def draw_lm_overlay(img, lm, win=None, hradius: int = 2) -> np.ndarray:
    """Landmark-overlay self-check image (`fake_B_lm_68_vis`/`_vist`):
    red squares at each landmark plus the face-window rectangle, drawn the
    reference way (channel 0 := 1, others := -1 in +-hradius windows;
    geomgm_ifw_fore_model.py get_lmvis / geomcgt_ifw_test_model.py:228-252).

    img: (H, W, C) or (N, H, W, C) in [-1, 1] (first item used);
    lm: (68, 2) or (N, 68, 2) (x, y) pixels; win: (4,) or (N, 4)
    [x1, x2, y1, y2]. Returns (H, W, 3) float in [-1, 1].
    """
    a = np.asarray(img, np.float32)
    if a.ndim == 4:
        a = a[0]
    if a.shape[-1] == 1:
        a = np.repeat(a, 3, axis=-1)
    out = a.copy()
    H, W = out.shape[:2]
    L = np.asarray(lm)
    if L.ndim == 3:
        L = L[0]

    def mark(y0, y1, x0, x1):
        y0, y1 = max(0, y0), min(H, y1)
        x0, x1 = max(0, x0), min(W, x1)
        if y0 < y1 and x0 < x1:
            out[y0:y1, x0:x1, 0] = 1.0
            out[y0:y1, x0:x1, 1:] = -1.0

    for k in range(L.shape[0]):
        x = int(round(float(L[k, 0])))
        y = int(round(float(L[k, 1])))
        mark(y - hradius, y + hradius, x - hradius, x + hradius)
    if win is not None:
        w = np.asarray(win).reshape(-1, 4)[0].astype(int)
        x1, x2, y1, y2 = w
        mark(y1 - hradius, y1 + hradius, x1 - hradius, x2 + hradius)
        mark(y2 - hradius, y2 + hradius, x1 - hradius, x2 + hradius)
        mark(y1 - hradius, y2 + hradius, x1 - hradius, x1 + hradius)
        mark(y1 - hradius, y2 + hradius, x2 - hradius, x2 + hradius)
    return out


class StepTimer:
    """Per-step wall-clock stats (the compute/data split of train.py:26-47),
    and their sums: the share of the time the loop waited for data
    (``data_share``)."""

    def __init__(self):
        self.t0 = time.time()
        self.data_s = self.comp_s = 0.0
        self.data_total = self.comp_total = 0.0

    def data_done(self):
        now = time.time()
        self.data_s = now - self.t0
        self.data_total += self.data_s
        self.t0 = now

    def step_done(self):
        now = time.time()
        self.comp_s = now - self.t0
        self.comp_total += self.comp_s
        self.t0 = now
        return self.comp_s, self.data_s

    def data_share(self) -> float:
        total = self.data_total + self.comp_total
        return self.data_total / total if total > 0 else 0.0
