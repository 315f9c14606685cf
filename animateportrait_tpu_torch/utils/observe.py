"""Observability of the trainers: the loss log, the visual gallery, the
landmark overlays, the step timer, the loss tracker, gradient norms and a
profiler trace. Port of ``animateportrait_tpu/utils/observe.py``
(reference: the Visualizer of Module2/util/visualizer.py without its
visdom server): losses go to stdout, ``loss_log.txt`` in the reference's
format (:91-94, 176+) and ``metrics.jsonl``; snapshots go to a static HTML
gallery (``<dir>/web/index.html``, util/html.py), written with the port's
PNG writer. ``profile_trace`` writes a ``torch.profiler`` Chrome trace
where the JAX one writes an XProf trace. The JAX package's compile cache
(``enable_compile_cache``) configures XLA and has no counterpart: the port
builds its kernels once into its build directory.

Spans: ``span(name)`` marks a phase of the program on the host (a
context manager), ``count(name, n)`` adds ``n`` to a named counter, and
``request(rid)`` sets the request id (a clip, a step) that the spans this
thread opens after it carry. ``span`` and ``count`` cost one flag read
unless a ``torch.profiler`` session is recording. While one is, a span
opens a ``record_function`` of its name, so it shows in the profiler's
trace and labels the device's idle gaps under it, and appends ``(name,
rid, parent, start_ns, end_ns)`` to an in-memory record: ``parent`` is
the index of the enclosing span of the same thread, and the times are
read with ``time.perf_counter_ns`` and exported on the profiler's clock,
Unix-epoch nanoseconds (kineto's ``start_ns()``; a Chrome trace's
``baseTimeNanoseconds`` + ``ts`` x 1000), through one offset. The first
span or count that finds a session recording after one that found none
starts a new record (two sessions with no span or count between them
share one; ``profile_trace`` starts its own). ``spans()``, ``counters()``
and ``self_ns(name)`` read it. To see the spans of a block outside the
benchmark, run it under ``profile_trace``: beside ``trace.json`` it writes
``spans.jsonl``, one span a line and the counters last.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

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


# --- spans and counters ------------------------------------------------------

# the spans one record keeps; those past it are counted under DROPPED
MAX_SPANS = 1_000_000
DROPPED = "observe.dropped_spans"


class _Thread(threading.local):
    def __init__(self):
        self.stack = []     # (record, index) of each open span, or None
        self.rid = None


_thread = _Thread()
_lock = threading.Lock()
_spans: list = []       # [name, rid, parent, start, end], perf_counter ns
_counters: dict = {}
_offset = 0             # epoch ns - perf_counter ns
_stale = True           # a span or count found no session since the reset
_NULL = contextlib.nullcontext()


def _clock_offset() -> int:
    """Unix-epoch ns minus ``perf_counter_ns``, from the closest of a few
    paired readings."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        t = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, t - (a + b) // 2)
    return best[1]


def _reset() -> None:
    """Starts a new record."""
    global _spans, _counters, _offset, _stale
    _spans, _counters, _stale = [], {}, False
    _offset = _clock_offset()


def _recording() -> bool:
    """A ``torch.profiler`` session records; the first call that finds one
    after a call that found none starts a new record."""
    global _stale
    if not _autograd_profiler._is_profiler_enabled:
        _stale = True
        return False
    if _stale:
        _reset()
    return True


class _Span:
    __slots__ = ("name", "fn", "entry")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.fn = record_function(self.name)
        self.fn.__enter__()
        stack = _thread.stack
        with _lock:
            rec = _spans
            top = stack[-1] if stack else None
            parent = top[1] if top is not None and top[0] is rec else None
            if len(rec) < MAX_SPANS:
                self.entry = [self.name, _thread.rid, parent, 0, None]
                stack.append((rec, len(rec)))
                rec.append(self.entry)
            else:
                self.entry = None
                stack.append(None)
                _counters[DROPPED] = _counters.get(DROPPED, 0) + 1
        if self.entry is not None:
            self.entry[3] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.entry is not None:
            self.entry[4] = end
        _thread.stack.pop()
        self.fn.__exit__(*exc)
        return False


def span(name: str):
    """A context manager that records the block as the span ``name`` while
    a profiler session records, and does nothing otherwise."""
    if not _recording():
        return _NULL
    return _Span(name)


def count(name: str, n: int) -> None:
    """Adds ``n`` to the counter ``name`` while a session records."""
    if not _recording():
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def timed(fn, counter: str):
    """``fn``, whose calls add their nanoseconds to ``counter`` while a
    session records; ``fn`` itself when none does."""
    if not _recording():
        return fn

    def call(*args, **kwargs):
        t = time.perf_counter_ns()
        try:
            return fn(*args, **kwargs)
        finally:
            count(counter, time.perf_counter_ns() - t)

    return call


def request(rid) -> None:
    """Sets the request id that the spans this thread opens from now on
    carry, until the next call."""
    _thread.rid = rid


def spans() -> list[tuple]:
    """The record: ``(name, rid, parent, start_ns, end_ns)`` a span in the
    order they opened; ``parent`` is the index of the enclosing span in
    this list (None at a thread's top level), the times are Unix-epoch ns
    (``end_ns`` None while the span is open)."""
    off = _offset
    return [(n, r, p, s + off, None if e is None else e + off)
            for n, r, p, s, e in list(_spans)]


def counters() -> dict:
    """The record's counters, ``DROPPED`` among them once a span was."""
    return dict(_counters)


def self_ns(name: str) -> int:
    """The spans ``name``'s time less what their child spans cover."""
    rec = spans()
    child = [0] * len(rec)
    for _, _, p, s, e in rec:
        if p is not None and e is not None:
            child[p] += e - s
    return sum(e - s - child[i] for i, (n, _, _, s, e) in enumerate(rec)
               if n == name and e is not None)


def _write_spans(path: str) -> None:
    with open(path, "w") as f:
        for n, r, p, s, e in spans():
            f.write(json.dumps({"name": n, "rid": r, "parent": p,
                                "start_ns": s, "end_ns": e}) + "\n")
        f.write(json.dumps({"counters": counters()}) + "\n")


@contextlib.contextmanager
def profile_trace(log_dir: str | None = None):
    """A ``torch.profiler`` trace of the block: CPU activity, and CUDA
    activity (the kernels by name, their device time) when a card is
    present. It starts a new span record. On exit it writes a Chrome trace
    (``chrome://tracing``, Perfetto) to ``<log_dir>/trace.json``, whose
    path the context yields, and the block's spans and counters to
    ``<log_dir>/spans.jsonl``; without ``log_dir`` a new temporary
    directory takes them."""
    log_dir = log_dir or tempfile.mkdtemp(prefix="ap_trace_")
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        _reset()
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    _write_spans(os.path.join(log_dir, "spans.jsonl"))


def grad_norms(grads) -> dict:
    """Gradient-norm measurement (the reference's CalcGradNorm context
    manager, intrinsic_flow_models/modules.py:180, and diagnose_network's
    mean |grad|, Module2/util/util.py:32-48) of a dict of gradient tensors,
    or of a module's ``.grad``s: {'global_norm', 'mean_abs'}, 0-d fp32
    tensors."""
    leaves = ([p.grad for p in grads.parameters() if p.grad is not None]
              if isinstance(grads, torch.nn.Module) else list(grads.values()))
    sq = sum(torch.sum(torch.square(g.float())) for g in leaves)
    total = sum(torch.sum(torch.abs(g.float())) for g in leaves)
    count = sum(g.numel() for g in leaves)
    return {"global_norm": torch.sqrt(torch.as_tensor(sq)),
            "mean_abs": torch.as_tensor(total) / max(count, 1)}


class Record:
    """Loss tracker (Module1/util/utils.py:31-64) with the reference's exact
    semantics, ``add`` accumulating the same value into every tracked key
    included."""

    def __init__(self, type_list):
        self.data = {t: 0.0 for t in type_list}
        self.count = {t: 0.0 for t in type_list}
        self.type_list = type_list
        self.max_min_data = None

    def add(self, new_data, c: float = 1.0):
        for t in self.type_list:
            self.data[t] += new_data
            self.count[t] += c

    def per(self, t):
        return self.data[t] / (self.count[t] + 1e-32)

    def clean(self, t):
        self.data[t], self.count[t] = 0.0, 0.0

    def is_better(self, t, greater: bool) -> bool:
        if self.max_min_data is None:
            self.max_min_data = self.data[t]
            return True
        if (self.data[t] > self.max_min_data if greater
                else self.data[t] < self.max_min_data):
            self.max_min_data = self.data[t]
            return True
        return False
