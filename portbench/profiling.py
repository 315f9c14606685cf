"""The traced run's device record: ``torch.profiler`` over the measured
window, reduced in memory to the device's busy time (the union of every
kernel, memcpy and memset interval), the time by kernel name, and the
idle gaps labelled by the host op that was running. Nothing is written
to disk; the raw events are dropped once reduced."""
from __future__ import annotations

import contextlib
import heapq

import torch

WINDOW_SPAN = "portbench.window"
# idle gaps shorter than this are pooled under one label
SHORT_GAP_NS = 20_000
TOP = 10


class Tracer:
    """Profiles one window (``with tracer.window(): ...``)."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.prof = None

    @contextlib.contextmanager
    def window(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        with self.prof:
            with torch.profiler.record_function(WINDOW_SPAN):
                yield
                if self.cuda:
                    torch.cuda.synchronize()

    def summary(self) -> dict:
        return summarize(self.prof.profiler.kineto_results.events())


def _union(intervals: list) -> tuple[int, list]:
    """(covered ns, merged intervals) of sorted (start, end) pairs."""
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def summarize(events) -> dict:
    """busy_s, window_s, the device ops with most time and the idle gaps
    by the host op under them, from kineto events."""
    cuda_type = torch.autograd.DeviceType.CUDA
    ws = we = None
    dev, cpu = [], []
    for ev in events:
        s, d = ev.start_ns(), ev.duration_ns()
        if ev.device_type() == cuda_type:
            # the host's spans mirrored on the device's timeline are no
            # device work
            if not (ev.is_user_annotation()
                    or ev.name().startswith("portbench.")):
                dev.append((s, s + d, ev.name()))
        else:
            if ev.name() == WINDOW_SPAN:
                ws, we = s, s + d
            cpu.append((s, s + d, ev.name()))
    if ws is None:
        raise RuntimeError("the traced window's span is missing")
    dev = sorted((max(s, ws), min(e, we), n) for s, e, n in dev
                 if e > ws and s < we)
    by_name: dict[str, int] = {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0) + (e - s)
    busy_ns, merged = _union([(s, e) for s, e, _ in dev])
    gaps, at = [], ws
    for s, e in merged:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if we > at:
        gaps.append((at, we))
    # label each gap by the innermost host op under its midpoint
    cpu.sort()
    heap, i, labels = [], 0, {}
    for s, e in sorted(gaps, key=lambda g: (g[0] + g[1]) // 2):
        n = e - s
        if n < SHORT_GAP_NS:
            key = f"gaps under {SHORT_GAP_NS // 1000} us"
        else:
            mid = (s + e) // 2
            while i < len(cpu) and cpu[i][0] <= mid:
                heapq.heappush(heap, (-cpu[i][0], cpu[i][1], cpu[i][2]))
                i += 1
            while heap and heap[0][1] < mid:
                heapq.heappop(heap)
            key = heap[0][2] if heap else "no host op"
        labels[key] = labels.get(key, 0) + n
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    top_gaps = sorted(labels.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_ns / 1e9, "window_s": (we - ws) / 1e9,
            "kernel_s": {n: t / 1e9 for n, t in by_name.items()},
            "device_ops": [[n[:160], t / 1e9] for n, t in top_ops],
            "idle_gaps": [[n[:160], t / 1e9] for n, t in top_gaps]}
