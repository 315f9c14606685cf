"""The port's own span record (``animateportrait_tpu_torch.utils.observe``:
``spans()``, ``counters()``), as the per-layer readers of a traced run
take it: the window's spans, since the profiler's session over the window
starts a new record. None where the port has no registry (a checkout
before it) or the record is empty."""
from __future__ import annotations

import importlib


def record():
    """``(spans, counters)`` of the port's record, or None."""
    observe = importlib.import_module(
        "animateportrait_tpu_torch.utils.observe")
    if not hasattr(observe, "spans") or not hasattr(observe, "counters"):
        return None
    spans = observe.spans()
    if not spans:
        return None
    return spans, observe.counters()


def total_ns(spans, name: str) -> int:
    """The summed durations of the closed spans ``name``."""
    return sum(e - s for n, _, _, s, e in spans
               if n == name and e is not None)
