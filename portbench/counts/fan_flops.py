"""FLOPs of one Adaptive Wing FAN train step (``fan_awing_train``),
counted as ``flops.py`` counts the others: ``FlopCounterMode`` over the
plain reference (``reference/fan.py:FANStep.losses`` and its gradient)
on the ``meta`` device, so shapes alone and the same count whatever a
later change does to the port. Forward and backward of the FAN and its
loss; Adam's elementwise update is left out."""
from __future__ import annotations

import functools
import json

import torch

from portbench.counts.flops import _flops
from portbench.reference import fan

KEYS = fan.TRAINER_KEYS + tuple(fan.SUPPORTED) + ("size", "batch_size")


def step_work(cfg: dict) -> dict:
    """``{"step_flops": ..., "forward_flops": ...}`` of one step at the
    configuration's widths, size and batch: forward and backward, and the
    forward alone."""
    return dict(_step_work(json.dumps({k: cfg[k] for k in KEYS},
                                      sort_keys=True)))


@functools.lru_cache(maxsize=None)
def _step_work(key: str) -> tuple:
    cfg = json.loads(key)
    meta = torch.device("meta")
    step = fan.FANStep(cfg, fan.make_net(cfg, meta))
    s, n = cfg["size"], cfg["batch_size"]
    hm = (n, cfg["num_landmarks"] + 1, s // cfg["heatmap_stride"],
          s // cfg["heatmap_stride"])
    args = (torch.zeros(n, cfg["in_channels"], s, s, device=meta),
            torch.zeros(hm, device=meta), torch.zeros(hm, device=meta))
    params = list(step.model.parameters())

    def forward():
        with torch.no_grad():
            step.losses(*args)

    forward_flops, _ = _flops(forward)
    flops, _ = _flops(lambda: torch.autograd.grad(
        step.losses(*args)["loss"], params))
    return (("step_flops", flops), ("forward_flops", forward_flops))
