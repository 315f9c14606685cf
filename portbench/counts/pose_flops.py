"""FLOPs of one pose-transfer train step (``pose_transfer_train``),
counted as ``flops.py`` counts the others: ``FlopCounterMode`` over the
plain reference step (``reference/pose.py:PoseStep.grads``) on the
``meta`` device, so shapes alone and the same count whatever a later
change does to the port. Forward and backward of G, D and the frozen
flow net and VGG19 (the input gradient through VGG19 and D that G's loss
needs); Adam's elementwise update is left out."""
from __future__ import annotations

import functools
import json

import torch

from portbench.counts.flops import _flops
from portbench.reference import pose


def step_work(cfg: dict) -> dict:
    """``{"step_flops": ...}`` of one step at the configuration's widths,
    size and batch."""
    keys = pose.TRAINER_KEYS + ("G_n_residual_blocks", "flow_nf",
                                "batch_size")
    return dict(_step_work(json.dumps({k: cfg[k] for k in keys},
                                      sort_keys=True)))


@functools.lru_cache(maxsize=None)
def _step_work(key: str) -> tuple:
    cfg = json.loads(key)
    meta = torch.device("meta")
    step = pose.PoseStep(cfg, pose.make_nets(cfg, meta))
    s, n, j = cfg["size"], cfg["batch_size"], cfg["joint_nc"]
    batch = {"img_1": torch.zeros(n, 3, s, s, device=meta),
             "img_2": torch.zeros(n, 3, s, s, device=meta),
             "kp_1": torch.zeros(n, j, 2, device=meta),
             "kp_2": torch.zeros(n, j, 2, device=meta)}
    flops, _ = _flops(lambda: step.grads(batch))
    return (("step_flops", flops),)
