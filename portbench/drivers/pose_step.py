"""Pose-transfer GAN train steps back to back on resident batches, as a
trainer of the intrinsic-flow model runs them: the port's
``PoseTransferTrainer.step`` (DualUnet G with flow-warped skips, the
frozen FlowUnet and VGG19, the BatchNorm PatchGAN D, both Adams), the
window ending in a synchronize.

Set-up builds the trainer once on the seed's weights
(``reference/pose.py:make_weights``), makes the resident batches, and
drives the trainer through its first three steps, each on a batch of its
own: they warm every shape, and what they leave (each step's losses, the
first gradient, each leaf's change, the BatchNorm statistics) is kept for
the comparison with the plain reference. The window then takes further
steps on that same trainer, cycling over the batches. Same protocol as
``train_step.py``."""
from __future__ import annotations

import contextlib
import time

import torch

from portbench.reference import pose as ref_pose

CHECKED_STEPS = 3


def build_port(cfg: dict, weights: dict, device):
    """The port's ``PoseTransferTrainer`` on the weights."""
    from animateportrait_tpu_torch.models.flowunet import FlowUnet
    from animateportrait_tpu_torch.models.image_translation import (
        Vgg19Features)
    from animateportrait_tpu_torch.train import pose_transfer as pt

    ref_pose.check_config(cfg)
    pcfg = pt.PoseTransferConfig(**{k: cfg[k] for k in
                                    ref_pose.TRAINER_KEYS})
    with torch.device(device):
        nets = {"g": pt.build_g(pcfg), "d": pt.build_d(pcfg),
                "netf": FlowUnet(input_nc=2 * cfg["joint_nc"],
                                 nf=cfg["flow_nf"]),
                "vgg": Vgg19Features()}
    ref_pose.load(nets, weights)
    return pt.PoseTransferTrainer(pcfg, nets["g"], nets["netf"],
                                  nets["vgg"], d=nets["d"], device=device)


class Driver:
    """``pose_step``. ``control``: the reference step in TF32 in the
    port's place."""

    def __init__(self, cell, seed: int, device: torch.device,
                 control: bool = False):
        self.cfg, self.mix = cell.config, cell.traffic
        self.seed, self.device, self.control = seed, device, control

    def setup(self) -> None:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg, dev = self.cfg, self.device
        self.batches = ref_pose.make_batches(
            cfg, self.seed, self.mix["resident_batches"], dev)
        weights = ref_pose.make_weights(cfg, self.seed, dev)
        if self.control:
            nets = ref_pose.load(ref_pose.make_nets(cfg, dev), weights)
            self.trainer = ref_pose.PoseStep(cfg, nets)
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        else:
            self.trainer = build_port(cfg, weights, dev)
        del weights
        self.got = ref_pose.run_steps(self.trainer, self.trainer.g,
                                      self.trainer.d, self.batches,
                                      CHECKED_STEPS)
        self.taken = CHECKED_STEPS

    def window(self, seconds: float, tracer) -> dict:
        n = len(self.batches)
        steps, failed = 0, 0
        ctx = tracer.window() if tracer else contextlib.nullcontext()
        with ctx:
            start = time.perf_counter()
            while True:
                metrics = self.trainer.step(
                    self.batches[(self.taken + steps) % n])
                steps += 1
                if time.perf_counter() - start >= seconds:
                    break
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            end = time.perf_counter()
        last = torch.stack([v.float() for v in metrics.values()])
        if not bool(torch.isfinite(last).all()):
            failed = 1
        return {"units": steps, "attempted": steps, "failed": failed,
                "window_s": end - start}

    def end_to_end(self, win: dict) -> dict:
        return {"train_steps_per_s": win["units"] / win["window_s"]}

    def records(self, win: dict) -> dict:
        from portbench.counts import pose_flops

        return {"steps": win["units"], "window_s": win["window_s"],
                "work": pose_flops.step_work(self.cfg)}

    def release(self) -> None:
        self.trainer = None
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def check(self, win: dict) -> dict:
        ref = ref_pose.reference_steps(self.cfg, self.seed, self.batches,
                                       self.device, CHECKED_STEPS)
        return ref_pose.compare(self.got, ref)

    def close(self) -> None:
        self.batches = None
