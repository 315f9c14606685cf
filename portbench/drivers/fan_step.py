"""Adaptive Wing FAN train steps back to back on resident batches, as a
trainer of the landmark detector runs them: the port's
``FANTrainer.step`` (the stacked hourglasses in training mode, the
weighted AWing loss over every stack, Adam), the window ending in a
synchronize.

Set-up builds the trainer once on the seed's weights
(``reference/fan.py:make_weights``), makes the resident batches (faces,
images and their training targets, on the host), and drives the trainer
through its first three steps, each on a batch of its own: they warm
every shape, and what they leave (each step's loss, the first gradient,
each leaf's change, the BatchNorm statistics) is kept for the comparison
with the plain reference. The window then takes further steps on that
same trainer, cycling over the batches. Same protocol as
``pose_step.py``, whose driver this one extends."""
from __future__ import annotations

import contextlib
import time

import torch

from portbench.drivers import pose_step
from portbench.reference import fan as ref_fan

CHECKED_STEPS = 3


def build_port(cfg: dict, weights: dict, device):
    """The port's ``FANTrainer`` on the weights."""
    from animateportrait_tpu_torch.train import fan as tf

    ref_fan.check_config(cfg)
    tcfg = tf.FANTrainConfig(**{k: cfg[k] for k in ref_fan.TRAINER_KEYS})
    with torch.device(device):
        model = tf.build_fan(tcfg)
    model.load_state_dict(weights)
    return tf.FANTrainer(tcfg, model, device=device)


class Driver(pose_step.Driver):
    """``fan_step``. ``control``: the reference step in TF32 in the port's
    place."""

    def setup(self) -> None:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg, dev = self.cfg, self.device
        self.batches = ref_fan.make_batches(
            cfg, self.seed, self.mix["resident_batches"], dev)
        weights = ref_fan.make_weights(cfg, self.seed, dev)
        if self.control:
            net = ref_fan.make_net(cfg, dev)
            net.load_state_dict(weights)
            self.trainer = ref_fan.FANStep(cfg, net)
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        else:
            self.trainer = build_port(cfg, weights, dev)
        del weights
        self.got = ref_fan.run_steps(self.trainer, self.trainer.model,
                                     self.batches, CHECKED_STEPS)
        self.taken = CHECKED_STEPS

    def window(self, seconds: float, tracer) -> dict:
        n = len(self.batches)
        steps, failed = 0, 0
        ctx = tracer.window() if tracer else contextlib.nullcontext()
        with ctx:
            start = time.perf_counter()
            while True:
                metrics = self.trainer.step(*ref_fan.batch_args(
                    self.batches[(self.taken + steps) % n]))
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

    def records(self, win: dict) -> dict:
        from portbench.counts import fan_flops

        return {"steps": win["units"], "window_s": win["window_s"],
                "work": fan_flops.step_work(self.cfg)}

    def check(self, win: dict) -> dict:
        ref = ref_fan.reference_steps(self.cfg, self.seed, self.batches,
                                      self.device, CHECKED_STEPS)
        return ref_fan.compare(self.got, ref)
