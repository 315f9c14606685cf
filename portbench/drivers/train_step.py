"""Module2 train steps back to back on resident batches, as a trainer of
the Module2 GAN runs them: ``build_train_step(cfg).step`` on one
``TrainState``, the window ending in a synchronize.

Set-up builds the step, its state (G, the five Ds, both Adams, the pool)
and the frozen nets on the seed's weights, makes the resident batches,
and drives the step through its first three steps, each on a batch of
its own: they warm every shape, and what they leave (the losses, Adam's
first moment after step 1, each leaf's change, the pool) is kept for the
comparison with the plain reference (``reference/train.py``). The window
then takes further steps on that same state, cycling over the batches."""
from __future__ import annotations

import contextlib
import time

import torch

from portbench.reference import train as ref_train

CHECKED_STEPS = 3


class Driver:
    """``train_step``. ``control``: the frozen reference step in TF32 in
    the port's place."""

    def __init__(self, cell, seed: int, device: torch.device,
                 control: bool = False):
        self.cfg, self.mix = cell.config, cell.traffic
        self.seed, self.device, self.control = seed, device, control

    def setup(self) -> None:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if self.control:
            from portbench.reference.frozen.train import module2 as m2
        else:
            from animateportrait_tpu_torch.train import module2 as m2
        cfg, dev = self.cfg, self.device
        self.batches = ref_train.make_batches(
            cfg, self.seed, self.mix["resident_batches"], dev)
        weights = ref_train.make_weights(cfg, self.seed, dev)
        self.step, self.state, self.frozen = ref_train.build(
            m2, cfg, weights, dev)
        del weights
        self.gen = ref_train.pool_generator(self.seed)
        if self.control:
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        start = {k: p.detach().clone()
                 for k, p in ref_train.named_leaves(self.state).items()}
        losses, grad1, pool1 = [], None, None
        for i in range(CHECKED_STEPS):
            metrics = self.step.step(self.state, self.batches[i],
                                     self.frozen, self.gen)
            losses.append({k: float(v) for k, v in metrics.items()})
            if i == 0:
                grad1 = ref_train.first_grad_norms(self.state, cfg["beta1"])
                pool1 = self.state.pool[:self.state.pool_count].clone()
        change = {k: float((p.detach() - start[k]).norm())
                  for k, p in ref_train.named_leaves(self.state).items()}
        del start
        self.got = {"losses": losses, "grad1": grad1, "change": change,
                    "pool1": pool1, "pool": self.state.pool.clone(),
                    "pool_count": self.state.pool_count}
        self.taken = CHECKED_STEPS

    def window(self, seconds: float, tracer) -> dict:
        n = len(self.batches)
        steps, failed = 0, 0
        ctx = tracer.window() if tracer else contextlib.nullcontext()
        with ctx:
            start = time.perf_counter()
            while True:
                metrics = self.step.step(
                    self.state, self.batches[(self.taken + steps) % n],
                    self.frozen, self.gen)
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
        from portbench.counts import flops

        cfg = self.cfg
        return {"steps": win["units"], "window_s": win["window_s"],
                "work": flops.train_step_work(
                    cfg["batch_size"], cfg["ngf"], cfg["ndf"],
                    cfg["crop_size"], cfg["output_nc"],
                    cfg["batch_d_passes"], cfg["pool_size"])}

    def release(self) -> None:
        self.step = self.state = self.frozen = None
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def check(self, win: dict) -> dict:
        ref = ref_train.reference_steps(self.cfg, self.seed, self.batches,
                                        self.device, CHECKED_STEPS)
        return ref_train.compare(self.got, ref)

    def close(self) -> None:
        self.batches = None
