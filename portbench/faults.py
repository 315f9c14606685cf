"""Faults planted in the port's timed path, to read what the comparison
makes of them (``calibrate.py --fault``) and to see ``correct`` come out
false (``tests/test_portbench_runs.py``): one for each fault a cell can
have on one card."""
from __future__ import annotations

import contextlib


def _unchanged():
    """A train step that returns its state unchanged: the pool and the
    step count move, no parameter does."""
    from animateportrait_tpu_torch.train import module2 as m2

    def keep(self, state, grads):
        state.pool, state.pool_count = grads.pool, grads.pool_count
        state.step += 1

    return m2.Module2TrainStep, "apply_grads", keep


def _half_batch():
    """A train step over the first half of the batch alone, its losses
    the mean over that half."""
    from animateportrait_tpu_torch.train import module2 as m2

    grads = m2.Module2TrainStep.grads

    def half(self, state, batch, frozen, gen, group=None):
        n = next(iter(batch.values())).shape[0] // 2
        return grads(self, state, {k: v[:n] for k, v in batch.items()},
                     frozen, gen, group)

    return m2.Module2TrainStep, "grads", half


def _frame_altered():
    """The renderer's first frame of each clip inverted where it is
    produced."""
    from animateportrait_tpu_torch.pipeline import render

    call = render.Module2Renderer.__call__

    def altered(self, *args, **kwargs):
        out = call(self, *args, **kwargs).copy()
        out[0] = 255 - out[0]
        return out

    return render.Module2Renderer, "__call__", altered


def _landmarks_altered():
    """The predicted landmarks moved by 1% of their scale where they are
    produced."""
    from animateportrait_tpu_torch.pipeline import landmark

    call = landmark.LandmarkPredictor.__call__

    def altered(self, *args, **kwargs):
        out = call(self, *args, **kwargs)
        return out + 0.01 * abs(out).max()

    return landmark.LandmarkPredictor, "__call__", altered


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "frame_altered": _frame_altered,
          "landmarks_altered": _landmarks_altered}


@contextlib.contextmanager
def planted(name: str):
    """The port with fault ``name`` in place, restored on exit."""
    owner, attr, broken = FAULTS[name]()
    sound = owner.__dict__[attr]
    setattr(owner, attr, broken)
    try:
        yield
    finally:
        setattr(owner, attr, sound)
