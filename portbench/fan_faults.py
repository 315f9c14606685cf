"""Faults planted in the FAN trainer's timed path, as ``faults.py`` plants
the other cells' ones: the state left unchanged, the boundary feedback
between the stacks cut, the loss of the last stack alone, and half of the
batch left out. Their
readings bound the ``fan_awing_train`` limits from above. Run as
``calibrate.py``, with these faults among ``--fault``'s choices:

    python3 portbench/fan_faults.py --workload fan.step --seconds 5 \\
        --seeds 11 12 13 --fault no_boundary"""
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _unchanged():
    """A train step that leaves the FAN's parameters as they were: the
    loss, the gradients and the BatchNorm statistics are computed, no
    update lands."""
    from animateportrait_tpu_torch.train import optim

    step = optim.AdamTrainer.step

    def keep(self, *batch, **kw):
        params = list(self.model.parameters())
        start = [p.detach().clone() for p in params]
        metrics = step(self, *batch, **kw)
        with torch.no_grad():
            for p, s in zip(params, start):
                p.copy_(s)
        return metrics

    return optim.AdamTrainer, "step", keep


def _no_boundary():
    """The hourglasses' CoordConvs append their two boundary channels as
    zeros: no stack's heatmap reaches the next stack's input through them
    (the ``al`` and ``bl`` sums are kept)."""
    from animateportrait_tpu_torch.models import fan

    add_coords = fan.add_coords

    def cut(x, with_r=True, heatmap=None, with_boundary=False):
        out = add_coords(x, with_r, heatmap, with_boundary)
        if with_boundary and heatmap is not None:
            out = torch.cat([out[:, :-2], torch.zeros_like(out[:, -2:])], 1)
        return out

    return fan, "add_coords", cut


def _last_stack_only():
    """The weighted AWing loss of the last stack alone: the intermediate
    supervision of the first three stacks dropped."""
    from animateportrait_tpu_torch.models.fan import adaptive_wing_map
    from animateportrait_tpu_torch.train import fan

    def last(self, images, gt, weights):
        outputs, _ = self.model(images)
        scale = weights * self.cfg.loss_w + 1.0
        return {"loss": torch.mean(adaptive_wing_map(outputs[-1], gt)
                                   * scale)}

    return fan.FANTrainer, "losses", last


def _half_batch():
    """The step on the first half of the batch alone: the loss, the
    gradients and the BatchNorm statistics of half the faces."""
    from animateportrait_tpu_torch.train import fan

    losses = fan.FANTrainer.losses

    def half(self, images, gt, weights):
        n = images.shape[0] // 2
        return losses(self, images[:n], gt[:n], weights[:n])

    return fan.FANTrainer, "losses", half


FAULTS = {"unchanged_fan": _unchanged, "no_boundary": _no_boundary,
          "last_stack_only": _last_stack_only, "half_batch": _half_batch}


def main(argv=None) -> int:
    sys.path[0] = ROOT
    from portbench import calibrate, faults

    faults.FAULTS.update(FAULTS)
    return calibrate.main(argv)


if __name__ == "__main__":
    sys.exit(main())
