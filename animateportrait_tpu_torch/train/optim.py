"""The optimizer of the ported trainers, and their one-net step."""
from __future__ import annotations

import torch

from animateportrait_tpu_torch.utils import observe


def adam(params, lr: float, b1: float = 0.9, b2: float = 0.999,
         weight_decay: float = 0.0) -> torch.optim.Adam:
    """``optax.adam(lr, b1, b2)`` (eps 1e-8 outside the square root); with
    ``weight_decay`` the pose-transfer trainer's ``_torch_adam``, whose L2
    term joins the gradient before the moments, as torch.optim.Adam's
    does (not decoupled AdamW)."""
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=1e-8,
                            weight_decay=weight_decay)


class AdamTrainer:
    """A net and its Adam: ``step(*batch, **kw)`` runs ``losses`` (one
    forward in training mode, a dict with the total under "loss"), the
    backward and the update, leaves the step's gradients in the
    parameters' ``.grad`` and returns the detached losses.

    Spans (``utils/observe.py``, recorded only under a profiler), under
    the ``span_prefix`` each subclass names: ``<prefix>.step`` around the
    whole step, its request id the count of steps taken before it, and
    inside it ``<prefix>.grad`` (the backward) and ``<prefix>.adam`` (the
    update); a trainer's ``losses`` may open its own spans inside the
    step."""

    span_prefix: str

    def __init__(self, model: torch.nn.Module, device: torch.device,
                 lr: float, b1: float = 0.9):
        self.model = model.to(device).train()
        self.opt = adam(self.model.parameters(), lr, b1)
        self.steps = 0

    def losses(self, *batch, **kw) -> dict[str, torch.Tensor]:
        raise NotImplementedError

    def step(self, *batch, **kw) -> dict[str, torch.Tensor]:
        prefix = self.span_prefix
        observe.request(self.steps)
        with observe.span(f"{prefix}.step"):
            self.opt.zero_grad(set_to_none=True)
            m = self.losses(*batch, **kw)
            with observe.span(f"{prefix}.grad"):
                m["loss"].backward()
            with observe.span(f"{prefix}.adam"):
                self.opt.step()
        self.steps += 1
        return {k: v.detach() for k, v in m.items()}
