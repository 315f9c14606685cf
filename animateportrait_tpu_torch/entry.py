"""The flagship forward step, the counterpart of the repository's
``__graft_entry__.py:entry``: the trident landmark-conditioned generator,
the hot path of end-to-end inference, with example inputs.

    from animateportrait_tpu_torch.entry import entry
    fn, args = entry()               # on the card; entry("cpu") on the CPU
    with torch.inference_mode():
        frames = fn(*args)           # (1, 1, 256, 256)

At full width (ngf 64) a forward on the card launches kernel K2 38 times.
"""
from __future__ import annotations

import numpy as np
import torch

from animateportrait_tpu_torch.models.gan import TridentGeneratorFullIFW
from animateportrait_tpu_torch.utils.device import (
    DEFAULT_DEVICE, resolve_device)
from animateportrait_tpu_torch.utils.smoke import init_random_


def entry(device: torch.device | str = DEFAULT_DEVICE, ngf: int = 64):
    """(fn, example_args). ``fn`` is ``TridentGeneratorFullIFW(output_nc=1,
    ngf, n_blocks=9, div=3, disp=3)`` in eval mode on ``device``, its
    weights seeded (``utils/smoke.py:init_random_`` from seed 0); the
    module itself, so ``fn(*example_args)`` is the forward and
    ``fn.load_state_dict`` takes other weights. ``example_args`` are its
    six inputs at 256^2, drawn from ``np.random.default_rng(0)`` in the
    JAX entry's order and laid out NCHW: the photo (1, 3, H, W), both
    landmark images (1, 1, H, W) and the motion grid (1, H, W, 2)
    uniform in [-1, 1), the flow (1, 2, H, W) standard normal, the mask
    (1, 1, H, W) ones."""
    dev = resolve_device(device)
    model = TridentGeneratorFullIFW(output_nc=1, ngf=ngf, n_blocks=9, div=3,
                                    disp=3)
    init_random_(model, torch.Generator().manual_seed(0))
    model = model.eval().to(dev)
    rng = np.random.default_rng(0)
    H = 256

    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(
            a.transpose(0, 3, 1, 2), np.float32)).to(dev)

    img = nchw(rng.uniform(-1, 1, (1, H, H, 3)))
    lm1 = nchw(rng.uniform(-1, 1, (1, H, H, 1)))
    lm2 = nchw(rng.uniform(-1, 1, (1, H, H, 1)))
    motion = torch.from_numpy(
        rng.uniform(-1, 1, (1, H, H, 2)).astype(np.float32)).to(dev)
    flow = nchw(rng.standard_normal((1, H, H, 2)))
    ifmask = torch.ones((1, 1, H, H), device=dev)
    return model, (img, lm1, lm2, motion, flow, ifmask)
