"""Shared helpers for the tests of the PyTorch port (tests/test_torch_*.py):
layout conversions, differences, PSNR, the fixture that skips the
card-only tests on a machine without a CUDA device, the thread count of a
pytest-xdist worker, and the biases whose gradient an InstanceNorm
cancels."""
import os

import numpy as np
import pytest
import torch

# Each pytest-xdist worker is a process of its own, and torch starts one
# intra-op thread per core in each: six workers on eight cores then run ~50
# spinning OpenMP threads, and the port's end-to-end tests took up to eight
# times as long as alone.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(2)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2) \
        .contiguous()


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).cpu().numpy()


def maxdiff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def psnr(a, b, peak: float = 2.0) -> float:
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(peak ** 2 / mse)


@pytest.fixture
def cuda_device():
    """The CUDA device for a test marked ``cuda``; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def in_cancelled_biases(net) -> set:
    """The names of the biases of convs that an InstanceNorm follows: their
    gradient is 0 in exact arithmetic (the norm removes any constant), and
    rounding noise in fp32."""
    from animateportrait_tpu_torch.nn import InstanceNorm2d

    out = set()
    for name, mod in net.named_modules():
        kids = list(mod.named_children())
        for (a, m), (_, nxt) in zip(kids, kids[1:]):
            if isinstance(m, torch.nn.modules.conv._ConvNd) and isinstance(
                    nxt, InstanceNorm2d) and m.bias is not None:
                out.add(f"{name}.{a}.bias".lstrip("."))
    return out
