"""Device times and bounds of the port's kernels on the card: the one tool
that compares the kernel times of two checkouts.

- :func:`device_ms`: one CUDA-event pair around N back-to-back calls
  (N >= 50, enough to fill >= 1 ms), after a warm-up, divided by N. A
  ``torch.cuda._sleep`` queued first holds the device until the host has
  enqueued all N calls, so the reading is device time, not the host's
  launch rate.
- :func:`bound`: the least time the card could take for a function, the
  larger of its bytes over 3.35 TB/s and its fp32 operations over
  67 TFLOP/s (H100 SXM data sheet), and which of the two bounds it. The
  bf16 kernels compute in fp32 too; only their bytes halve.
- the main path's kernel shapes (``K1_LENGTHS``, ``K2_SHAPES``, and
  ``K2_BATCH_MIX``, K2's launches in one 8-frame batch; the bf16 render's
  ``K2_BF16_RENDER_SHAPES``), the work each call does (K2b's too), and
  the inputs and the gradient-path errors the card tests hold.

As a script it times K1 and K2 of a checkout at those shapes, and K2's 29
launches of one batch back to back, and prints one JSON line; ``--root``
names the checkout whose package is timed, so that two versions of the
kernels can be compared in one process each, on one card:

    python animateportrait_tpu_torch/utils/kernel_bench.py --root DIR \\
        [--slice-bytes 32768 65536 ...] [--out FILE]

It needs a CUDA device and imports nothing of the package at module level.
"""
from __future__ import annotations

import math
import statistics
import time

import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, HBM3
FP32_FLOPS = 67e12            # H100 SXM, fp32 outside the tensor cores

N_FFT = 1024
HOP = 256
# K1: the 6 s clip of the main path (96000 samples, one appended by
# condition_signal since 96000 % 256 == 0) and a 60 s clip
K1_LENGTHS = (96001, 960001)
# K2: InstanceNorm shapes (NCHW) of the main paths: one 8-frame batch of the
# trident generator decode, the once-per-photo style2 / encode_static
# planes, then Photo2Cartoon (ngf 32) at 256 px: hourglass blocks of 32, 16
# and 8 channels from 256^2 down to 16^2, down blocks, encoder
K2_SHAPES = [(8, 128, 128, 128), (8, 256, 64, 64), (8, 8, 256, 256),
             (8, 16, 128, 128), (8, 16, 64, 64), (8, 64, 256, 256),
             (1, 64, 512, 512), (1, 128, 256, 256), (1, 256, 128, 128),
             (1, 32, 256, 256),
             (1, 8, 256, 256), (1, 16, 128, 128), (1, 32, 16, 16),
             (1, 8, 16, 16), (1, 64, 128, 128), (1, 128, 64, 64)]
# on no path: a plane over 8 CTAs' shared memory takes the streaming branch
K2_STREAM_SHAPE = (1, 4, 1024, 1024)
# K2's launches in one 8-frame batch of the trident generator decode (both
# styles): tri01/tri02/tri12, the landmark transform, 9 resnet blocks (3 of
# them conditioned, with a third norm) and the two up blocks
K2_BATCH_MIX = {(8, 128, 128, 128): 2, (8, 256, 64, 64): 23,
                (8, 8, 256, 256): 1, (8, 16, 128, 128): 1,
                (8, 16, 64, 64): 1, (8, 64, 256, 256): 1}
# K2 in bf16 under --render_bf16 (the generator alone is bf16): the decode's
# batch shapes, then encode_static's once-per-photo planes (the stems at
# 256^2, the strided convs, the source-landmark transform)
K2_BF16_RENDER_SHAPES = list(K2_BATCH_MIX) + [
    (1, 32, 256, 256), (1, 64, 256, 256), (1, 64, 128, 128),
    (1, 128, 128, 128), (1, 128, 64, 64), (1, 8, 256, 256),
    (1, 16, 128, 128), (1, 16, 64, 64)]
def device_ms(fn, min_launches: int = 50, min_ms: float = 1.0,
              reps: int = 3, max_launches: int = 2000) -> float:
    """Device time of one call of ``fn`` in ms: the median over ``reps``
    event pairs, each around N back-to-back calls, divided by N."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    # the host's time per call sets how long the device must be held
    n = min_launches
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    est = None
    for _ in range(4):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host_s = (time.perf_counter() - t0) / n
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            # ~2x the host's enqueue time for n calls, at <= 2 GHz
            torch.cuda._sleep(int(2.0 * host_s * n * 2e9) + 1000)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / n)
        est = statistics.median(times)
        if est * n >= min_ms or n >= max_launches:
            return est
        n = min(max_launches, max(n, math.ceil(1.2 * min_ms / est)))
    return est


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(least time in ms, "bytes" or "operations") for the given work."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_work(n: int) -> tuple[int, int]:
    """(bytes, fp32 operations) of |STFT| of n samples by a real FFT: the
    signal read once, the magnitudes written once; per frame 2.5 N log2 N
    for the 1024-point real FFT, the window and the magnitude."""
    frames = n // HOP + 1
    bins = N_FFT // 2 + 1
    flops = frames * (2.5 * N_FFT * math.log2(N_FFT) + N_FFT + 3 * bins)
    return 4 * n + 4 * frames * bins, int(flops)


def k2_work(shape, elem_bytes: int = 4, stats: bool = False
            ) -> tuple[int, int]:
    """(bytes, fp32 operations) of an InstanceNorm(+ReLU) of an NCHW tensor
    of ``elem_bytes`` an element (4 fp32, 2 bf16): read once, written once,
    and with ``stats`` each plane's 12 bytes of statistics written; ~8
    operations an element (the mean, the shifted sums, the normalize and
    the ReLU)."""
    numel = math.prod(shape)
    planes = shape[0] * shape[1]
    return 2 * elem_bytes * numel + (12 * planes if stats else 0), 8 * numel


def k2b_work(shape, elem_bytes: int = 4) -> tuple[int, int]:
    """(bytes, fp32 operations) of InstanceNorm's backward from the saved
    statistics: x and the upstream gradient read once, dx written once,
    each plane's 12 bytes of statistics read; ~10 operations an element
    (xhat, the ReLU mask, the two sums, dx)."""
    numel = math.prod(shape)
    return 3 * elem_bytes * numel + 12 * shape[0] * shape[1], 10 * numel


# elements whose float64 pre-ReLU output lies within this of the kink may
# fall on either side of K2's fp32 output
KINK = 1e-4


def k2_gradient_errors(x: torch.Tensor, g: torch.Tensor,
                       relu: bool) -> dict:
    """K2's gradient path (K2 forward with saved statistics, K2b backward)
    on ``x`` with upstream gradient ``g``, against autograd in float64 and
    through the plain version, on the function the forward computed: with
    ReLU, ``g`` masked by K2's own output (y > 0), the derivative K2b must
    apply. Returns the largest |diff| of each over the largest |dx|
    (``vs_f64``, ``vs_plain``, and ``plain_vs_f64``), the forward's largest
    |diff| to the plain version (``fwd``), and the elements whose side of
    the kink float64 puts elsewhere (``flips``; each must lie within
    ``KINK`` of it, else this raises)."""
    from animateportrait_tpu_torch.ops import instnorm

    F = torch.nn.functional
    xk = x.detach().clone().requires_grad_()
    y = instnorm.instance_norm(xk, relu=relu)
    dx = {"path": torch.autograd.grad(y, xk, g)[0].double()}
    y = y.detach()
    fwd = float((y - instnorm.instance_norm_plain(x, relu=relu)).abs().max())
    y64 = F.instance_norm(x.double(), eps=1e-5)
    flips = 0
    if relu:
        mask = y > 0
        flipped = mask != (y64 > 0)
        if bool((y64.abs()[flipped] > KINK).any()):
            raise AssertionError("K2's ReLU mask differs from float64's "
                                 "away from the kink")
        flips = int(flipped.sum())
        g = g * mask
    for name, fn, xin in (("plain", instnorm.instance_norm_plain, x),
                          ("f64", lambda v: F.instance_norm(v, eps=1e-5),
                           x.double())):
        xr = xin.detach().clone().requires_grad_()
        dx[name] = torch.autograd.grad(fn(xr), xr, g.to(xin.dtype))[
            0].double()
    top = float(dx["f64"].abs().max())

    def rel(a, b):
        return float((dx[a] - dx[b]).abs().max()) / top

    return {"vs_f64": rel("path", "f64"), "vs_plain": rel("path", "plain"),
            "plain_vs_f64": rel("plain", "f64"), "fwd": fwd, "flips": flips}


def k2_input(shape, device, seed: int = 0) -> torch.Tensor:
    """Activations with per-channel scales in [1, 2) and offsets ~N(0, 10^2):
    means up to tens of standard deviations."""
    g = torch.Generator(device=device).manual_seed(seed)
    n, c = shape[:2]
    return (torch.randn(shape, generator=g, device=device)
            * (1 + torch.rand((n, c, 1, 1), generator=g, device=device))
            + 10 * torch.randn((n, c, 1, 1), generator=g, device=device))


def _main() -> None:
    import argparse
    import json
    import os
    import subprocess
    import sys

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=".",
                   help="checkout whose animateportrait_tpu_torch is timed")
    p.add_argument("--slice-bytes", type=int, nargs="*", default=[],
                   help="K2 per-CTA budgets to sweep (a package with "
                   "ops.instnorm.cluster_size only)")
    p.add_argument("--out", help="also append the JSON line to this file")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench: needs a CUDA device")
    root = os.path.abspath(args.root)
    # run as a file, sys.path[0] is this directory: replace it by the root
    sys.path[0] = root
    from animateportrait_tpu_torch import kernels
    from animateportrait_tpu_torch.ops import instnorm, stft

    if not kernels.PACKAGE_DIR.is_relative_to(root):
        raise SystemExit(f"kernel_bench: imported {kernels.PACKAGE_DIR}, "
                         f"not the package under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.library()
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    rec = {"root": root, "card": card, "k1": {}, "k2": {}, "k2_sweep": {},
           "k2_batch_ms": None}
    with torch.inference_mode():
        for n in K1_LENGTHS:
            x = torch.randn(n, generator=torch.Generator(device=dev)
                            .manual_seed(n), device=dev) * 0.3
            rec["k1"][str(n)] = device_ms(lambda: stft.stft_magnitude(x))
        for shape in K2_SHAPES + [K2_STREAM_SHAPE]:
            x = k2_input(shape, dev)
            rec["k2"][str(shape)] = device_ms(
                lambda: instnorm.instance_norm(x))
            for sb in args.slice_bytes:
                k = instnorm.cluster_size(shape[2] * shape[3], sb)
                y = torch.empty_like(x)
                rec["k2_sweep"].setdefault(str(shape), {})[str(sb)] = [
                    device_ms(lambda: instnorm._launch(x, y, 1e-5, False, k)),
                    k]
            del x
        batch = [k2_input(s, dev) for s, n in K2_BATCH_MIX.items()
                 for _ in range(n)]
        rec["k2_batch_ms"] = device_ms(
            lambda: [instnorm.instance_norm(x) for x in batch])
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    _main()
