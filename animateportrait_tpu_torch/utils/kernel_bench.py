"""Device times and bounds of the port's kernels on the card.

Helpers, used by ``chip_smoke.py``:
- :func:`device_ms`: one CUDA-event pair around N back-to-back calls
  (N >= 50, enough to fill >= 1 ms), after a warm-up, divided by N. A
  ``torch.cuda._sleep`` queued first holds the device until the host has
  enqueued all N calls, so the reading is device time, not the host's
  launch rate.
- :func:`bound`: the least time the card could take for a function, the
  larger of its bytes over 3.35 TB/s and its fp32 operations over
  67 TFLOP/s (H100 SXM data sheet), and which of the two bounds it.
- the main path's kernel shapes (``K1_LENGTHS``, ``K2_SHAPES``, and
  ``K2_BATCH_MIX``, K2's launches in one 8-frame batch), the work each call
  does, and the one PyTorch call that computes the same function
  (``library_ms``; the port never calls it).

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


def k2_work(shape) -> tuple[int, int]:
    """(bytes, fp32 operations) of an InstanceNorm(+ReLU) of an NCHW fp32
    tensor: read once, written once; ~8 operations an element (the mean,
    the shifted sums, the normalize and the ReLU)."""
    numel = math.prod(shape)
    return 8 * numel, 8 * numel


def stft_library(x: torch.Tensor) -> torch.Tensor:
    """|STFT| by one PyTorch call (cuFFT): the yardstick for K1."""
    w = torch.hann_window(N_FFT, periodic=True, device=x.device)
    return torch.stft(x, N_FFT, HOP, window=w, center=True,
                      pad_mode="reflect", return_complex=True).abs().T


def instance_norm_library(x: torch.Tensor) -> torch.Tensor:
    """InstanceNorm by one PyTorch call: the yardstick for K2 (no ReLU)."""
    return torch.nn.functional.instance_norm(x, eps=1e-5)


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
