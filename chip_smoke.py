#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``animateportrait_tpu_torch``) on one
NVIDIA GPU, from a checkout of the repository:

    python3 chip_smoke.py

Phases, each printing its own lines:
  0. device and precision: the card's name and power limit, versions, TF32
     off for matmuls and convs;
  1. build the hand-written kernels from ``animateportrait_tpu_torch/csrc``;
  2. each kernel against its plain PyTorch version at the main path's
     shapes (and K2's streaming branch), with the device time of the
     kernel, of the plain version and of the one PyTorch call that computes
     the same function (``library_ms``), the bound for the same work, and
     the share of it the kernel reaches. A time is one CUDA-event pair
     around N >= 50 back-to-back calls (>= 1 ms) after a warm-up, divided
     by N (``utils/kernel_bench.py:device_ms``);
  3. the main path: the full-width photo + speech -> frames pipeline with
     seeded random weights, a warm pass and a timed pass; the kernels'
     launch counters are zeroed just before the timed pass and must be
     positive after it. The warm pass keeps the first input of every
     InstanceNorm of the nets, and K2 is then held against its plain
     version on those activations too. K2's device time per photo and per
     8-frame batch of the renderer: summed from a ``torch.profiler`` trace,
     and as launches x the per-shape time;
  4. card against host: the audio stage and one 2-frame renderer batch with
     the same weights and inputs on the card and on the CPU (which runs the
     plain versions);
  5. the user's entry point on the card: ``cli.main`` with ``--exp
     formal/cartoon --device cuda`` on a synthetic photo (PPM), a 6 s WAV
     and a checkpoint directory that holds only seeded random MTCNN
     weights, so every other net takes the CLI's random init. The launch
     counters are zeroed just before it and must be positive after it; the
     AVI is parsed back. A warm pass through the CLI's own pipeline builder
     keeps the input of every Photo2Cartoon InstanceNorm, and K2 is held
     against its plain version on those; K2's time per photo and per batch
     as in phase 3;
  6. card against host for the modules phase 5 added to the path: the
     MTCNN cascade, the Photo2Cartoon stylization, a 2-frame cartoon render
     and the speaker embedding;
  7. the Module2 training step (``train/module2.py``) at the configuration
     of the JAX package's ``bench.py:bench_train_step``: crop 256, drawing
     (1 channel), ngf = ndf = 64, batch 4, stacked discriminator passes,
     fp32, seeded random weights and a seeded synthetic batch. A warm step
     keeps the first input of every InstanceNorm at every shape; K2's
     gradient path (K2 forward with saved statistics, K2b backward) is held
     against autograd through the plain version and through float64 on
     those, and K2b against its plain version on the same statistics. Then
     K2's and K2b's device times at each shape of the step, the launch
     counters zeroed before timed steps and read after them (steps/s, a
     smoke figure, and the step's peak memory), K2's and K2b's device time
     in a profiled step, and card against host ``grads`` at the JAX tests'
     small configuration;
  8. the trainer as users run it: ``train_cli.main`` with the readme's
     drawing command (crop 256, load 286, ngf = ndf = 64, batch 4,
     ``--num_threads 8`` worker processes, 8 steps) over a seeded synthetic
     UMLVD-IFW tree of 16 photos and 16 drawings at 512^2 and two 8-frame
     clips, every PNG row Paeth-filtered (the costliest to decode). Steps/s
     over steps 3-8 with the data loading, the data-wait share, peak
     memory, K2's and K2b's launches (counters zeroed just before), and the
     host decode and resize times per image on this machine's CPU. Then
     ``--continue_train`` for 2 steps: it must resume at step 8, and the
     state restored from the step-8 checkpoint must equal the saved one
     bit for bit; the gallery PNGs, ``loss_log.txt`` and ``metrics.jsonl``
     must be there. Last, the step's ``grads`` at the bench batch on a
     batch of the tree with ``remat`` on and off: every leaf within 1e-5
     of its scale or twice the plain step's own run-to-run spread, and
     both peak memories;
  9. the bf16 render (``--render_bf16``): the full-width drawing pipeline
     of phase 3 with its per-frame nets in bf16, on phase 3's inputs: a
     warm pass that keeps the generator's bf16 InstanceNorm inputs, then a
     timed pass with the launch counters zeroed just before it (K2-bf16 and
     the fp32 K2 of the once-per-photo nets must both launch); the frames'
     PSNR against phase 3's fp32 frames; K2-bf16 against its plain version
     on the kept inputs; K2's time per photo and per batch as in phase 3.
     Then ``cli.main --exp formal/cartoon --render_bf16`` once, counters
     zeroed before it, the AVI parsed back;
 10. the bf16 training step (``compute_dtype="bfloat16"``) at phase 7's
     configuration: K2-bf16 + K2b-bf16 against float64 and the plain
     versions on the step's kept bf16 InstanceNorm inputs, their times at
     each shape, 3 timed steps with the counters zeroed before them
     (steps/s, peak memory, launches), a profiled step; then ``train_cli
     --compute_dtype bfloat16`` for 4 steps over phase 8's tree;
 11. the user's own photo: the committed JPEG fixtures
     (``animateportrait_tpu_torch/assets``: 4:2:0 quality 90 with restart
     markers and EXIF orientation 6, and a gray one) decoded by both
     readers to the SHA-256 that PIL and OpenCV gave, with the host ms per
     512^2 image (median of 5); seeded full-width FAN3D (4 modules) and
     ResNetDepth (3, 8, 36, 3) checkpoints in face_alignment's layout;
     ``cli.main --exp formal/drawing --warp_mode tps`` on the JPEG and a
     6 s WAV, the launch counters zeroed just before it (K1 and K2 must
     launch), the AVI parsed back, the stage seconds with the FAN stage;
     FAN's heatmaps, z and landmarks card against host and its ms per
     photo; the drawing pipeline of phase 3 with TPS grids on phase 3's
     inputs (frames/s, PSNR against phase 3's linear frames, the mean
     distance of the TPS grid from the griddata-linear one); a 2-frame
     TPS render card against host; and ``train_cli`` for 8 steps over
     phase 8's tree with its photos replaced by the JPEG fixture (steps/s
     and the data-wait share over steps 3-8 beside phase 8's).
 12. the rest of the inference surface: ``test_cli.main`` with the
     reference's test command at full width (ngf 64, crop 256, disp 3,
     frame batch 8, seeded random weights) over a seeded driver layout
     (``utils/smoke.py:write_test_layout``: a 512^2 photo, 16 landmark
     frames and their txts, ``datasets/list/testA|B``), the launch
     counters zeroed just before it; frames/s of ``render_visuals``
     beside ``__call__`` on the same inputs; K2 against its plain version
     on that renderer's InstanceNorm inputs; card against host on 2
     frames (PSNR of every float visual, the landmark drawings exact).
     ``cli.main --video`` on an AVI of phase 3's frames with the 6 s WAV
     as its 16 kHz PCM track, with ``--audio`` (counters zeroed before
     it) and from the track: the photo each run gets is
     ``decode_jpeg(encode_jpeg(first frame))``. The quality-95 encoder on
     the committed fixtures against OpenCV's SHA-256 and its host ms per
     512^2 image. ``detect_faces_batch`` of 4 photos against 4 single
     calls and ``BatchedLandmarkPredictor`` of 3 audios against the single
     predictor, with their times. Photo2Cartoon ``light=False`` at ngf 32:
     card against host, K2 on its InstanceNorm inputs, ms per photo.
Then the loader's forkserver and multiprocessing's resource tracker are
stopped, and no process the run started may still be running.

Phase 2 also holds K2-bf16 at the bf16 render shapes and K2b-bf16 at the
training shapes against their plain versions (K2-bf16 within one bf16 ulp
of the plain version at each element, or K2_ATOL where that ulp is
finer; K2b-bf16 within one bf16 ulp of the largest |dx|), and times K2-bf16
at the render shapes.

Any failure raises, and the script exits non-zero without a result. The
line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. It needs a CUDA device: without one it
stops in phase 0.
"""
from __future__ import annotations

import copy
import json
import os
import subprocess
import tempfile
import time
import wave

import numpy as np
import torch

K1_REPLACES = "animateportrait_tpu/ops/pallas_stft.py:42"
K2_REPLACES = "animateportrait_tpu/ops/pallas_instnorm.py:126"
# the shape K2's headline numbers in the JSON line come from: 23 of the 29
# launches per batch (every main-path shape is in its "by_shape" list)
K2_TIMED_SHAPE = (8, 256, 64, 64)
K1_TOL = dict(atol=2e-3, rtol=1e-3)  # 1024-term fp32 sums, as the JAX tests
K2_ATOL = 1e-5                       # fp32 statistics over up to 262k pixels
# K2b replaces the gradient of the custom-vjp entry, jax.vjp of the XLA
# formulation (not a Pallas kernel in JAX)
K2B_REPLACES = "animateportrait_tpu/ops/pallas_instnorm.py:162"
# K2b against its plain version on the same statistics, of the largest
# |dx| (the discriminators' flat planes give |dx| up to ~100)
K2B_RTOL = 1e-5
# K2 + K2b against float64 autograd and fp32 autograd through the plain
# version, on the function the forward computed (with ReLU, the upstream
# gradient masked by K2's output), as fractions of the largest |dx|
K2B_F64_RTOL = 1e-5
K2B_PLAIN_RTOL = 1e-5
# the bf16 kernels: K2-bf16 within one bf16 ulp of the plain version's
# output at each element (K2_ATOL where that ulp is finer: both round one
# fp32 value, summed in other orders); K2b-bf16 within one bf16 ulp of the
# largest |dx| of the plain version (each rounds dx once), and K2 + K2b in
# bf16 against float64 autograd on the same bf16 inputs within two
K2B_BF16_RTOL = 2.0 ** -7
K2B_BF16_F64_RTOL = 2.0 ** -6
# phase 9: the bf16 frames against phase 3's fp32 frames (uint8)
BF16_RENDER_MIN_PSNR = 30.0
TRAIN_BATCH = 4
TRAIN_STEPS = 3
# the readme's drawing training command (readme.md:65)
README_DRAWING = (
    "--name training/drawing1 --model geomgm_ifw_fore --netG "
    "resnet_9blocks_rcatland32_full_ifw --netg_resb_div 3 --netg_resb_disp 3 "
    "--output_nc 1 --lr 0.00005 --lambda_geom 50 --lambda_geom_lipline 50 "
    "--more_weight_for_lip 2 --lambda_face 3.0 --lambda_warp_inter 10 "
    "--blendbg 1 --select_target12_thre 0.0 --niter 70 --niter_decay 0"
    ).split()
CLI_STEPS = 8        # phase 8's first run; --continue_train adds 2
# remat against no remat, of each gradient leaf's largest |g| (of the
# tree's for a bias an InstanceNorm cancels, whose gradient is rounding
# noise), with cuDNN's deterministic algorithms
REMAT_RTOL = 1e-5
# phase 11: the committed JPEG fixtures (tests/torch_jpeg_fixtures.py),
# and FAN3D's heatmaps card against host (fp32, TF32 off; 4 hourglasses)
JPEG_FIXTURES = ("portrait_420_rst_exif6.jpg", "portrait_gray.jpg")
FAN_ATOL = 1e-3


def say(msg: str) -> None:
    print(msg, flush=True)


def psnr(a: np.ndarray, b: np.ndarray, peak: float) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(peak ** 2 / mse)


def phase0() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is False; "
                           "the port's smoke run needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    say(f"[0] card: {smi}")
    say(f"[0] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s), using "
        f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[0] allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return smi


def phase1() -> None:
    from animateportrait_tpu_torch import kernels

    kernels.library()
    say(f"[1] kernels built and loaded in {kernels.build_seconds:.2f} s")
    log = (kernels.build().parent / "nvcc.log").read_text()
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            say(f"[1] ptxas: {line.strip()}")


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| in bf16 ulps at |want| (the spacing of
    8-bit significands), counting K2_ATOL as one ulp where the spacing is
    finer."""
    w = want.double()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126)))
                     - 7)
    return float(((got.double() - w).abs() / ulp.clamp_min(K2_ATOL)).max())


def timed(fn_kernel, fn_plain, fn_library, work) -> dict:
    """Device times of a kernel, its plain version and the library call on
    the same inputs, with the bound for the same work (bytes, operations)
    and the share of it the kernel reaches."""
    from animateportrait_tpu_torch.utils.kernel_bench import bound, device_ms

    ms = device_ms(fn_kernel)
    bound_ms, bound_by = bound(*work)
    return dict(ms=ms, plain_ms=device_ms(fn_plain),
                library_ms=device_ms(fn_library), bound_ms=bound_ms,
                bound_by=bound_by, share_of_bound=bound_ms / ms)


def phase2(dev: torch.device) -> dict[str, dict]:
    from animateportrait_tpu_torch.ops.instnorm import (
        cluster_size, instance_norm, instance_norm_plain)
    from animateportrait_tpu_torch.ops.spectral import (
        stft_magnitude as stft_plain)
    from animateportrait_tpu_torch.ops.stft import stft_magnitude
    from animateportrait_tpu_torch.pipeline.audio import (
        condition_signal, normalize_dbfs)
    from animateportrait_tpu_torch.utils.kernel_bench import (
        K2_SHAPES, K2_STREAM_SHAPE, instance_norm_library, k1_work, k2_input,
        k2_work, stft_library)
    from animateportrait_tpu_torch.utils.smoke import make_wav

    rec = {}
    with torch.inference_mode():
        w = torch.as_tensor(condition_signal(normalize_dbfs(make_wav(6.0, 1))),
                            dtype=torch.float32, device=dev)
        got, want, lib = stft_magnitude(w), stft_plain(w), stft_library(w)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        lib_err = float((lib - want).abs().max())
        ok = torch.allclose(got, want, **K1_TOL)
        t = timed(lambda: stft_magnitude(w), lambda: stft_plain(w),
                  lambda: stft_library(w), k1_work(w.shape[0]))
        say(f"[2] K1 stft_magnitude n={w.shape[0]} -> {tuple(got.shape)}: "
            f"max|kernel-plain|={err:.3e} (atol {K1_TOL['atol']}, rtol "
            f"{K1_TOL['rtol']}), max|library-plain|={lib_err:.3e}; kernel "
            f"{t['ms']:.5f} ms, plain {t['plain_ms']:.5f} ms, library "
            f"{t['library_ms']:.5f} ms, bound {t['bound_ms']:.5f} ms "
            f"({t['bound_by']}), {100 * t['share_of_bound']:.1f}% of bound")
        if not ok:
            raise AssertionError(f"K1 disagrees with its plain version: {err}")
        rec["stft_magnitude"] = dict(max_abs_err=err, **t)

        worst = 0.0
        by_shape = []
        for shape in K2_SHAPES + [K2_STREAM_SHAPE]:
            # means up to tens of standard deviations, where an unshifted
            # one-pass variance would lose ~3 digits to cancellation
            x = k2_input(shape, dev)
            cluster = cluster_size(shape[2] * shape[3])
            for relu in (False, True):
                got = instance_norm(x, relu=relu)
                want = instance_norm_plain(x, relu=relu)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                worst = max(worst, err)
                say(f"[2] K2 instance_norm {shape} relu={relu}: "
                    f"max|kernel-plain|={err:.3e} (atol {K2_ATOL}), "
                    f"{cluster} CTA(s) per plane (0: streaming)")
                if err > K2_ATOL:
                    raise AssertionError(
                        f"K2 disagrees with its plain version at {shape}: "
                        f"{err}")
            lib_err = float((instance_norm_library(x)
                             - instance_norm_plain(x)).abs().max())
            # timed without the ReLU, as the library call computes it
            t = timed(lambda: instance_norm(x), lambda: instance_norm_plain(x),
                      lambda: instance_norm_library(x), k2_work(shape))
            t.update(shape=list(shape), cluster=cluster)
            by_shape.append(t)
            say(f"[2] K2 instance_norm {shape}: kernel {t['ms']:.5f} ms, "
                f"plain {t['plain_ms']:.5f} ms, library {t['library_ms']:.5f} "
                f"ms (max|library-plain|={lib_err:.1e}), bound "
                f"{t['bound_ms']:.5f} ms ({t['bound_by']}), "
                f"{100 * t['share_of_bound']:.1f}% of bound")
            if shape == K2_TIMED_SHAPE:
                rec["instance_norm"] = dict(t)
            del x
        rec["instance_norm"].update(max_abs_err=worst, by_shape=by_shape)
    rec.update(phase2_bf16(dev))
    return rec


def phase2_bf16(dev: torch.device) -> dict[str, dict]:
    """K2-bf16 at the bf16 render shapes (and a streaming and an odd plane)
    against its plain version, timed; K2b-bf16 at the training shapes
    against its plain version on K2-bf16's statistics."""
    from animateportrait_tpu_torch.ops import instnorm
    from animateportrait_tpu_torch.utils.kernel_bench import (
        K2_BF16_RENDER_SHAPES, TRAIN_IN_SHAPES, instance_norm_library,
        k2_input, k2_work)

    bf16 = torch.bfloat16
    worst, worst_ulps, by_shape, rec = 0.0, 0.0, [], {}
    with torch.inference_mode():
        for shape in K2_BF16_RENDER_SHAPES + [(1, 4, 1024, 1024),
                                              (4, 512, 31, 31)]:
            x = k2_input(shape, dev).to(bf16)
            for relu in (False, True):
                got = instnorm.instance_norm(x, relu=relu)
                want = instnorm.instance_norm_plain(x, relu=relu)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                ulps = bf16_ulps(got, want)
                worst, worst_ulps = max(worst, err), max(worst_ulps, ulps)
                if ulps > 1.0:
                    raise AssertionError(
                        f"K2-bf16 disagrees with its plain version at "
                        f"{shape}: {ulps:.2f} ulps")
            t = timed(lambda: instnorm.instance_norm(x),
                      lambda: instnorm.instance_norm_plain(x),
                      lambda: instance_norm_library(x), k2_work(shape, 2))
            t.update(shape=list(shape), cluster=instnorm.k2_cluster(x))
            by_shape.append(t)
            say(f"[2] K2-bf16 instance_norm {shape}: max|kernel-plain|="
                f"{err:.3e} ({ulps:.2f} bf16 ulps), {t['cluster']} CTA(s) "
                f"per plane; kernel {t['ms']:.5f} ms, plain "
                f"{t['plain_ms']:.5f} ms, library {t['library_ms']:.5f} ms, "
                f"bound {t['bound_ms']:.5f} ms ({t['bound_by']}), "
                f"{100 * t['share_of_bound']:.1f}% of bound")
            if shape == K2_TIMED_SHAPE:
                rec["instance_norm_bf16"] = dict(t)
            del x
    rec["instance_norm_bf16"].update(max_abs_err=worst, max_ulps=worst_ulps,
                                     by_shape=by_shape)
    worst = 0.0
    for i, shape in enumerate(TRAIN_IN_SHAPES + [(1, 2, 1024, 1024)]):
        x = k2_input(shape, dev, seed=i).to(bf16)
        g = torch.randn(shape, generator=torch.Generator(device=dev)
                        .manual_seed(i), device=dev).to(bf16)
        for relu in (False, True):
            stats = instnorm.empty_stats(x)
            instnorm._launch(x, torch.empty_like(x), 1e-5, relu,
                             instnorm.k2_cluster(x), stats)
            got = instnorm.instance_norm_backward(x, g, stats, relu)
            want = instnorm.instance_norm_backward_plain(x, g, stats, relu)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            rel = err / float(want.float().abs().max())
            worst = max(worst, err)
            if rel > K2B_BF16_RTOL:
                raise AssertionError(f"K2b-bf16 disagrees with its plain "
                                     f"version at {shape}: {rel:.2e}")
        say(f"[2] K2b-bf16 {shape}: max|kernel-plain|={err:.3e} "
            f"({rel:.2e} of max|dx|, <= {K2B_BF16_RTOL:.2e}), "
            f"{instnorm.k2b_cluster(x)} CTA(s) per plane")
        del x, g
    rec["instance_norm_backward_bf16"] = {"max_abs_err": worst}
    return rec


def keep_instance_norm_inputs(nets, by_shape: bool = False
                              ) -> tuple[dict, list]:
    """Forward pre-hooks that keep a copy of the first input of every
    InstanceNorm2d of ``nets``, by module name (and, with ``by_shape``,
    the first input of each shape a module sees)."""
    from animateportrait_tpu_torch.nn import InstanceNorm2d

    kept, hooks = {}, []
    for net_name, net in nets.items():
        for name, mod in net.named_modules():
            if isinstance(mod, InstanceNorm2d):
                def keep(mod, args, key=f"{net_name}.{name}"):
                    if by_shape:
                        key = f"{key} {tuple(args[0].shape)}"
                    if key not in kept:
                        kept[key] = (args[0].detach().clone(), mod.relu)
                hooks.append(mod.register_forward_pre_hook(keep))
    return kept, hooks


def k2_on_path(kept: dict, tag: str) -> float:
    """K2 against its plain version on the activations a path fed each
    InstanceNorm; returns the largest |kernel - plain|. The bar is K2_ATOL
    on fp32 activations, one bf16 ulp at each element (``bf16_ulps``) on
    bf16 ones (K2-bf16)."""
    from animateportrait_tpu_torch.ops.instnorm import (
        instance_norm, instance_norm_plain)

    by_shape, failed = {}, []
    with torch.inference_mode():
        for key, (x, relu) in kept.items():
            want = instance_norm_plain(x, relu=relu)
            got = instance_norm(x, relu=relu)
            err = float((got.float() - want.float()).abs().max())
            bf16 = x.dtype == torch.bfloat16
            ulps = bf16_ulps(got, want) if bf16 else 0.0
            if (ulps > 1.0) if bf16 else (err > K2_ATOL):
                failed.append((key, err, ulps))
            xf = x.float()
            ratio = float((xf.mean((2, 3)).abs()
                           / xf.std((2, 3)).clamp_min(1e-12)).max())
            k = (tuple(x.shape), relu, x.dtype)
            worst = by_shape.get(k, (0.0, 0.0, "", 0.0, 0.0))
            by_shape[k] = max(worst, (err, ulps, key, ratio,
                                      float(want.float().abs().max())))
    for (shape, relu, dtype), (err, ulps, key, ratio, top) in sorted(
            by_shape.items(), key=str):
        bar = (f"{ulps:.2f} bf16 ulps, <= 1" if dtype == torch.bfloat16
               else f"atol {K2_ATOL}")
        say(f"[{tag}] K2 on path activations {shape} {dtype} relu={relu}: "
            f"max|kernel-plain|={err:.3e} ({bar}) at {key}, max |mean|/std "
            f"there {ratio:.2f}, max |y| {top:.1f}")
    err, ulps, key, ratio, top = max(by_shape.values())
    say(f"[{tag}] K2 on path activations: {len(kept)} InstanceNorms, "
        f"{len(by_shape)} shapes, max|kernel-plain|={err:.3e} at {key} "
        f"(max |y| there {top:.1f}; fp32 spacing at |y| = {top:.1f} is "
        f"{float(np.spacing(np.float32(top))):.2e})")
    if failed:
        raise AssertionError(f"K2 disagrees with its plain version on the "
                             f"path's activations: {failed[:4]}")
    return err


def k2_time_on_path(renderer, landmarks: np.ndarray, tag: str) -> dict:
    """K2's device time in a renderer, per photo (the static nets and
    encode_static) and per frame batch, each part run once after a warm-up:
    summed from a ``torch.profiler`` trace of the part (0 where CUPTI gives
    no device time), and as its launches x each shape's ``device_ms``, in
    the dtype each InstanceNorm saw (K2 and K2-bf16 together)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from animateportrait_tpu_torch.nn import InstanceNorm2d
    from animateportrait_tpu_torch.ops.instnorm import instance_norm
    from animateportrait_tpu_torch.ops.tps import triangulate_frames
    from animateportrait_tpu_torch.pipeline.render import CROP_SIZE
    from animateportrait_tpu_torch.utils.kernel_bench import (
        K2_BATCH_MIX, device_ms, k2_input)

    dev, fb = renderer.device, renderer.frame_batch
    tb68 = (landmarks[:fb, :, :2] * 0.5).astype(np.float32)
    photo = torch.as_tensor(np.random.default_rng(5).uniform(
        -1, 1, (1, 3, CROP_SIZE, CROP_SIZE)), dtype=torch.float32, device=dev)
    a68 = torch.as_tensor(tb68.mean(0), device=dev)[None]
    lm = torch.as_tensor(tb68, device=dev)
    tris = torch.as_tensor(triangulate_frames(tb68, CROP_SIZE), device=dev)
    state = {}

    def per_photo():
        fore, mask, static = renderer.prepare(photo)
        state["args"] = (renderer.encode(fore, a68), mask, static)

    def per_batch():
        renderer.frames(*state["args"], a68, lm, None, tris)

    norms = [m for net in (renderer.g, renderer.flowunet, renderer.modnet,
                           renderer.static_net)
             for m in net.modules() if isinstance(m, InstanceNorm2d)]
    out = {}
    with torch.inference_mode():
        per_photo()
        per_batch()
        torch.cuda.synchronize()
        for part, fn in (("photo", per_photo), ("batch", per_batch)):
            counts = {}

            def count(mod, args):
                key = (tuple(args[0].shape), mod.relu, args[0].dtype)
                counts[key] = counts.get(key, 0) + 1

            hooks = [m.register_forward_pre_hook(count) for m in norms]
            launches0 = instance_norm.launches + instance_norm.launches_bf16
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            launches = (instance_norm.launches + instance_norm.launches_bf16
                        - launches0)
            for h in hooks:
                h.remove()
            k2_us = all_us = 0.0
            for e in prof.key_averages():
                if e.device_type != DeviceType.CUDA:
                    continue
                us = float(getattr(e, "self_device_time_total",
                                   getattr(e, "self_cuda_time_total", 0.0)))
                all_us += us
                if "instance_norm" in e.key:
                    k2_us += us
            est = 0.0
            for (shape, relu, dtype), n in counts.items():
                x = k2_input(shape, dev).to(dtype)
                est += n * device_ms(lambda: instance_norm(x, relu=relu))
            mix = {}
            for (shape, _, _), n in counts.items():
                mix[shape] = mix.get(shape, 0) + n
            out[part] = dict(launches=launches, profiled_ms=k2_us / 1e3,
                             device_ms=all_us / 1e3, estimated_ms=est,
                             launches_by_shape={str(s): n for s, n in
                                                sorted(mix.items())})
            say(f"[{tag}] K2 per {part}: {launches} launches, "
                f"{len(counts)} shapes; profiled {k2_us / 1e3:.4f} ms of "
                f"{all_us / 1e3:.4f} ms device time "
                f"({100 * k2_us / max(all_us, 1e-9):.2f}%); launches x "
                f"per-shape time {est:.4f} ms; by shape "
                f"{out[part]['launches_by_shape']}")
            if launches != sum(counts.values()):
                raise AssertionError(f"K2 launches {launches} != the "
                                     f"InstanceNorm calls {counts}")
            if part == "batch" and mix != K2_BATCH_MIX:
                raise AssertionError(f"K2's launches in a batch {mix} are "
                                     f"not kernel_bench.K2_BATCH_MIX")
    return out


def phase3(dev: torch.device, nets) -> dict:
    from animateportrait_tpu_torch.ops.instnorm import instance_norm
    from animateportrait_tpu_torch.ops.stft import stft_magnitude
    from animateportrait_tpu_torch.utils.smoke import build_pipeline, make_wav

    pipe = build_pipeline(nets, dev, frame_batch=8, output_uint8=True)
    photo = np.random.default_rng(0).uniform(0, 255, (512, 512, 3)).astype(
        np.uint8)
    kept, hooks = keep_instance_norm_inputs(nets)
    with torch.inference_mode():
        t0 = time.perf_counter()
        pipe(photo, make_wav(6.0, seed=1))
        torch.cuda.synchronize()
        say(f"[3] warm pass {time.perf_counter() - t0:.3f} s (keeps the "
            f"InstanceNorm inputs)")
        for h in hooks:
            h.remove()
        stft_magnitude.launches = 0
        instance_norm.launches = 0
        t0 = time.perf_counter()
        out = pipe(photo, make_wav(6.0, seed=2))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {"stft_magnitude": stft_magnitude.launches,
                    "instance_norm": instance_norm.launches}
    T = out.landmarks.shape[0]
    stages = ", ".join(f"{k} {v:.3f} s" for k, v in out.stage_seconds.items())
    say(f"[3] timed pass: {out.frames.shape[0]} frames in {dt:.3f} s = "
        f"{out.frames.shape[0] / dt:.2f} frames/s (smoke figure, not a "
        f"benchmark); stages: {stages}")
    say(f"[3] kernel launches in the timed pass: {launches}")
    if out.frames.shape != (T, 256, 256, 1) or out.frames.dtype != np.uint8:
        raise AssertionError(f"frames {out.frames.shape} {out.frames.dtype}, "
                             f"expected ({T}, 256, 256, 1) uint8")
    if not np.isfinite(out.landmarks).all():
        raise AssertionError("non-finite landmarks")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    k2_err = k2_on_path(kept, "3")
    return {"launches": launches, "landmarks": out.landmarks,
            "frames": out.frames, "k2_path_err": k2_err,
            "frames_per_s": out.frames.shape[0] / dt,
            "k2_time": k2_time_on_path(pipe.renderer, out.landmarks, "3")}


def phase4(dev: torch.device, nets, main: dict) -> None:
    from animateportrait_tpu_torch.utils.smoke import build_pipeline, make_wav

    wav = make_wav(6.0, seed=2)
    photo = np.random.default_rng(1).uniform(-1, 1, (256, 256, 3)).astype(
        np.float32)
    tb68 = (main["landmarks"][:2, :, :2] * 0.5).astype(np.float32)
    a68 = tb68.mean(0)
    results = {}
    for where in (dev, torch.device("cpu")):
        pipe = build_pipeline(copy.deepcopy(nets), where, frame_batch=2,
                              output_uint8=False)
        with torch.inference_mode():
            feats = pipe.audio(wav)
            frames = pipe.renderer(photo, a68, tb68)
        results[where.type] = (feats, frames)
    (fc, rc), (fh, rh) = results["cuda"], results["cpu"]
    mel_err = float(np.abs(fc.mel_raw - fh.mel_raw).max())
    vc_err = float(np.abs(fc.mel_autovc - fh.mel_autovc).max())
    p = psnr(rc, rh, peak=2.0)
    say(f"[4] card vs host: mel max|diff|={mel_err:.3e} (atol 2e-3), AutoVC "
        f"mel max|diff|={vc_err:.3e}, 2-frame render PSNR={p:.2f} dB "
        f"(>= 40)")
    if not mel_err <= 2e-3:
        raise AssertionError(f"mel differs between card and host: {mel_err}")
    if not p >= 40.0:
        raise AssertionError(f"render PSNR card vs host {p:.2f} dB < 40")


def write_photo(path: str, size: int = 512) -> str:
    """A synthetic 8-bit binary PPM: smooth colour ramps and a bright oval
    with seeded noise."""
    rng = np.random.default_rng(3)
    y, x = np.mgrid[0:size, 0:size] / size
    face = ((x - 0.5) ** 2 / 0.08 + (y - 0.5) ** 2 / 0.13) < 1
    rgb = np.stack([90 + 120 * x, 70 + 100 * y, 110 + 60 * np.sin(6 * x * y)],
                   -1) + 80 * face[..., None] + rng.normal(0, 6, (size, size,
                                                                   3))
    with open(path, "wb") as f:
        f.write(f"P6\n{size} {size}\n255\n".encode())
        f.write(np.clip(rgb, 0, 255).astype(np.uint8).tobytes())
    return path


def phase5(dev: torch.device, landmarks: np.ndarray) -> dict:
    from animateportrait_tpu_torch import cli
    from animateportrait_tpu_torch.ops.instnorm import instance_norm
    from animateportrait_tpu_torch.ops.stft import stft_magnitude
    from animateportrait_tpu_torch.pipeline.audio import load_wav
    from animateportrait_tpu_torch.utils.image import read_image
    from animateportrait_tpu_torch.utils.smoke import (
        make_wav, write_mtcnn_weights)
    from animateportrait_tpu_torch.utils.video import read_avi, write_wav

    with tempfile.TemporaryDirectory() as tmp:
        photo = write_photo(os.path.join(tmp, "portrait.ppm"))
        wav_path = write_wav(os.path.join(tmp, "speech.wav"),
                             make_wav(6.0, seed=3))
        ckpt = os.path.join(tmp, "ckpt")
        write_mtcnn_weights(os.path.join(ckpt, "mtcnn"), seed=0)
        argv = ["--jpg", photo, "--audio", wav_path, "--exp",
                "formal/cartoon", "--device", "cuda", "--frame_batch", "8",
                "--ckpt_dir", ckpt, "--output", os.path.join(tmp, "out")]

        # warm pass through the CLI's own builder, keeping the Photo2Cartoon
        # InstanceNorm inputs
        pipe = cli.build_pipeline(cli.build_argparser().parse_args(argv))
        kept, hooks = keep_instance_norm_inputs(
            {"photo2cartoon": pipe.renderer.static_net})
        t0 = time.perf_counter()
        with torch.inference_mode():
            pipe(read_image(photo), load_wav(wav_path))
        torch.cuda.synchronize()
        say(f"[5] warm pass {time.perf_counter() - t0:.3f} s (keeps the "
            f"Photo2Cartoon InstanceNorm inputs)")
        for h in hooks:
            h.remove()
        k2_time = k2_time_on_path(pipe.renderer, landmarks, "5")
        del pipe

        stft_magnitude.launches = 0
        instance_norm.launches = 0
        t0 = time.perf_counter()
        res = cli.main(argv)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {"stft_magnitude": stft_magnitude.launches,
                    "instance_norm": instance_norm.launches}
        avi = read_avi(res.path)
        with wave.open(wav_path, "rb") as w:
            pcm = w.readframes(w.getnframes())

    T = res.frames
    piped = sum(res.stage_seconds.values())
    stages = ", ".join(f"{k} {v:.3f} s" for k, v in res.stage_seconds.items())
    say(f"[5] cli.main --exp formal/cartoon: {T} frames, pipeline + mux "
        f"{piped:.3f} s = {T / piped:.2f} frames/s (smoke figure, not a "
        f"benchmark); cli.main wall {dt:.3f} s with the random init of "
        f"the nets; stages: {stages}")
    say(f"[5] kernel launches in the CLI run: {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the CLI path never launched: "
                             f"{launches}")
    if avi["frames"].shape != (T, 256, 256, 3):
        raise AssertionError(f"AVI frames {avi['frames'].shape}, expected "
                             f"({T}, 256, 256, 3)")
    if b"auds" not in avi["streams"] or avi["fps"] != 62.5:
        raise AssertionError(f"AVI streams {avi['streams']} at "
                             f"{avi.get('fps')} fps")
    if avi["pcm"] != pcm[: len(avi["pcm"])] or len(avi["pcm"]) != min(
            len(pcm), T * 512):
        raise AssertionError("the AVI's PCM is not the WAV's")
    say(f"[5] AVI parsed back: {T} frames of 256x256x3 at 62.5 fps, an auds "
        f"stream, PCM equal to the WAV's first {len(avi['pcm']) // 2} "
        f"samples")
    return {"launches": launches, "k2_path_err": k2_on_path(kept, "5"),
            "k2_time": k2_time}


def phase6(dev: torch.device, landmarks: np.ndarray) -> None:
    from animateportrait_tpu_torch.models import mtcnn
    from animateportrait_tpu_torch.models.speaker_encoder import get_spk_emb
    from animateportrait_tpu_torch.utils.image import read_image
    from animateportrait_tpu_torch.utils.smoke import (
        build_pipeline, full_width_nets, make_wav, write_mtcnn_weights)

    cpu = torch.device("cpu")
    with tempfile.TemporaryDirectory() as tmp:
        d = write_mtcnn_weights(os.path.join(tmp, "mtcnn"), seed=0)
        img = read_image(write_photo(os.path.join(tmp, "portrait.ppm")))
        det = {}
        for where in (dev, cpu):
            detector = mtcnn.MTCNNDetector(
                *(getattr(mtcnn, f"load_{n}")(os.path.join(d, f"{n}.npy"))
                  for n in ("pnet", "rnet", "onet")), device=where)
            det[where.type] = detector(img[:, :, ::-1].astype(np.float32))
    (bc, lc), (bh, lh) = det["cuda"], det["cpu"]
    if bc.shape != bh.shape or len(bc) == 0:
        raise AssertionError(f"MTCNN found {len(bc)} faces on the card, "
                             f"{len(bh)} on the host")
    box_err = float(np.abs(bc[:, :4] - bh[:, :4]).max())
    lm_err = float(np.abs(lc - lh).max())

    nets = full_width_nets(seed=0, style="cartoon")
    rng = np.random.default_rng(4)
    photo = rng.uniform(-1, 1, (256, 256, 3)).astype(np.float32)
    tb68 = (landmarks[:2, :, :2] * 0.5).astype(np.float32)
    wav = make_wav(6.0, seed=2)
    out = {}
    for where in (dev, cpu):
        pipe = build_pipeline(copy.deepcopy(nets), where, frame_batch=2,
                              output_uint8=False, style="cartoon")
        enc = copy.deepcopy(nets["voice_encoder"]).to(where).eval()
        with torch.inference_mode():
            x = torch.as_tensor(photo, device=where).permute(2, 0, 1)[None]
            styl = pipe.renderer.static_net(x)[0].cpu().numpy()
            frames = pipe.renderer(photo, tb68.mean(0), tb68)
            emb = get_spk_emb(enc, wav)
        out[where.type] = (styl, frames, emb)
    (sc, fc, ec), (sh, fh, eh) = out["cuda"], out["cpu"]
    p_styl, p_render = psnr(sc, sh, peak=2.0), psnr(fc, fh, peak=2.0)
    emb_err = float(np.abs(ec - eh).max())
    say(f"[6] card vs host: MTCNN {len(bc)} faces on both, boxes max|diff|="
        f"{box_err:.3e} px, five points {lm_err:.3e} px (<= 1); "
        f"Photo2Cartoon stylization PSNR={p_styl:.2f} dB (>= 40); 2-frame "
        f"cartoon render PSNR={p_render:.2f} dB (>= 40); get_spk_emb "
        f"max|diff|={emb_err:.3e} (<= 1e-4)")
    if not (box_err <= 1.0 and lm_err <= 1.0):
        raise AssertionError(f"MTCNN boxes/points differ between card and "
                             f"host: {box_err}, {lm_err}")
    if not (p_styl >= 40.0 and p_render >= 40.0):
        raise AssertionError(f"cartoon PSNR card vs host: stylization "
                             f"{p_styl:.2f} dB, render {p_render:.2f} dB")
    if not emb_err <= 1e-4:
        raise AssertionError(f"speaker embedding differs: {emb_err}")


def k2_gradient_on_path(kept: dict, tag: str = "7") -> dict:
    """K2's gradient path against autograd in float64 and through the plain
    version on the InstanceNorm inputs of a training step, with a seeded
    upstream gradient in the inputs' dtype (``kernel_bench.
    k2_gradient_errors``); and K2b against its plain version on the
    statistics K2 saved. fp32 or bf16 inputs (K2-bf16 and K2b-bf16, with
    the bf16 bars; their forward is held by ``k2_on_path``). Returns the
    worst errors."""
    from animateportrait_tpu_torch.ops import instnorm
    from animateportrait_tpu_torch.utils.kernel_bench import (
        k2_gradient_errors)

    worst, by_shape = {}, {}
    bf16 = next(iter(kept.values()))[0].dtype == torch.bfloat16
    rtol, f64_rtol, plain_rtol = ((K2B_BF16_RTOL, K2B_BF16_F64_RTOL,
                                   K2B_BF16_RTOL) if bf16 else
                                  (K2B_RTOL, K2B_F64_RTOL, K2B_PLAIN_RTOL))
    for i, (key, (x, relu)) in enumerate(sorted(kept.items())):
        gen = torch.Generator(device=x.device).manual_seed(i)
        g = torch.randn(x.shape, generator=gen, device=x.device).to(x.dtype)
        stats = instnorm.empty_stats(x)
        instnorm._launch(x, torch.empty_like(x), 1e-5, relu,
                         instnorm.k2_cluster(x), stats)
        want = instnorm.instance_norm_backward_plain(x, g, stats, relu)
        errs = k2_gradient_errors(x, g, relu)
        errs["k2b_abs"] = float((instnorm.instance_norm_backward(
            x, g, stats, relu).float() - want.float()).abs().max())
        errs["k2b"] = errs["k2b_abs"] / float(want.float().abs().max())
        for k, v in errs.items():
            worst[k] = max(worst.get(k, 0), v)
        k = (tuple(x.shape), relu)
        by_shape[k] = {n: max(by_shape.get(k, {}).get(n, 0), v)
                       for n, v in errs.items()}
    for (shape, relu), e in sorted(by_shape.items()):
        say(f"[{tag}] K2 gradient path {shape} {x.dtype} relu={relu}, of "
            f"max|dx|: K2b vs plain {e['k2b']:.2e} (<= {rtol:.2e}); K2+K2b "
            f"vs float64 {e['vs_f64']:.2e} (<= {f64_rtol:.2e}), vs plain "
            f"autograd {e['vs_plain']:.2e} (<= {plain_rtol:.2e}); plain "
            f"autograd vs float64 {e['plain_vs_f64']:.2e}; ReLU mask "
            f"elements float64 puts across the kink: {e['flips']}")
    say(f"[{tag}] K2 gradient path on {len(kept)} InstanceNorm inputs of a "
        f"step, {len(by_shape)} shapes: worst {worst}")
    if not (worst["k2b"] <= rtol and worst["vs_f64"] <= f64_rtol
            and worst["vs_plain"] <= plain_rtol
            and (bf16 or worst["fwd"] <= K2_ATOL)):
        raise AssertionError(f"K2's gradient path disagrees: {worst}")
    return worst


def count_instance_norms(nets) -> tuple[dict, list]:
    """Forward pre-hooks counting the InstanceNorm calls of ``nets`` by
    (shape, relu, recorded for the backward)."""
    from animateportrait_tpu_torch.nn import InstanceNorm2d

    counts, hooks = {}, []

    def count(mod, args):
        x = args[0]
        key = (tuple(x.shape), mod.relu,
               bool(x.requires_grad and torch.is_grad_enabled()))
        counts[key] = counts.get(key, 0) + 1

    for net in nets:
        for mod in net.modules():
            if isinstance(mod, InstanceNorm2d):
                hooks.append(mod.register_forward_pre_hook(count))
    return counts, hooks


def time_training_shapes(dev: torch.device, counts: dict, tag: str = "7",
                         dtype: torch.dtype = torch.float32) -> dict:
    """K2 (the training forward, which saves statistics) and K2b at each
    InstanceNorm shape of a step, in ``dtype``, without ReLU (the library
    calls have none): device times of kernel, plain version and library
    call, bound and share; launches per step of each."""
    from animateportrait_tpu_torch.ops import instnorm
    from animateportrait_tpu_torch.utils.kernel_bench import (
        instance_norm_backward_library, instance_norm_library, k2_input,
        k2_work, k2b_work)

    per_shape = {}
    for (shape, _, grad), n in counts.items():
        fwd, bwd = per_shape.get(shape, (0, 0))
        per_shape[shape] = (fwd + n, bwd + (n if grad else 0))
    rows = []
    with torch.no_grad():
        for shape, (n_fwd, n_bwd) in sorted(per_shape.items()):
            x = k2_input(shape, dev).to(dtype)
            g = torch.randn(shape, generator=torch.Generator(device=dev)
                            .manual_seed(7), device=dev).to(dtype)
            y = torch.empty_like(x)
            stats = instnorm.empty_stats(x)
            k, kb = instnorm.k2_cluster(x), instnorm.k2b_cluster(x)
            e = x.element_size()
            fwd = timed(lambda: instnorm._launch(x, y, 1e-5, False, k, stats),
                        lambda: instnorm.instance_norm_plain(x),
                        lambda: instance_norm_library(x),
                        k2_work(shape, e, stats=True))
            with torch.enable_grad():
                lib = instance_norm_backward_library(x, g)
                bwd = timed(
                    lambda: instnorm.instance_norm_backward(x, g, stats),
                    lambda: instnorm.instance_norm_backward_plain(x, g, stats),
                    lib, k2b_work(shape, e))
            rows.append(dict(shape=list(shape), k2_launches=n_fwd,
                             k2b_launches=n_bwd, k2_ctas=k, k2b_ctas=kb,
                             k2=fwd, k2b=bwd))
            say(f"[{tag}] {shape} {dtype} per step: K2 x{n_fwd} ({k} "
                f"CTA/plane) {fwd['ms'] * 1e3:.2f} us, plain "
                f"{fwd['plain_ms'] * 1e3:.2f}, library "
                f"{fwd['library_ms'] * 1e3:.2f}, bound "
                f"{fwd['bound_ms'] * 1e3:.2f} "
                f"({100 * fwd['share_of_bound']:.0f}%); K2b x{n_bwd} ({kb} "
                f"CTA/plane) {bwd['ms'] * 1e3:.2f} us, "
                f"plain {bwd['plain_ms'] * 1e3:.2f}, library "
                f"{bwd['library_ms'] * 1e3:.2f}, bound "
                f"{bwd['bound_ms'] * 1e3:.2f} "
                f"({100 * bwd['share_of_bound']:.0f}%)")
            del x, g, y, lib
    return rows


def profiled_ms(fn, top: int = 8) -> dict:
    """Device time of K2, K2b and all kernels in one call of ``fn``, from a
    ``torch.profiler`` trace (0 where CUPTI gives no device time), and the
    ``top`` kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {"k2": 0.0, "k2b": 0.0, "all": 0.0}
    kernels = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = float(getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0))) / 1e3
        out["all"] += ms
        kernels.append((ms, e.count, e.key))
        if "instance_norm_bwd" in e.key:
            out["k2b"] += ms
        elif "instance_norm" in e.key:
            out["k2"] += ms
    out["top"] = [dict(ms=ms, calls=n, name=name[:90])
                  for ms, n, name in sorted(kernels, reverse=True)[:top]]
    return out


def compare_grads(card, host, what: str) -> float:
    """Card against host gradients: each leaf within 1e-3 of its largest
    |g|, but the biases that an InstanceNorm cancels (zero gradient, noise
    on both) and up to two leaves above a ReLU kink that the two forwards
    put on different sides (within 5e-2). Returns the worst leaf error."""
    gscale = max(float(v.abs().max()) for v in host.values())
    errs = {}
    for k, h in host.items():
        c = card[k].cpu().double()
        h = h.double()
        scale = float(h.abs().max())
        if scale <= 1e-5 * gscale:
            if float(c.abs().max()) > 1e-5 * gscale:
                raise AssertionError(f"{what} {k}: {float(c.abs().max())}")
            continue
        errs[k] = float((c - h).abs().max()) / scale
    over = {k: e for k, e in errs.items() if e > 1e-3}
    if len(over) > 2 or any(e > 5e-2 for e in over.values()):
        raise AssertionError(f"{what} gradients differ: {over}")
    return max(errs.values())


def phase7(dev: torch.device) -> dict:
    from animateportrait_tpu_torch.ops.instnorm import (
        instance_norm, instance_norm_backward)
    from animateportrait_tpu_torch.train import module2 as m2

    cfg = m2.Module2Config(batch_d_passes=True)
    state = m2.init_state(cfg, torch.Generator().manual_seed(0), dev)
    frozen = m2.init_frozen_random(torch.Generator().manual_seed(1), dev)
    batch = m2.make_random_batch(cfg, TRAIN_BATCH, torch.Generator(
        device=dev).manual_seed(2), dev)
    step = m2.build_train_step(cfg)
    pool_gen = torch.Generator().manual_seed(3)

    kept, hooks = keep_instance_norm_inputs({"g": state.g, "d": state.d},
                                            by_shape=True)
    counts, count_hooks = count_instance_norms(
        [state.g, state.d, frozen.modnet])
    t0 = time.perf_counter()
    step.step(state, batch, frozen, pool_gen)
    torch.cuda.synchronize()
    say(f"[7] warm step {time.perf_counter() - t0:.3f} s (keeps the "
        f"InstanceNorm inputs)")
    for h in hooks + count_hooks:
        h.remove()
    worst = k2_gradient_on_path(kept)
    del kept
    rows = time_training_shapes(dev, counts)

    g0 = next(state.g.parameters()).detach().clone()
    d0 = next(state.d.parameters()).detach().clone()
    torch.cuda.reset_peak_memory_stats(dev)
    instance_norm.launches = 0
    instance_norm_backward.launches = 0
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        metrics = step.step(state, batch, frozen, pool_gen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"instance_norm": instance_norm.launches,
                "instance_norm_backward": instance_norm_backward.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    prof = profiled_ms(lambda: step.step(state, batch, frozen, pool_gen))
    losses = {k: float(v) for k, v in metrics.items()}
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    say(f"[7] timed: {TRAIN_STEPS} steps in {dt:.3f} s = "
        f"{TRAIN_STEPS / dt:.3f} steps/s (batch {TRAIN_BATCH}, smoke "
        f"figure, not a benchmark); peak memory {peak / 2 ** 30:.2f} GiB")
    say(f"[7] kernel launches in the timed steps: {launches} "
        f"({per_step} per step)")
    say(f"[7] profiled step: device time {prof['all']:.3f} ms "
        f"({100 * prof['all'] / (1e3 * dt / TRAIN_STEPS):.1f}% of a timed "
        f"step's wall time), K2 {prof['k2']:.3f} ms, K2b {prof['k2b']:.3f} "
        f"ms")
    for k in prof["top"]:
        say(f"[7]   {k['ms']:9.3f} ms in {k['calls']:4d} calls: {k['name']}")
    say(f"[7] losses after step {state.step}: "
        + ", ".join(f"{k} {v:.4f}" for k, v in losses.items()))
    n_fwd = sum(counts.values())
    n_bwd = sum(n for (_, _, grad), n in counts.items() if grad)
    if per_step != {"instance_norm": n_fwd, "instance_norm_backward": n_bwd}:
        raise AssertionError(f"launches per step {per_step}, InstanceNorm "
                             f"calls {n_fwd}, of them recorded {n_bwd}")
    if not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"non-finite losses {losses}")
    with torch.no_grad():
        moved = (float((next(state.g.parameters()) - g0).abs().max()),
                 float((next(state.d.parameters()) - d0).abs().max()))
    fills = min(cfg.pool_size, 2 * TRAIN_BATCH * (TRAIN_STEPS + 2))
    if not (min(moved) > 0 and state.pool_count == fills
            and bool(state.pool[:fills].abs().sum((1, 2, 3)).gt(0).all())):
        raise AssertionError(f"params moved {moved}, pool {state.pool_count}"
                             f" of {fills}")
    say(f"[7] G and D params moved (max |delta| {moved[0]:.3e}, "
        f"{moved[1]:.3e}); pool holds {state.pool_count} of "
        f"{cfg.pool_size}")
    est = {"k2": sum(r["k2_launches"] * r["k2"]["ms"] for r in rows),
           "k2b": sum(r["k2b_launches"] * r["k2b"]["ms"] for r in rows)}
    say(f"[7] launches x per-shape time per step: K2 {est['k2']:.3f} ms, "
        f"K2b {est['k2b']:.3f} ms")
    del state, frozen, batch
    torch.cuda.empty_cache()
    card_vs_host_grads(dev)
    return {"launches": launches, "per_step": per_step, "rows": rows,
            "worst": worst, "profiled": prof, "estimated": est,
            "steps_per_s": TRAIN_STEPS / dt, "peak_bytes": peak}


def card_vs_host_grads(dev: torch.device) -> None:
    from animateportrait_tpu_torch.train import module2 as m2

    cfg = m2.Module2Config(crop_size=64, ngf=8, ndf=8, steps_per_epoch=2,
                           pool_size=4)
    out = {}
    batch = m2.make_random_batch(cfg, 1, torch.Generator().manual_seed(2),
                                 "cpu")
    for where in (dev, torch.device("cpu")):
        state = m2.init_state(cfg, torch.Generator().manual_seed(0), where)
        frozen = m2.init_frozen_random(torch.Generator().manual_seed(1),
                                       where)
        out[where.type] = m2.build_train_step(cfg).grads(
            state, {k: v.to(where) for k, v in batch.items()}, frozen,
            torch.Generator().manual_seed(3))
    c, h = out["cuda"], out["cpu"]
    loss_err = max(abs(float(c.metrics[k]) - float(v)) / max(abs(float(v)),
                                                              1e-5)
                   for k, v in h.metrics.items())
    g_err = compare_grads(c.g, h.g, "G")
    d_err = compare_grads(c.d, h.d, "D")
    pool_err = float((c.pool.cpu() - h.pool).abs().max())
    say(f"[7] card vs host grads (crop 64, ngf = ndf = 8, batch 1): losses "
        f"max rel diff {loss_err:.2e} (<= 1e-4), worst G leaf {g_err:.2e}, "
        f"worst D leaf {d_err:.2e} (of the leaf's max |g|), pool "
        f"{pool_err:.2e} ({c.pool_count} filled)")
    if not (loss_err <= 1e-4 and c.pool_count == h.pool_count == 2
            and pool_err <= 1e-4):
        raise AssertionError(f"card vs host: losses {loss_err}, pool "
                             f"{pool_err}")


def host_image_times(root: str) -> dict:
    """Host decode and resize times per image on this machine's CPU (best
    of 3): one 512^2 RGB photo alone (inflate + unfilter), its rows'
    unfilter alone, an item's 15 images decoded together, and PIL's
    bicubic resize 512 -> 286 of an RGB and of a gray image."""
    import glob

    from animateportrait_tpu_torch.data.umlvd_ifw import (
        DataConfig, UMLVDIFWDataset)
    from animateportrait_tpu_torch.utils import image

    def best(fn, n=3):
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            out.append(time.perf_counter() - t0)
        return min(out) * 1e3

    photo = sorted(glob.glob(os.path.join(root, "Photo", "*.png")))[0]
    with open(photo, "rb") as f:
        kinds, lines = image._png_rows(photo, f.read())
    h, w, bpp = lines.shape
    per_column = np.repeat(kinds[:, None], bpp, 1)
    rgb = image.load_image(photo)
    gray = image.load_image(photo, grayscale=True)
    ds = UMLVDIFWDataset(DataConfig(root=root, output_nc=1))
    out = {
        "photo_ms": best(lambda: image.load_image(photo)),
        "unfilter_ms": best(lambda: image._unfilter_wavefront(per_column,
                                                             lines)),
        "resize_rgb_ms": best(lambda: image.resize_bicubic_pil(rgb,
                                                               (286, 286))),
        "resize_gray_ms": best(lambda: image.resize_bicubic_pil(gray,
                                                                (286, 286))),
        "item_ms": best(lambda: ds.sample(0, np.random.default_rng(0)))}
    say(f"[8] host CPU per image: a 512^2 RGB all-Paeth photo "
        f"{out['photo_ms']:.1f} ms to decode, {out['unfilter_ms']:.1f} ms of "
        f"it the unfilter (filters {sorted(set(kinds.tolist()))}, "
        f"{h}x{w}x{bpp}); PIL "
        f"bicubic 512 -> 286 {out['resize_rgb_ms']:.1f} ms RGB, "
        f"{out['resize_gray_ms']:.1f} ms gray; one training item (15 "
        f"images) {out['item_ms']:.1f} ms")
    return out


def states_equal(a, b) -> list[str]:
    """The names of the parts of two TrainStates that differ in any bit."""
    from animateportrait_tpu_torch.io.checkpoint import train_state_dict

    diff = []

    def walk(x, y, name):
        if torch.is_tensor(x):
            if not (torch.is_tensor(y) and x.shape == y.shape
                    and x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())):
                diff.append(name)
        elif isinstance(x, dict):
            if not isinstance(y, dict) or set(x) != set(y):
                diff.append(name)
            else:
                for k in x:
                    walk(x[k], y[k], f"{name}.{k}")
        elif isinstance(x, (list, tuple)):
            if len(x) != len(y):
                diff.append(name)
            for i, (u, v) in enumerate(zip(x, y)):
                walk(u, v, f"{name}[{i}]")
        elif x != y:
            diff.append(name)

    walk(train_state_dict(a), train_state_dict(b), "state")
    return diff


def in_cancelled_biases(net) -> set:
    """The names of the biases of convs that an InstanceNorm follows: the
    norm removes any constant, so their gradient is 0 in exact arithmetic
    and rounding noise in fp32."""
    from animateportrait_tpu_torch.nn import InstanceNorm2d

    out = set()
    for name, mod in net.named_modules():
        kids = list(mod.named_children())
        for (a, m), (_, nxt) in zip(kids, kids[1:]):
            if isinstance(m, torch.nn.modules.conv._ConvNd) and isinstance(
                    nxt, InstanceNorm2d) and m.bias is not None:
                out.add(f"{name}.{a}.bias".lstrip("."))
    return out


def _leaf_errors(ref: dict, got: dict, cancelled: set) -> dict:
    """Each leaf's max |got - ref| over its largest |ref|, or over the
    tree's largest |ref| for a bias an InstanceNorm cancels."""
    gscale = max(float(v.abs().max()) for v in ref.values())
    return {k: float((got[k] - v).abs().max())
            / (gscale if k in cancelled else float(v.abs().max()))
            for k, v in ref.items()}


def remat_check(dev: torch.device, root: str) -> dict:
    """The step's ``grads`` at the bench configuration (batch 4, stacked D
    passes) on a batch of the tree, with ``remat`` off and on: each one's
    peak memory and K2 launches; then, with cuDNN's deterministic
    algorithms, the plain step twice and the remat step once: every leaf
    of the remat step within REMAT_RTOL of its scale (the tree's, for the
    biases an InstanceNorm cancels), or within twice the plain step's own
    run-to-run spread there (``F.grid_sample``'s backward adds with
    atomics, so the plain step does not repeat itself to 1e-5 either)."""
    import dataclasses

    from animateportrait_tpu_torch.data.umlvd_ifw import (
        DataConfig, UMLVDIFWDataset)
    from animateportrait_tpu_torch.ops.instnorm import (
        instance_norm, instance_norm_backward)
    from animateportrait_tpu_torch.train import module2 as m2

    cfg = m2.Module2Config(batch_d_passes=True)
    ds = UMLVDIFWDataset(DataConfig(root=root, output_nc=1))
    batch = {k: torch.as_tensor(v).to(dev) for k, v in ds.batch(
        list(range(TRAIN_BATCH)), np.random.default_rng(7)).items()}
    state = m2.init_state(cfg, torch.Generator().manual_seed(0), dev)
    frozen = m2.init_frozen_random(torch.Generator().manual_seed(1), dev)
    steps = {r: m2.build_train_step(dataclasses.replace(cfg, remat=r))
             for r in (False, True)}

    def grads(remat):
        return steps[remat].grads(state, batch, frozen, torch.Generator(
            device=dev).manual_seed(3))

    mem = {}
    for remat in (False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        instance_norm.launches = instance_norm_backward.launches = 0
        g = grads(remat)
        torch.cuda.synchronize()
        mem[remat] = (torch.cuda.max_memory_allocated(dev),
                      instance_norm.launches, instance_norm_backward.launches)
        del g
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        plain, again, remat = grads(False), grads(False), grads(True)
    finally:
        torch.cuda.synchronize()
        torch.backends.cudnn.deterministic = det
    worst = {}
    for net in ("g", "d"):
        ref = getattr(plain, net)
        cancelled = in_cancelled_biases(getattr(state, net))
        spread = _leaf_errors(ref, getattr(again, net), cancelled)
        diff = _leaf_errors(ref, getattr(remat, net), cancelled)
        k = max(diff, key=diff.get)
        worst[net] = dict(remat=diff[k], leaf=k, spread_there=spread[k],
                          spread=max(spread.values()),
                          over=sorted((round(diff[n], 9), n) for n in diff
                                      if diff[n] > REMAT_RTOL)[-4:],
                          failed=[n for n in diff if diff[n] > max(
                              REMAT_RTOL, 2 * spread[n])])
    (p0, k0, b0), (p1, k1, b1) = mem[False], mem[True]
    say(f"[8] remat at the bench batch (batch 4, a batch of the tree): peak "
        f"{p0 / 2 ** 30:.2f} GiB without, {p1 / 2 ** 30:.2f} GiB with; K2 "
        f"launches {k0} -> {k1}, K2b {b0} -> {b1}")
    for net, w in worst.items():
        say(f"[8] remat vs plain {net.upper()} (cuDNN deterministic), of each "
            f"leaf's scale: worst {w['remat']:.2e} at {w['leaf']} (plain vs "
            f"plain there {w['spread_there']:.2e}; worst plain vs plain "
            f"{w['spread']:.2e}); leaves over {REMAT_RTOL}: {w['over']}")
    if any(w["failed"] for w in worst.values()) or k1 <= k0:
        raise AssertionError(f"remat grads differ {worst}, or K2 was not "
                             f"run again ({k0} -> {k1})")
    return {"peak_bytes": p0, "peak_bytes_remat": p1, "worst": worst,
            "k2_launches": (k0, k1)}


def phase8(dev: torch.device, tmp: str) -> dict:
    from animateportrait_tpu_torch import train_cli
    from animateportrait_tpu_torch.io.checkpoint import CheckpointManager
    from animateportrait_tpu_torch.ops.instnorm import (
        instance_norm, instance_norm_backward)
    from animateportrait_tpu_torch.train import module2 as m2
    from animateportrait_tpu_torch.utils.image import read_image
    from animateportrait_tpu_torch.utils.options import to_configs
    from animateportrait_tpu_torch.utils.smoke import write_umlvd_tree

    t0 = time.perf_counter()
    root = write_umlvd_tree(os.path.join(tmp, "data"), n_photos=16,
                            n_styles=16, clips=2, frames=8, size=512,
                            seed=0, png_filter=4)
    say(f"[8] wrote the synthetic UMLVD-IFW tree (16 photos, 16 "
        f"drawings, 2 clips x 8 frames, 512^2, Paeth rows) in "
        f"{time.perf_counter() - t0:.1f} s")
    host = host_image_times(root)
    ck = os.path.join(tmp, "ck")
    argv = ["--dataroot", root, *README_DRAWING, "--crop_size", "256",
            "--load_size", "286", "--ngf", "64", "--ndf", "64",
            "--batch_size", str(TRAIN_BATCH), "--num_threads", "8",
            "--save_latest_freq", "4", "--display_freq", "4",
            "--update_html_freq", "4", "--print_freq", "1",
            "--checkpoints_dir", ck, "--frozen_dir",
            os.path.join(tmp, "frozen"), "--device", "cuda"]
    cfg, _ = to_configs(train_cli.build_argparser().parse_args(argv))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    instance_norm.launches = instance_norm_backward.launches = 0
    t0 = time.perf_counter()
    run = train_cli.main(argv + ["--max_steps", str(CLI_STEPS)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"instance_norm": instance_norm.launches,
                "instance_norm_backward": instance_norm_backward.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    recs = {r.step: r for r in run.records}
    if sorted(recs) != list(range(1, CLI_STEPS + 1)):
        raise AssertionError(f"logged steps {sorted(recs)}")
    timed = [recs[i] for i in range(3, CLI_STEPS + 1)]
    sps = len(timed) / (recs[CLI_STEPS].t_end - recs[2].t_end)
    data_share = sum(r.data_s for r in timed) / sum(
        r.data_s + r.comp_s for r in timed)
    say(f"[8] train_cli.main, the readme's drawing command at crop 256, "
        f"ngf = ndf = 64, batch {TRAIN_BATCH}, 8 loader workers: "
        f"{CLI_STEPS} steps in {wall:.1f} s of wall time (workers' start, "
        f"init, saves and visuals included); steps 3-{CLI_STEPS}: "
        f"{sps:.3f} steps/s with the data loading, data-wait share "
        f"{100 * data_share:.1f}% (whole run {100 * run.data_share:.1f}%)"
        f"; per step data/compute s: "
        + ", ".join(f"{r.step}: {r.data_s:.3f}/{r.comp_s:.3f}"
                    for r in run.records))
    say(f"[8] peak memory {peak / 2 ** 30:.2f} GiB; kernel launches in "
        f"the run: {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the trainer's path never "
                             f"launched: {launches}")

    exp = os.path.join(ck, "training", "drawing1")
    mgr = CheckpointManager(os.path.join(exp, "checkpoints"))
    saved = (mgr.all_steps(), sorted(os.listdir(
        os.path.join(exp, "checkpoints", "latest"))))
    if saved != ([CLI_STEPS], [f"{CLI_STEPS}.pt"]):
        raise AssertionError(f"checkpoint steps {saved}")
    run2 = train_cli.main(argv + ["--max_steps", str(CLI_STEPS + 2),
                                  "--continue_train"])
    if run2.resumed_from != CLI_STEPS or run2.state.step != CLI_STEPS + 2:
        raise AssertionError(f"resumed from {run2.resumed_from}, ended "
                             f"at {run2.state.step}")
    fresh = mgr.restore(CLI_STEPS, m2.init_state(
        cfg, torch.Generator().manual_seed(5), dev))
    diff = states_equal(run.state, fresh)
    if diff:
        raise AssertionError(f"restored state differs from the saved "
                             f"one at {diff[:8]}")
    with open(os.path.join(exp, "loss_log.txt")) as f:
        log = f.read()
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    images = sorted(os.listdir(os.path.join(exp, "web", "images")))
    png = read_image(os.path.join(exp, "web", "images", images[0]))
    if not (f"iters: {CLI_STEPS + 2}," in log and len(rows) == 10
            and all(np.isfinite(v) for r in rows for v in r.values())
            and len(images) == 2 * 11
            and png.shape == (cfg.crop_size, cfg.crop_size, 3)
            and os.path.exists(os.path.join(exp, "web", "index.html"))
            and os.path.exists(os.path.join(exp, "train_opt.txt"))):
        raise AssertionError(f"trainer outputs: {len(rows)} metric rows, "
                             f"{len(images)} gallery images {png.shape}")
    say(f"[8] --continue_train resumed at step {run2.resumed_from} and "
        f"ended at {run2.state.step}; the state restored from the "
        f"step-{CLI_STEPS} checkpoint equals the saved one bit for bit; "
        f"loss_log.txt and metrics.jsonl hold {len(rows)} finite rows, "
        f"the gallery {len(images)} PNGs ({images[0]} reads back as "
        f"{png.shape}) and index.html; losses at step "
        f"{rows[-1]['iters']}: G {rows[-1]['G']:.4f}, D_A "
        f"{rows[-1]['D_A']:.4f}")
    del run, run2, fresh
    torch.cuda.empty_cache()
    remat = remat_check(dev, root)
    return {"launches": launches, "steps_per_s": sps, "data_share": data_share,
            "peak_bytes": peak, "host": host, "remat": remat, "root": root,
            "argv": argv}


def zero_counters() -> None:
    """Every kernel's launch counters to 0."""
    from animateportrait_tpu_torch.ops.instnorm import (
        instance_norm, instance_norm_backward)
    from animateportrait_tpu_torch.ops.stft import stft_magnitude

    stft_magnitude.launches = 0
    for fn in (instance_norm, instance_norm_backward):
        fn.launches = fn.launches_bf16 = 0


def read_counters() -> dict[str, int]:
    """Every kernel's launch counter, by the kernel's name in the JSON
    line."""
    from animateportrait_tpu_torch.ops.instnorm import (
        instance_norm, instance_norm_backward)
    from animateportrait_tpu_torch.ops.stft import stft_magnitude

    return {"stft_magnitude": stft_magnitude.launches,
            "instance_norm": instance_norm.launches,
            "instance_norm_bf16": instance_norm.launches_bf16,
            "instance_norm_backward": instance_norm_backward.launches,
            "instance_norm_backward_bf16":
                instance_norm_backward.launches_bf16}


def phase9(dev: torch.device, main_run: dict) -> dict:
    from animateportrait_tpu_torch import cli
    from animateportrait_tpu_torch.utils.smoke import (
        build_pipeline, full_width_nets, make_wav, write_mtcnn_weights)
    from animateportrait_tpu_torch.utils.video import read_avi, write_wav

    nets = full_width_nets(seed=0)
    pipe = build_pipeline(nets, dev, frame_batch=8, output_uint8=True,
                          use_bf16=True)
    photo = np.random.default_rng(0).uniform(0, 255, (512, 512, 3)).astype(
        np.uint8)
    kept, hooks = keep_instance_norm_inputs({"g": pipe.renderer.g})
    with torch.inference_mode():
        t0 = time.perf_counter()
        pipe(photo, make_wav(6.0, seed=1))
        torch.cuda.synchronize()
        say(f"[9] warm pass {time.perf_counter() - t0:.3f} s (keeps the "
            f"generator's bf16 InstanceNorm inputs)")
        for h in hooks:
            h.remove()
        zero_counters()
        t0 = time.perf_counter()
        out = pipe(photo, make_wav(6.0, seed=2))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = read_counters()
    T = out.frames.shape[0]
    p = psnr(out.frames, main_run["frames"], peak=255.0)
    stages = ", ".join(f"{k} {v:.3f} s" for k, v in out.stage_seconds.items())
    say(f"[9] timed --render_bf16 pass: {T} frames in {dt:.3f} s = "
        f"{T / dt:.2f} frames/s (smoke figure, not a benchmark); stages: "
        f"{stages}")
    say(f"[9] kernel launches in the timed pass: {launches}; frames vs "
        f"phase 3's fp32 frames on the same inputs: PSNR {p:.2f} dB (>= "
        f"{BF16_RENDER_MIN_PSNR})")
    if out.frames.shape != main_run["frames"].shape:
        raise AssertionError(f"bf16 frames {out.frames.shape}")
    if min(launches[k] for k in ("stft_magnitude", "instance_norm",
                                 "instance_norm_bf16")) <= 0:
        raise AssertionError(f"a kernel of the bf16 render never launched: "
                             f"{launches}")
    if not p >= BF16_RENDER_MIN_PSNR:
        raise AssertionError(f"bf16 frames at {p:.2f} dB from the fp32 ones")
    err = k2_on_path(kept, "9")
    k2_time = k2_time_on_path(pipe.renderer, out.landmarks, "9")
    del pipe, nets, kept

    with tempfile.TemporaryDirectory() as tmp:
        photo_path = write_photo(os.path.join(tmp, "portrait.ppm"))
        wav_path = write_wav(os.path.join(tmp, "speech.wav"),
                             make_wav(6.0, seed=3))
        ckpt = os.path.join(tmp, "ckpt")
        write_mtcnn_weights(os.path.join(ckpt, "mtcnn"), seed=0)
        zero_counters()
        t0 = time.perf_counter()
        res = cli.main(["--jpg", photo_path, "--audio", wav_path, "--exp",
                        "formal/cartoon", "--device", "cuda",
                        "--frame_batch", "8", "--render_bf16", "--ckpt_dir",
                        ckpt, "--output", os.path.join(tmp, "out")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cli_launches = read_counters()
        avi = read_avi(res.path)
    piped = sum(res.stage_seconds.values())
    say(f"[9] cli.main --exp formal/cartoon --render_bf16: {res.frames} "
        f"frames, pipeline + mux {piped:.3f} s = {res.frames / piped:.2f} "
        f"frames/s; cli.main wall {wall:.3f} s; kernel launches "
        f"{cli_launches}; the AVI reads back as {avi['frames'].shape} at "
        f"{avi['fps']} fps")
    if avi["frames"].shape != (res.frames, 256, 256, 3) or min(
            cli_launches[k] for k in ("stft_magnitude", "instance_norm",
                                      "instance_norm_bf16")) <= 0:
        raise AssertionError(f"bf16 CLI run: {avi['frames'].shape}, "
                             f"{cli_launches}")
    return {"launches": launches, "cli_launches": cli_launches,
            "frames_per_s": T / dt, "psnr_vs_fp32": p, "k2_path_err": err,
            "k2_time": k2_time}


def phase10(dev: torch.device, trainer: dict) -> dict:
    from animateportrait_tpu_torch import train_cli
    from animateportrait_tpu_torch.io.checkpoint import CheckpointManager
    from animateportrait_tpu_torch.train import module2 as m2
    from animateportrait_tpu_torch.utils.options import to_configs

    cfg = m2.Module2Config(batch_d_passes=True, compute_dtype="bfloat16")
    state = m2.init_state(cfg, torch.Generator().manual_seed(0), dev)
    frozen = m2.init_frozen_random(torch.Generator().manual_seed(1), dev)
    batch = m2.make_random_batch(cfg, TRAIN_BATCH, torch.Generator(
        device=dev).manual_seed(2), dev)
    step = m2.build_train_step(cfg)
    pool_gen = torch.Generator().manual_seed(3)

    kept, hooks = keep_instance_norm_inputs({"g": state.g, "d": state.d},
                                            by_shape=True)
    counts, count_hooks = count_instance_norms(
        [state.g, state.d, step.frozen_nets(frozen).modnet])
    t0 = time.perf_counter()
    step.step(state, batch, frozen, pool_gen)
    torch.cuda.synchronize()
    say(f"[10] warm bf16 step {time.perf_counter() - t0:.3f} s (keeps the "
        f"bf16 InstanceNorm inputs)")
    for h in hooks + count_hooks:
        h.remove()
    if {x.dtype for x, _ in kept.values()} != {torch.bfloat16}:
        raise AssertionError("an InstanceNorm of the bf16 step saw fp32")
    fwd_err = k2_on_path(kept, "10")
    worst = k2_gradient_on_path(kept, "10")
    del kept
    rows = time_training_shapes(dev, counts, "10", torch.bfloat16)

    g0 = next(state.g.parameters()).detach().clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counters()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        metrics = step.step(state, batch, frozen, pool_gen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated(dev)
    prof = profiled_ms(lambda: step.step(state, batch, frozen, pool_gen))
    losses = {k: float(v) for k, v in metrics.items()}
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    say(f"[10] timed: {TRAIN_STEPS} bf16 steps in {dt:.3f} s = "
        f"{TRAIN_STEPS / dt:.3f} steps/s (batch {TRAIN_BATCH}, smoke "
        f"figure, not a benchmark); peak memory {peak / 2 ** 30:.2f} GiB; "
        f"launches per step {per_step}")
    say(f"[10] profiled bf16 step: device time {prof['all']:.3f} ms "
        f"({100 * prof['all'] / (1e3 * dt / TRAIN_STEPS):.1f}% of a timed "
        f"step's wall time), K2-bf16 {prof['k2']:.3f} ms, K2b-bf16 "
        f"{prof['k2b']:.3f} ms")
    for k in prof["top"]:
        say(f"[10]   {k['ms']:9.3f} ms in {k['calls']:4d} calls: {k['name']}")
    say(f"[10] losses after step {state.step}: "
        + ", ".join(f"{k} {v:.4f}" for k, v in losses.items()))
    n_fwd = sum(counts.values())
    n_bwd = sum(n for (_, _, grad), n in counts.items() if grad)
    got = tuple(per_step[k] for k in ("instance_norm_bf16",
                                      "instance_norm_backward_bf16",
                                      "instance_norm"))
    if got != (n_fwd, n_bwd, 0):
        raise AssertionError(f"launches per step {per_step}, InstanceNorm "
                             f"calls {n_fwd}, of them recorded {n_bwd}")
    with torch.no_grad():
        moved = float((next(state.g.parameters()) - g0).abs().max())
    if not (all(np.isfinite(v) for v in losses.values()) and moved > 0
            and {p.dtype for p in state.g.parameters()} == {torch.float32}):
        raise AssertionError(f"bf16 step: losses {losses}, G moved {moved}")
    est = {"k2": sum(r["k2_launches"] * r["k2"]["ms"] for r in rows),
           "k2b": sum(r["k2b_launches"] * r["k2b"]["ms"] for r in rows)}
    say(f"[10] launches x per-shape time per step: K2-bf16 {est['k2']:.3f} "
        f"ms, K2b-bf16 {est['k2b']:.3f} ms")
    del state, frozen, batch, step
    torch.cuda.empty_cache()

    # the trainer, bf16, over phase 8's tree
    ck = os.path.join(os.path.dirname(trainer["root"]), "ck_bf16")
    argv = trainer["argv"] + ["--checkpoints_dir", ck, "--compute_dtype",
                              "bfloat16", "--max_steps", "4"]
    cfg_cli, _ = to_configs(train_cli.build_argparser().parse_args(argv))
    zero_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    run = train_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cli_launches = read_counters()
    cli_peak = torch.cuda.max_memory_allocated(dev)
    recs = {r.step: r for r in run.records}
    sps = 2 / (recs[4].t_end - recs[2].t_end)
    saved = CheckpointManager(os.path.join(
        ck, "training", "drawing1", "checkpoints")).restore(4, None)
    say(f"[10] train_cli.main --compute_dtype bfloat16 (phase 8's command, "
        f"4 steps): {wall:.1f} s of wall time; steps 3-4 {sps:.3f} steps/s "
        f"with the data; peak {cli_peak / 2 ** 30:.2f} GiB; launches "
        f"{cli_launches}; the step-4 checkpoint holds a "
        f"{saved['compute_dtype']} run's fp32 masters")
    if not (run.state.step == 4 and saved["compute_dtype"] == "bfloat16"
            and cfg_cli.compute_dtype == "bfloat16"
            and min(cli_launches["instance_norm_bf16"],
                    cli_launches["instance_norm_backward_bf16"]) > 0
            and {v.dtype for v in saved["g"].values()} == {torch.float32}):
        raise AssertionError(f"bf16 trainer: step {run.state.step}, "
                             f"{cli_launches}, {saved['compute_dtype']}")
    del run, saved
    torch.cuda.empty_cache()
    return {"launches": launches, "per_step": per_step, "rows": rows,
            "worst": worst, "fwd_err": fwd_err, "profiled": prof,
            "estimated": est, "steps_per_s": TRAIN_STEPS / dt,
            "peak_bytes": peak, "cli_launches": cli_launches,
            "cli_steps_per_s": sps}


def jpeg_tree(root: str, dest: str) -> str:
    """A copy of phase 8's UMLVD-IFW tree whose photos are copies of the
    committed JPEG fixture: ``Photo/<name>.jpg`` in place of each
    ``<name>.png``, and the files found by the photo's path (its dot image,
    masks and static stylization) renamed to ``.jpg`` beside it, their bytes still PNG (both
    readers go by the bytes, not the name)."""
    import glob
    import shutil

    from animateportrait_tpu_torch.utils.assets import ASSET_DIR

    shutil.copytree(root, dest)
    fixture = os.path.join(ASSET_DIR, JPEG_FIXTURES[0])
    for photo in glob.glob(os.path.join(dest, "Photo", "**", "*.png"),
                           recursive=True):
        stem = os.path.splitext(photo)[0]
        os.remove(photo)
        shutil.copyfile(fixture, stem + ".jpg")
        for sub in ("/Alm/MTCNN/", "/Amask/nose/", "/Amask/eyes/",
                    "/Amask/lips/", "/fakeB_static/"):
            twin = stem.replace("/Photo/", sub) + ".png"
            os.rename(twin, os.path.splitext(twin)[0] + ".jpg")
    return dest


def decode_fixtures() -> dict:
    """Phase 11's first step: the committed JPEG fixtures decoded by both
    readers, each decode's SHA-256 against the one PIL and OpenCV gave
    (``assets/jpeg_fixtures.json``); the host ms per 512^2 image, median
    of 5."""
    import hashlib

    from animateportrait_tpu_torch.utils import image
    from animateportrait_tpu_torch.utils.assets import ASSET_DIR

    with open(os.path.join(ASSET_DIR, "jpeg_fixtures.json")) as f:
        table = json.load(f)
    ms = {}
    for name in JPEG_FIXTURES:
        path = os.path.join(ASSET_DIR, name)
        reads = {"pil_rgb": lambda: image.load_image(path),
                 "pil_l": lambda: image.load_image(path, grayscale=True),
                 "cv2_bgr": lambda: image.read_image(path)}
        for key, read in reads.items():
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                px = np.ascontiguousarray(read())
                times.append(time.perf_counter() - t0)
            got = {"sha256": hashlib.sha256(px.tobytes()).hexdigest(),
                   "shape": list(px.shape)}
            if got != table[name][key]:
                raise AssertionError(f"{name} as {key}: {got}, PIL/OpenCV "
                                     f"gave {table[name][key]}")
            ms[f"{name}:{key}"] = float(np.median(times) * 1e3)
    say("[11] the JPEG fixtures decode to PIL's and OpenCV's SHA-256 "
        "(4:2:0 q90, restart every 4 MCUs, EXIF 6; and gray); host ms per "
        "512^2 image, median of 5: "
        + ", ".join(f"{k} {v:.1f}" for k, v in ms.items()))
    return ms


class _Recorder:
    """A pipeline's renderer that records the source and target landmarks
    of each call (numpy) and passes every call and attribute through."""

    def __init__(self, renderer):
        self.renderer = renderer
        self.calls = []

    def __getattr__(self, name):
        return getattr(self.renderer, name)

    def __call__(self, photo, a68, tb68, *args, **kwargs):
        self.calls.append((np.asarray(a68, np.float32),
                           np.asarray(tb68, np.float32)))
        return self.renderer(photo, a68, tb68, *args, **kwargs)


def near_tie(host: np.ndarray, card: np.ndarray, err: float) -> bool:
    """Whether the card's decode of one (64, 64) heatmap may differ from
    the host's only because the two differ by ``err``: its peak is within
    2 err of the host's peak value, and where the peaks agree, a
    neighbour pair whose order sets the quarter-pixel shift is within
    2 err."""
    h, w = host.shape
    hy, hx = np.unravel_index(np.argmax(host), host.shape)
    cy, cx = np.unravel_index(np.argmax(card), card.shape)
    if (hy, hx) != (cy, cx):
        return bool(host[cy, cx] >= host[hy, hx] - 2 * err)
    pairs = [(host[hy, min(hx + 1, w - 1)], host[hy, max(hx - 1, 0)]),
             (host[min(hy + 1, h - 1), hx], host[max(hy - 1, 0), hx])]
    return any(abs(a - b) <= 2 * err for a, b in pairs)


def fan_card_vs_host(dev: torch.device, ckpt: str, img_bgr: np.ndarray
                     ) -> dict:
    """FAN3D + ResNetDepth from the checkpoints in ``ckpt`` on the card and
    on the host, on one crop of ``img_bgr``: heatmaps and raw z max|diff|,
    the landmarks that differ, and the card's ms per photo (median of 5
    after a warm-up): the nets alone, and crop + nets + transforms."""
    from animateportrait_tpu_torch.io.reference import (
        load_fa_state_dict, load_into)
    from animateportrait_tpu_torch.models import fan3d

    fan_path, depth_path = fan3d.find_fan_checkpoints(ckpt)
    rgb = np.ascontiguousarray(img_bgr[:, :, ::-1])
    h, w = rgb.shape[:2]
    box = (w * 0.25, h * 0.2, w * 0.75, h * 0.8)
    crop = fan3d.fa_crop(rgb, *fan3d.bbox_to_center_scale(box))
    out = {}
    for where in (dev, torch.device("cpu")):
        fa = fan3d.FaceAlignment3D(
            load_into(fan3d.FAN3D(), load_fa_state_dict(fan_path)),
            load_into(fan3d.ResNetDepth(), load_fa_state_dict(depth_path)),
            device=where)
        hm, preds, z = fa.heatmaps_and_depth(crop)
        out[where.type] = (hm.cpu().numpy(), z.cpu().numpy(),
                           fa.landmarks_from_box(rgb, box))
        if where.type == "cuda":
            times = {"nets": [], "photo": []}
            for _ in range(6):
                for key, fn in (("nets", lambda: fa.heatmaps_and_depth(crop)),
                                ("photo", lambda: fa.landmarks_from_box(
                                    rgb, box))):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    times[key].append(time.perf_counter() - t0)
            ms = {k: float(np.median(v[1:]) * 1e3) for k, v in times.items()}
        del fa
    (hc, zc, lc), (hh, zh, lh) = out["cuda"], out["cpu"]
    err = float(np.abs(hc - hh).max())
    differ = np.flatnonzero((lc[:, :2] != lh[:, :2]).any(1))
    res = {"hm_err": err, "z_err": float(np.abs(zc - zh).max()),
           "hm_scale": float(np.abs(hh).max()), "differ": len(differ),
           "unexplained": [int(c) for c in differ
                           if not near_tie(hh[0, c], hc[0, c], err)],
           "ms": ms}
    say(f"[11] FAN3D (4 modules) + ResNetDepth (3, 8, 36, 3) card vs host: "
        f"heatmaps max|diff| {res['hm_err']:.3e} (of max |h| "
        f"{res['hm_scale']:.3e}), raw z max|diff| {res['z_err']:.3e}, "
        f"{res['differ']} of 68 landmarks differ in x or y (not at a "
        f"near-tie of the heatmaps: {res['unexplained']}); card ms per "
        f"photo, median of 5: nets {ms['nets']:.2f}, crop + nets + "
        f"transforms {ms['photo']:.2f}")
    if not (res["hm_err"] <= FAN_ATOL and not res["unexplained"]
            and np.isfinite(zc).all() and np.isfinite(lc).all()):
        raise AssertionError(f"FAN card vs host: {res}")
    return res


def phase11(dev: torch.device, main_run: dict, trainer: dict) -> dict:
    """The user's own photo: the JPEG fixtures, seeded full-width FAN and
    depth checkpoints, ``cli.main --exp formal/drawing --warp_mode tps``
    on the JPEG, card against host for FAN and a TPS render batch, the
    drawing pipeline with TPS grids against phase 3's linear ones, and the
    trainer over JPEG photos."""
    from animateportrait_tpu_torch import cli, train_cli
    from animateportrait_tpu_torch.ops.tps import (
        linear_motion_grid, motion_grid_from_landmarks, triangulate_frames)
    from animateportrait_tpu_torch.utils.assets import ASSET_DIR
    from animateportrait_tpu_torch.utils.image import read_image
    from animateportrait_tpu_torch.utils.smoke import (
        build_pipeline, full_width_nets, make_wav, write_fan_checkpoints,
        write_mtcnn_weights)
    from animateportrait_tpu_torch.utils.video import read_avi, write_wav

    ms = decode_fixtures()
    jpg = os.path.join(ASSET_DIR, JPEG_FIXTURES[0])
    with tempfile.TemporaryDirectory() as tmp:
        wav_path = write_wav(os.path.join(tmp, "speech.wav"),
                             make_wav(6.0, seed=3))
        ckpt = os.path.join(tmp, "ckpt")
        write_mtcnn_weights(os.path.join(ckpt, "mtcnn"), seed=0)
        t0 = time.perf_counter()
        write_fan_checkpoints(os.path.join(ckpt, "face_alignment"), seed=0)
        say(f"[11] wrote seeded FAN3D (4 modules) and ResNetDepth "
            f"(3, 8, 36, 3) checkpoints in face_alignment's layout in "
            f"{time.perf_counter() - t0:.1f} s")
        argv = ["--jpg", jpg, "--audio", wav_path, "--exp",
                "formal/drawing", "--warp_mode", "tps", "--device", "cuda",
                "--frame_batch", "8", "--ckpt_dir", ckpt, "--output",
                os.path.join(tmp, "out")]
        zero_counters()
        t0 = time.perf_counter()
        res = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counters()
        avi = read_avi(res.path)
        fan = fan_card_vs_host(dev, ckpt, read_image(jpg))
    T = res.frames
    piped = sum(res.stage_seconds.values())
    stages = ", ".join(f"{k} {v:.3f} s" for k, v in res.stage_seconds.items())
    say(f"[11] cli.main --exp formal/drawing --warp_mode tps on the JPEG "
        f"with FAN + depth: {T} frames, pipeline + mux {piped:.3f} s = "
        f"{T / piped:.2f} frames/s (smoke figure; phase 3's linear "
        f"pipeline {main_run['frames_per_s']:.2f}); cli.main wall "
        f"{wall:.3f} s; stages: {stages}")
    say(f"[11] kernel launches in the CLI run: {launches}; the AVI reads "
        f"back as {avi['frames'].shape} at {avi['fps']} fps")
    if min(launches["stft_magnitude"], launches["instance_norm"]) <= 0:
        raise AssertionError(f"a kernel of the JPEG + FAN + tps CLI path "
                             f"never launched: {launches}")
    if "fan" not in res.stage_seconds or avi["frames"].shape != (
            T, 256, 256, 3) or avi["fps"] != 62.5:
        raise AssertionError(f"CLI run: stages {list(res.stage_seconds)}, "
                             f"AVI {avi['frames'].shape}")

    # the drawing pipeline of phase 3 with TPS grids, on its inputs
    nets = full_width_nets(seed=0)
    pipe = build_pipeline(nets, dev, frame_batch=8, output_uint8=True,
                          motion_mode="tps")
    pipe.renderer = _Recorder(pipe.renderer)
    photo = np.random.default_rng(0).uniform(0, 255, (512, 512, 3)).astype(
        np.uint8)
    with torch.inference_mode():
        pipe(photo, make_wav(6.0, seed=1))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipe(photo, make_wav(6.0, seed=2))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        # the renderer's own source and target landmarks, the first two
        # batches (the linear grid's per-pixel, per-triangle temporaries
        # grow with the frame count)
        a68, tb68 = pipe.renderer.calls[-1]
        lm = torch.as_tensor(tb68[:16], device=dev)
        src = torch.as_tensor(a68, device=dev)[None].expand_as(lm)
        tps = motion_grid_from_landmarks(src, lm)
        lin = linear_motion_grid(src, lm, torch.as_tensor(triangulate_frames(
            tb68[:16], 256), device=dev))
        gap = ((tps - lin).abs() * 127.5).flatten()
        dev_px = (gap.mean().item(), torch.quantile(gap, 0.99).item(),
                  gap.max().item())
    pipe.renderer = pipe.renderer.renderer
    p_lin = psnr(out.frames, main_run["frames"], peak=255.0)
    say(f"[11] drawing pipeline, tps grids, phase 3's inputs: "
        f"{out.frames.shape[0]} frames in {dt:.3f} s = "
        f"{out.frames.shape[0] / dt:.2f} frames/s (phase 3, linear: "
        f"{main_run['frames_per_s']:.2f}); frames vs phase 3's linear "
        f"frames PSNR {p_lin:.2f} dB; the TPS grid against the "
        f"griddata-linear one on the renderer's landmarks, first 16 "
        f"frames: mean {dev_px[0]:.4f} px, 99th percentile "
        f"{dev_px[1]:.4f} px, max {dev_px[2]:.4f} px (x and y apart)")

    # card against host: a 2-frame TPS render batch
    photo_f = np.random.default_rng(4).uniform(-1, 1, (256, 256, 3)).astype(
        np.float32)
    tb68 = (main_run["landmarks"][:2, :, :2] * 0.5).astype(np.float32)
    frames = {}
    for where in (dev, torch.device("cpu")):
        r = build_pipeline(copy.deepcopy(nets), where, frame_batch=2,
                           output_uint8=False, motion_mode="tps").renderer
        with torch.inference_mode():
            frames[where.type] = r(photo_f, tb68.mean(0), tb68)
    p_render = psnr(frames["cuda"], frames["cpu"], peak=2.0)
    say(f"[11] card vs host: 2-frame tps render PSNR {p_render:.2f} dB "
        f"(>= 40)")
    if not p_render >= 40.0:
        raise AssertionError(f"tps render card vs host {p_render:.2f} dB")
    del pipe, nets

    # the trainer over JPEG photos
    root = jpeg_tree(trainer["root"], os.path.join(
        os.path.dirname(trainer["root"]), "data_jpeg"))
    argv = trainer["argv"] + ["--dataroot", root, "--checkpoints_dir",
                              os.path.join(os.path.dirname(root), "ck_jpeg"),
                              "--max_steps", str(CLI_STEPS)]
    zero_counters()
    t0 = time.perf_counter()
    run = train_cli.main(argv)
    torch.cuda.synchronize()
    twall = time.perf_counter() - t0
    tl = read_counters()
    recs = {r.step: r for r in run.records}
    timed = [recs[i] for i in range(3, CLI_STEPS + 1)]
    sps = len(timed) / (recs[CLI_STEPS].t_end - recs[2].t_end)
    share = sum(r.data_s for r in timed) / sum(r.data_s + r.comp_s
                                               for r in timed)
    host = trainer["host"]
    say(f"[11] train_cli.main over the tree with JPEG photos (phase 8's "
        f"command, {CLI_STEPS} steps): {twall:.1f} s of wall time; steps "
        f"3-{CLI_STEPS}: {sps:.3f} steps/s with the data, data-wait share "
        f"{100 * share:.1f}%, whole run {100 * run.data_share:.1f}% "
        f"(phase 8, PNG photos: {trainer['steps_per_s']:.3f} steps/s, "
        f"{100 * trainer['data_share']:.1f}%); per step data/compute s: "
        + ", ".join(f"{r.step}: {r.data_s:.3f}/{r.comp_s:.3f}"
                    for r in run.records)
        + f"; host ms per 512^2 photo: JPEG "
        f"{ms[JPEG_FIXTURES[0] + ':pil_rgb']:.1f}, phase 8's Paeth PNG "
        f"{host['photo_ms']:.1f}; launches {tl}")
    if run.state.step != CLI_STEPS or min(tl["instance_norm"],
                                  tl["instance_norm_backward"]) <= 0:
        raise AssertionError(f"trainer over JPEG photos: step "
                             f"{run.state.step}, {tl}")
    del run
    torch.cuda.empty_cache()
    return {"launches": launches, "frames_per_s": T / piped,
            "tps_frames_per_s": out.frames.shape[0] / dt,
            "tps_psnr_vs_linear": p_lin, "tps_grid_px": dev_px,
            "jpeg_ms": ms, "fan": fan, "data_share": share,
            "steps_per_s": sps, "train_launches": tl}


# phase 12: test_cli's frames (the layout of write_test_layout), the card
# against the host on 2 frames of render_visuals, the batched landmark
# predictor against the single one, Photo2Cartoon light=False card vs host
TEST_CLI_FRAMES = 16
VISUALS_MIN_PSNR = 40.0
LANDMARK_BATCH_ATOL = 1e-4
# batched against single MTCNN calls on the card: px for boxes and five
# points, and for scores; one run measured 3.05e-5 px on the boxes
DETECT_BATCH_ATOL = 1e-3
P2C_FULL_MIN_PSNR = 40.0


def test_cli_argv(db: str, ckpt: str, results: str, device: str) -> list:
    """The reference's test command (main_end2end_module2.py:71-87) at
    full width."""
    return (f"--dataroot {db} --name formal/drawing --model geomcgt_ifw_test "
            "--netG resnet_9blocks_rcatland32_full_ifw --netg_resb_div 3 "
            "--netg_resb_disp 3 --output_nc 1 --load_size 256 --crop_size 256 "
            f"--epoch 70 --num_test {TEST_CLI_FRAMES} --serial_batches "
            f"--imagefolder {db} --frame_batch 8 --checkpoints_dir {ckpt} "
            f"--results_dir {results} --device {device}").split()


def phase12_test_cli(dev: torch.device, tmp: str) -> dict:
    """``test_cli.main`` over a seeded driver layout, the launch counters
    zeroed just before it; frames/s of ``render_visuals`` beside
    ``__call__`` on the same inputs; K2 against its plain version on the
    renderer's InstanceNorm inputs; card against host on 2 frames."""
    from animateportrait_tpu_torch import test_cli
    from animateportrait_tpu_torch.utils.image import (
        draw_landmarks, read_image)
    from animateportrait_tpu_torch.utils.smoke import write_test_layout

    root = os.path.join(tmp, "layout")
    db = write_test_layout(root, n_frames=TEST_CLI_FRAMES, size=512)
    ckpt = os.path.join(root, "no_checkpoints")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        argv = test_cli_argv(db, ckpt, os.path.join(root, "results"),
                             dev.type)
        zero_counters()
        t0 = time.perf_counter()
        res = test_cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counters()
        args = test_cli.build_test_argparser().parse_args(argv)
        lists = test_cli.resolve_lists(db, "test", float("inf"))
        photo, a68, tb68, _, names = test_cli.load_group(
            args, lists[0][0], lists[1][:TEST_CLI_FRAMES])
    finally:
        os.chdir(cwd)
    files = sorted(os.listdir(res.image_dir))
    want = sorted(f"{n}_{label}.png" for n in names
                  for label in test_cli.LABELS)
    if files != want or not os.path.exists(res.index):
        raise AssertionError(f"test_cli wrote {len(files)} images (expected "
                             f"{len(want)}) and index {res.index}")
    say(f"[12] test_cli.main (the reference command, ngf 64, crop 256, frame "
        f"batch 8): {TEST_CLI_FRAMES} frames x 9 visuals and "
        f"{os.path.basename(res.index)} in {wall:.3f} s of wall time with the "
        f"nets' random init; render_visuals {res.render_seconds:.3f} s in the "
        f"run (first calls included); launches {launches}")
    if launches["instance_norm"] <= 0:
        raise AssertionError(f"K2 never launched in test_cli: {launches}")

    # render_visuals beside __call__ on the same inputs, warm
    renderer = test_cli.build_renderer(args, dev)
    nets = {"generator": renderer.g, "modnet": renderer.modnet,
            "static_g": renderer.static_net}
    kept, hooks = keep_instance_norm_inputs(nets)
    with torch.inference_mode():
        renderer.render_visuals(photo, a68, tb68[:8])
        for h in hooks:
            h.remove()
        renderer(photo, a68, tb68)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        renderer.render_visuals(photo, a68, tb68)
        torch.cuda.synchronize()
        t_vis = time.perf_counter() - t0
        t0 = time.perf_counter()
        renderer(photo, a68, tb68)
        torch.cuda.synchronize()
        t_call = time.perf_counter() - t0
    k2_err = k2_on_path(kept, "12")
    say(f"[12] same {TEST_CLI_FRAMES} frames, warm: render_visuals "
        f"{TEST_CLI_FRAMES / t_vis:.2f} frames/s, __call__ "
        f"{TEST_CLI_FRAMES / t_call:.2f} frames/s (smoke figures)")

    # card against host on 2 frames (the host renders a batch of 2)
    host_r = test_cli.build_renderer(
        test_cli.build_test_argparser().parse_args(
            argv + ["--frame_batch", "2"]), torch.device("cpu"))
    with torch.inference_mode():
        card = renderer.render_visuals(photo, a68, tb68[:2])
        host = host_r.render_visuals(photo, a68, tb68[:2])
    p = {k: psnr(card[k], host[k], peak=2.0) for k in sorted(card)
         if k not in ("warp_motion", "iw_flow")}
    grid = max(float(np.abs(card[k] - host[k]).max())
               for k in ("warp_motion", "iw_flow"))
    drawn_ok = all(
        np.array_equal(read_image(os.path.join(
            res.image_dir, f"{names[t]}_{label}.png"))[:, :, ::-1],
            test_cli.tensor2im(draw_landmarks(256, 256, lm, 3, 2, op=0)))
        for t in range(2) for label, lm in (("real_A_lm", a68),
                                            ("target_B_lm", tb68[t])))
    say("[12] card vs host, 2 frames of render_visuals: PSNR "
        + ", ".join(f"{k} {v:.2f}" for k, v in p.items())
        + f" dB (>= {VISUALS_MIN_PSNR}); warp grid and flow max|diff| "
        f"{grid:.3e}; the card run's landmark drawings equal the host's: "
        f"{drawn_ok}")
    if min(p.values()) < VISUALS_MIN_PSNR or not drawn_ok:
        raise AssertionError(f"test_cli card vs host: {p}, drawings "
                             f"{drawn_ok}")
    del renderer, host_r
    return {"launches": launches, "wall_s": wall,
            "visuals_fps": TEST_CLI_FRAMES / t_vis,
            "call_fps": TEST_CLI_FRAMES / t_call, "psnr": p,
            "k2_path_err": k2_err}


class _PhotoRecorder:
    """A pipeline that records the photo of each call."""

    def __init__(self, pipe, seen: list):
        self.pipe, self.seen = pipe, seen

    def __getattr__(self, name):
        return getattr(self.pipe, name)

    def __call__(self, img, *args, **kwargs):
        self.seen.append(np.array(img))
        return self.pipe(img, *args, **kwargs)


def phase12_video(dev: torch.device, main_run: dict, tmp: str) -> dict:
    """``cli.main --video`` on an AVI of phase 3's frames with its 6 s WAV
    as a 16 kHz PCM track, once with ``--audio`` (launch counters zeroed
    just before) and once from the track."""
    from animateportrait_tpu_torch import cli
    from animateportrait_tpu_torch.utils import jpeg
    from animateportrait_tpu_torch.utils.smoke import (
        make_wav, write_mtcnn_weights)
    from animateportrait_tpu_torch.utils.video import (
        mux_avi, read_avi, read_pcm_track, write_wav)

    frames = np.repeat(main_run["frames"], 3, axis=-1)
    wav = make_wav(6.0, seed=2)
    d = os.path.join(tmp, "video")
    os.makedirs(d)
    avi = mux_avi(os.path.join(d, "clip.avi"), frames, wav)
    wav_path = write_wav(os.path.join(d, "speech.wav"), wav)
    ckpt = os.path.join(d, "ckpt")
    write_mtcnn_weights(os.path.join(ckpt, "mtcnn"), seed=0)
    want_photo = jpeg.decode_jpeg(jpeg.encode_jpeg(frames[0][:, :, ::-1]))
    seen: list = []
    build = cli.build_pipeline
    cli.build_pipeline = lambda a: _PhotoRecorder(build(a), seen)
    try:
        runs = {}
        for key, extra in (("audio", ["--audio", wav_path]), ("track", [])):
            argv = ["--video", avi, *extra, "--device", dev.type,
                    "--frame_batch", "8", "--ckpt_dir", ckpt, "--output",
                    os.path.join(d, key)]
            zero_counters()
            t0 = time.perf_counter()
            res = cli.main(argv)
            torch.cuda.synchronize()
            runs[key] = (res, time.perf_counter() - t0, read_counters())
    finally:
        cli.build_pipeline = build
    (ra, wall_a, launches), (rt, wall_t, lt) = runs["audio"], runs["track"]
    photos_ok = len(seen) == 2 and all(np.array_equal(p, want_photo)
                                       for p in seen)
    track = read_avi(rt.path)["pcm"]
    want_pcm = (read_pcm_track(avi) * 32768.0).astype(np.int16)
    names_ok = (ra.path.endswith("/frame-speech/output_formal_drawing.avi")
                and rt.path.endswith("/frame-audio/output_formal_drawing.avi"))
    for key, (res, wall, n) in runs.items():
        piped = sum(res.stage_seconds.values())
        what = "--audio" if key == "audio" else "the clip's PCM track"
        say(f"[12] cli.main --video ({what}): {res.frames} frames, pipeline + mux "
            f"{piped:.3f} s = {res.frames / piped:.2f} frames/s, wall "
            f"{wall:.3f} s; {os.path.relpath(res.path, d)}; launches {n}")
    say(f"[12] --video photo = decode_jpeg(encode_jpeg(first frame)) in both "
        f"runs: {photos_ok}; the track run's PCM is the clip's track: "
        f"{track == want_pcm[:len(track) // 2].tobytes()}")
    if not (photos_ok and names_ok and launches["stft_magnitude"] == 1
            and launches["instance_norm"] > 0 and lt["stft_magnitude"] == 1
            and track == want_pcm[:len(track) // 2].tobytes()):
        raise AssertionError(f"--video: photos {photos_ok}, names {names_ok}"
                             f", launches {launches} / {lt}")
    return {"launches": launches, "frames_per_s": ra.frames / sum(
        ra.stage_seconds.values())}


def phase12_encoder() -> dict:
    """The quality-95 encoder on the committed fixtures: the file's and the
    round trip's SHA-256 against OpenCV's (``jpeg_fixtures.json``), host
    ms per 512^2 image, median of 5."""
    import hashlib

    from animateportrait_tpu_torch.utils import jpeg
    from animateportrait_tpu_torch.utils.assets import ASSET_DIR
    from animateportrait_tpu_torch.utils.image import read_image

    with open(os.path.join(ASSET_DIR, "jpeg_fixtures.json")) as f:
        table = json.load(f)
    ms = {}
    for name in JPEG_FIXTURES:
        img = read_image(os.path.join(ASSET_DIR, name))
        enc, dec = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            data = jpeg.encode_jpeg(img)
            t1 = time.perf_counter()
            px = jpeg.decode_jpeg(data)
            enc.append(t1 - t0)
            dec.append(time.perf_counter() - t1)
        got = ({"sha256": hashlib.sha256(data).hexdigest(),
                "size": len(data)},
               {"sha256": hashlib.sha256(np.ascontiguousarray(px).tobytes())
                .hexdigest(), "shape": list(px.shape)})
        if got != (table[name]["cv2_q95_file"], table[name]["cv2_q95"]):
            raise AssertionError(f"encode_jpeg({name}): {got}, OpenCV gave "
                                 f"{table[name]['cv2_q95_file']}, "
                                 f"{table[name]['cv2_q95']}")
        ms[name] = (float(np.median(enc) * 1e3), float(np.median(dec) * 1e3))
    say("[12] encode_jpeg (quality 95) on the fixtures: the file and its "
        "decode have OpenCV's SHA-256; host ms per 512^2 image, median of "
        "5, encode / decode: " + ", ".join(
            f"{k} {e:.1f} / {d:.1f}" for k, (e, d) in ms.items()))
    return ms


def phase12_front_end(dev: torch.device, tmp: str) -> dict:
    """``detect_faces_batch`` of 4 photos against 4 single calls and
    ``BatchedLandmarkPredictor`` of 3 audios (two of one length) against
    the single predictor, with the device time of each (synchronized,
    warm, median of 5)."""
    from animateportrait_tpu_torch.models import mtcnn
    from animateportrait_tpu_torch.pipeline.batch import (
        BatchedLandmarkPredictor, detect_faces_batch)
    from animateportrait_tpu_torch.pipeline.landmark import LandmarkPredictor
    from animateportrait_tpu_torch.utils.assets import std_face_landmarks
    from animateportrait_tpu_torch.utils.image import read_image
    from animateportrait_tpu_torch.utils.smoke import (
        full_width_nets, write_mtcnn_weights)

    def median_s(fn):
        fn()
        out = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return float(np.median(out))

    d = write_mtcnn_weights(os.path.join(tmp, "mtcnn_fe"), seed=0)
    det = mtcnn.MTCNNDetector(*(getattr(mtcnn, f"load_{n}")(
        os.path.join(d, f"{n}.npy")) for n in ("pnet", "rnet", "onet")),
        device=dev)
    img = read_image(write_photo(os.path.join(tmp, "fe.ppm")))[:, :, ::-1]
    photos = np.stack([img, img[:, ::-1], img[::-1], np.roll(img, 37, 1)]
                      ).astype(np.float32)
    batch = detect_faces_batch(det, photos)
    single = [det(p) for p in photos]
    counts_ok = all(len(b[0]) == len(s[0]) for b, s in zip(batch, single))
    box_err = max((float(np.abs(b[0] - s[0])[:, :4].max()) if len(s[0])
                   else 0.0) for b, s in zip(batch, single))
    score_err = max((float(np.abs(b[0] - s[0])[:, 4].max()) if len(s[0])
                     else 0.0) for b, s in zip(batch, single))
    pts_err = max((float(np.abs(b[1] - s[1]).max()) if len(s[1])
                   else 0.0) for b, s in zip(batch, single))
    exact = all(np.array_equal(b[0], s[0]) and np.array_equal(b[1], s[1])
                for b, s in zip(batch, single))
    t_batch = median_s(lambda: detect_faces_batch(det, photos))
    t_single = median_s(lambda: [det(p) for p in photos])
    say(f"[12] detect_faces_batch of 4 512^2 photos: faces "
        f"{[len(b[0]) for b in batch]} (single calls "
        f"{[len(s[0]) for s in single]}), max|diff| boxes {box_err:.3e} "
        f"px, five points {pts_err:.3e} px, scores {score_err:.3e} (each <= "
        f"{DETECT_BATCH_ATOL}), bit-equal {exact}; {t_batch * 1e3:.2f} ms "
        f"batched, {t_single * 1e3:.2f} ms for 4 single calls "
        f"({t_single / t_batch:.2f}x)")
    if not (counts_ok and max(box_err, pts_err, score_err) <= DETECT_BATCH_ATOL
            and sum(len(b[0]) for b in batch)):
        raise AssertionError(f"detect_faces_batch against single calls: "
                             f"counts {counts_ok}, boxes {box_err}, five "
                             f"points {pts_err}, scores {score_err}")

    nets = full_width_nets(seed=0)
    pred = LandmarkPredictor(nets["pos"], nets["content"], device=dev)
    rng = np.random.default_rng(8)
    wins = [rng.standard_normal((T, 18, 80)).astype(np.float32)
            for T in (358, 358, 250)]
    embs = [rng.standard_normal(256).astype(np.float32) for _ in wins]
    fid = (std_face_landmarks().reshape(1, 204) * 0.1).astype(np.float32)
    fids = [fid + rng.normal(0, 0.01, (1, 204)).astype(np.float32)
            for _ in wins]
    bpred = BatchedLandmarkPredictor(pred)
    with torch.inference_mode():
        got = bpred(wins, embs, fids)
        want = [pred(w, e, f) for w, e, f in zip(wins, embs, fids)]
        lm_err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
        tb = median_s(lambda: bpred(wins, embs, fids))
        ts = median_s(lambda: [pred(w, e, f) for w, e, f in zip(wins, embs,
                                                                fids)])
    say(f"[12] BatchedLandmarkPredictor of 3 audios (358, 358, 250 windows) "
        f"against the single predictor: max|diff| {lm_err:.3e} (<= "
        f"{LANDMARK_BATCH_ATOL}); {tb * 1e3:.2f} ms batched, {ts * 1e3:.2f} "
        f"ms single ({ts / tb:.2f}x)")
    if not lm_err <= LANDMARK_BATCH_ATOL:
        raise AssertionError(f"batched landmarks differ: {lm_err}")
    return {"detect_ms": (t_batch * 1e3, t_single * 1e3),
            "landmarks_ms": (tb * 1e3, ts * 1e3), "box_err": box_err,
            "pts_err": pts_err, "score_err": score_err,
            "lm_err": lm_err}


def phase12_p2c_full(dev: torch.device) -> dict:
    """Photo2Cartoon ``light=False`` at ngf 32 (a 524 288 -> 128 ``FC.0``)
    with seeded random weights: card against host on one 256^2 photo, K2
    against its plain version on its InstanceNorm inputs, ms per photo on
    the card (warm, median of 5), beside the light head's in turn."""
    from animateportrait_tpu_torch.models.photo2cartoon import (
        Photo2CartoonGenerator)
    from animateportrait_tpu_torch.utils.smoke import init_random_

    light = init_random_(Photo2CartoonGenerator(ngf=32),
                         torch.Generator().manual_seed(0)).eval().to(dev)
    net = init_random_(Photo2CartoonGenerator(ngf=32, light=False),
                       torch.Generator().manual_seed(0)).eval()
    x = torch.as_tensor(np.random.default_rng(9).uniform(
        -1, 1, (1, 3, 256, 256)).astype(np.float32))
    with torch.inference_mode():
        host = net(x)[0].numpy()
    net = net.to(dev)
    xd = x.to(dev)
    kept, hooks = keep_instance_norm_inputs({"photo2cartoon": net})
    with torch.inference_mode():
        card = net(xd)[0].cpu().numpy()
        for h in hooks:
            h.remove()
        ms, light_ms = [], []
        for _ in range(5):
            for gen, out in ((net, ms), (light, light_ms)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                gen(xd)
                torch.cuda.synchronize()
                out.append(time.perf_counter() - t0)
    k2_err = k2_on_path(kept, "12")
    p = psnr(card, host, peak=2.0)
    ms, light_ms = (float(np.median(t) * 1e3) for t in (ms, light_ms))
    say(f"[12] Photo2Cartoon light=False ngf 32 (FC.0 "
        f"{tuple(net.FC[0].weight.shape)}): card vs host PSNR {p:.2f} dB "
        f"(>= {P2C_FULL_MIN_PSNR}), max|diff| "
        f"{float(np.abs(card - host).max()):.3e}; {ms:.2f} ms per photo on "
        f"the card, the light head's {light_ms:.2f} ms in turn with it")
    if not p >= P2C_FULL_MIN_PSNR:
        raise AssertionError(f"Photo2Cartoon light=False card vs host {p}")
    del net, light
    torch.cuda.empty_cache()
    return {"psnr": p, "ms": ms, "light_ms": light_ms, "k2_path_err": k2_err}


def phase12(dev: torch.device, main_run: dict) -> dict:
    """The rest of the inference surface: test_cli, --video, the encoder,
    the batched front end and Photo2Cartoon light=False."""
    with tempfile.TemporaryDirectory() as tmp:
        out = {"test_cli": phase12_test_cli(dev, tmp),
               "video": phase12_video(dev, main_run, tmp),
               "encoder_ms": phase12_encoder(),
               "front_end": phase12_front_end(dev, tmp),
               "p2c_full": phase12_p2c_full(dev)}
    return out


def child_processes() -> list[str]:
    """The processes whose parent is this one, as "pid command"."""
    out = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:       # it exited while we looked
            continue
        # the parent is the second field after the command in parentheses
        if int(stat.rsplit(")", 1)[1].split()[1]) == os.getpid():
            out.append(f"{pid} {cmd.strip()[:120]}")
    return out


def stop_processes() -> None:
    """Stop the trainer's loader servers (its workers stopped with each
    ``train_cli.main``), then fail if any process this one started is
    still running."""
    from animateportrait_tpu_torch.data.umlvd_ifw import stop_worker_servers

    stop_worker_servers()
    left = child_processes()
    if left:
        raise AssertionError(f"processes still running: {left}")
    say("[done] no process started by this run is still running")


def main() -> None:
    phase0()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    phase1()
    rec = phase2(dev)
    from animateportrait_tpu_torch.utils.smoke import full_width_nets

    nets = full_width_nets(seed=0)
    main_run = phase3(dev, nets)
    rec["instance_norm"]["max_abs_err"] = max(
        rec["instance_norm"]["max_abs_err"], main_run["k2_path_err"])
    phase4(dev, nets, main_run)
    del nets
    cli_run = phase5(dev, main_run["landmarks"])
    rec["instance_norm"]["max_abs_err"] = max(
        rec["instance_norm"]["max_abs_err"], cli_run["k2_path_err"])
    phase6(dev, main_run["landmarks"])
    train = phase7(dev)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = phase8(dev, tmp)
        render_bf16 = phase9(dev, main_run)
        train_bf16 = phase10(dev, trainer)
        user_photo = phase11(dev, main_run, trainer)
    surface = phase12(dev, main_run)
    rec["instance_norm"]["max_abs_err"] = max(
        rec["instance_norm"]["max_abs_err"],
        surface["test_cli"]["k2_path_err"],
        surface["p2c_full"]["k2_path_err"])
    stop_processes()
    say(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    src = "animateportrait_tpu_torch/csrc/"
    sources = {"stft_magnitude": (src + "stft.cu", K1_REPLACES),
               "instance_norm": (src + "instnorm.cu", K2_REPLACES),
               "instance_norm_backward": (src + "instnorm_bwd.cu",
                                          K2B_REPLACES),
               "instance_norm_bf16": (src + "instnorm.cu", K2_REPLACES),
               "instance_norm_backward_bf16": (src + "instnorm_bwd.cu",
                                               K2B_REPLACES)}
    for name, run in (("instance_norm_backward", train),
                      ("instance_norm_backward_bf16", train_bf16)):
        # K2b's headline numbers: the shape that moves the most bytes in a
        # step
        head = max(run["rows"], key=lambda r: r["k2b_launches"]
                   * np.prod(r["shape"]))
        rec[name] = dict(
            head["k2b"], max_abs_err=max(rec.get(name, {}).get(
                "max_abs_err", 0.0), run["worst"]["k2b_abs"]),
            shape=head["shape"],
            launches_per_step=run["per_step"][name],
            path_err=run["worst"],
            by_shape=[dict(r["k2b"], shape=r["shape"], cluster=r["k2b_ctas"],
                           launches_per_step=r["k2b_launches"])
                      for r in run["rows"]])
    for name, run in (("instance_norm", train),
                      ("instance_norm_bf16", train_bf16)):
        rec[name]["train_by_shape"] = [
            dict(r["k2"], shape=r["shape"], cluster=r["k2_ctas"],
                 launches_per_step=r["k2_launches"]) for r in run["rows"]]
    rec["instance_norm"]["ms_by_path"] = {
        "cartoon_cli": cli_run["k2_time"],
        "drawing_pipeline": main_run["k2_time"]}
    # per photo: the fp32 K2 of MODNet and the static net, and K2-bf16 of
    # encode_static; per batch: K2-bf16 alone
    rec["instance_norm_bf16"]["ms_by_path"] = {
        "drawing_pipeline_bf16": render_bf16["k2_time"]}
    rec["instance_norm_bf16"]["max_abs_err"] = max(
        rec["instance_norm_bf16"]["max_abs_err"], render_bf16["k2_path_err"],
        train_bf16["fwd_err"])
    for name, run, key in (("instance_norm", train, "k2"),
                           ("instance_norm_backward", train, "k2b"),
                           ("instance_norm_bf16", train_bf16, "k2"),
                           ("instance_norm_backward_bf16", train_bf16,
                            "k2b")):
        path = "train_step_bf16" if name.endswith("bf16") else "train_step"
        rec[name]["ms_by_path"] = dict(
            rec[name].get("ms_by_path", {}), **{path: dict(
                launches_per_step=run["per_step"][name],
                profiled_ms=run["profiled"][key],
                device_ms=run["profiled"]["all"],
                estimated_ms=run["estimated"][key])})
    launches = {
        "cartoon_cli": cli_run["launches"], "drawing_pipeline":
        main_run["launches"], "train_step": train["launches"],
        "train_cli": trainer["launches"],
        "cartoon_cli_bf16": render_bf16["cli_launches"],
        "drawing_pipeline_bf16": render_bf16["launches"],
        "train_step_bf16": train_bf16["launches"],
        "train_cli_bf16": train_bf16["cli_launches"],
        "user_photo_cli": user_photo["launches"],
        "train_cli_jpeg": user_photo["train_launches"],
        "test_cli": surface["test_cli"]["launches"],
        "video_cli": surface["video"]["launches"]}
    # "launches": K1's, K2's and K2-bf16's on the user's entry point (the
    # cartoon CLI runs of phases 5 and 9), K2b's and K2b-bf16's in the timed
    # training steps (phases 7 and 10); "launches_by_path" has every path's
    main_path = {"stft_magnitude": "cartoon_cli",
                 "instance_norm": "cartoon_cli",
                 "instance_norm_backward": "train_step",
                 "instance_norm_bf16": "cartoon_cli_bf16",
                 "instance_norm_backward_bf16": "train_step_bf16"}
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src_path,
         "replaces": repl,
         "launches": launches[main_path[name]][name],
         "launches_by_path": {path: n.get(name, 0)
                              for path, n in launches.items()},
         **rec[name]}
        for name, (src_path, repl) in sources.items()]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
