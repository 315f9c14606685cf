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
     counters read over the eager warm step, timed steps (steps/s, a smoke
     figure, and the step's peak memory), K2's and K2b's device time and
     kernel count in a profiled step (the timed and profiled steps replay
     the step's CUDA graph, in which no wrapper runs, so the trace counts
     them), and card against host ``grads`` at the JAX tests' small
     configuration;
  8. the trainer as users run it: ``train_cli.main`` with the readme's
     drawing command (crop 256, load 286, ngf = ndf = 64, batch 4,
     ``--num_threads 8`` worker processes, 8 steps) over a seeded synthetic
     UMLVD-IFW tree of 16 photos and 16 drawings at 512^2 and two 8-frame
     clips, every PNG row Paeth-filtered (the costliest to decode). Steps/s
     over steps 3-8 with the data loading, the data-wait share, peak
     memory, K2's and K2b's launches (counters zeroed just before; a
     replay of the step's CUDA graph counts none), and the
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
 13. the Module1-side trainers (``utils/smoke.py:trainer_smoke``): the
     content and speaker-aware steps over all 341 windows of a 358-frame
     clip, flow regression (num_scale 4, 224^2, batch 4), image
     translation (ngf 64, num_downs 6, 256^2, VGG19, batch 4) and pose
     transfer (the config's dual_unet with D at 256^2, batch 4), each a
     warm step and 5 timed steps (steps/s and peak memory beside the
     card's name and power limit; the launch counters zeroed before and 0
     after: none of these paths reaches a kernel of the port); card
     against host on one step of each at a small width (losses within
     rtol 1e-4, gradient leaves within 1e-3 of their scale, or, where
     fp32 cannot give that, no farther from a float64 host run than the
     host's own fp32 step).
 14. the landmark-detector trainers, the network registry and LPIPS: the
     FAN/AWing step (4 stacks, 98 points, 256^2, batch 4) and the
     face_of_art step (256^2, batch 4) timed and held card against host
     as phase 13 does; ``train_foa`` for 8 steps over a seeded ibug-style
     tree (PNG and JPEG photos with ``.pts``, augmentation on, p_geom
     0.5), the host data layer's share of the run, and
     ``predict_artistic_landmarks`` with ``train_pdm`` PDMs (ms a photo);
     every ``define_g`` / ``define_d`` name at ngf 64, 256^2 (the class
     discriminator at 512^2, the Regressor at arch 2 on 11^2 patches),
     batch 4: a forward and backward with the counters zeroed before it
     (K2 and K2b must both launch; counts per name), K2 against its plain
     version and K2 + K2b against float64 on the first InstanceNorm input
     of each shape (unet_256's 2x2 planes included); card against host on
     every name at a small width (outputs within 1e-4 of their scale, the
     loss within rtol 1e-4, ``grad_parity`` with a float64 host run);
     LPIPS (vgg, alex, squeeze; plain and spatial) on two batches of
     phase 3's frames, ms a pair, card against host; and
     ``train.convergence`` for 20 steps over all seven runs, every metric
     falling, with no kernel launched.
 15. the last modules and the training-data tools: ``postalign_video`` on
     phase 3's frames (frames/s; card against host: tracked points within
     1e-3 px, uint8 frames within one level on at most 0.1% of the
     values) and on a drifting clip (stabilized); ``read_video_frames`` on
     the committed Motion-JPEG fixture (each frame byte-equal to the
     SHA-256 of OpenCV's decode), then ``Av2FlauConverter`` with FAN3D +
     depth (seeded, full width) and ``AudioPipeline`` (K1 once), card
     against host on the raw and registered rows; the fakeB_static builder
     over phase 8's 16 photos, drawing and cartoon, full width (ms a
     photo, K2 launches a photo, K2 against its plain version on the
     static nets' InstanceNorm inputs, card against host PSNR >= 40 dB);
     ``get_data`` staging a tar of phase 8's tree (layout valid, a
     traversal member refused) and ``get_puppet_info``; the stand-in
     frozen nets for 100 + 100 steps, then the GAN convergence run at crop
     256, ngf 64 with them, 40 steps resumed to 60 (losses finite, the
     loss log continuous across the resume, K2 and K2b launched); and the
     card's fp32 FAN gradients against a float64 host step with cuDNN's
     default and deterministic algorithms and with cuDNN off, with the
     ReLU inputs on the other side of the kink from float64.
 16. the multi-card paths on this one card (``utils/distributed.py``):
     (a) phase 7's step on a global batch of 4 over 2 ranks (gloo, both
     on this card) for 2 steps against the single-process step on the
     same batch: the losses, the pool after each step, the first step's
     gradients (``grad_parity``) and Adam's updates
     (``adam_update_parity``), each within the larger of its bar and 3x
     the wider of the one process's own spreads (called again; with
     cuDNN's deterministic algorithms), and rank 0's half-batch
     gradients (the all-reduce left out) beyond the gradient bar; the
     ranks' G bit-equal; K2 and K2b launched on each rank, K2 against its
     plain version on each rank's InstanceNorm inputs, ms a step and the
     bytes a step all-reduces; (b)
     ``train_cli.main --multihost 1 --num_processes 1`` (NCCL) over phase
     8's tree for 2 steps: one loss log, one checkpoint tree; (c)
     ``cli.main --render_dp``: one replica on one card (the launches of
     the run without it), frames bit-equal to that run's and to a second
     run without it under cuDNN's deterministic algorithms; a renderer with two replicas on this card
     on phase 3's inputs >= 40 dB from phase 3's frames (frames/s, K2
     against its plain version on the second replica's inputs); (d)
     ``parallel.gpipe_apply`` of the generator's 9-block bottleneck (256
     channels at 64^2, batch 6) over 3 ranks (gloo) at M = 3 and 6
     against the blocks in sequence on the same microbatches (rtol =
     atol = 2e-5), K2's launches per rank.
 17. the multi-card paths one rank a card, over NCCL, on n = min(4,
     cards) cards (an even n, for the TP grid); (a), (b), (e), (f) and
     (g) run in one spawn of the n ranks: (a) phase 7's step at global
     batch 4 against one process running the ranks' step (each rank's
     slice alone, at its batch: ``utils/smoke.py:decomposed_grads``) at
     phase 16 (a)'s rule, 3x that process's own spread, the pool after
     both steps too; the fault, rank 0's slice alone, beyond each
     gradient bar; (b) the same step with the state
     FSDP-sharded (``train/fsdp.py``) against (a)'s ranks, with each
     rank's parameter + moment bytes and peak memory beside DP's; the
     ranks' parameters bit-equal after both steps, K2 and K2b launched and
     K2 against its plain version on every rank; (c) ``train_cli.main
     --data_parallel n`` and ``--multihost`` as n processes
     (``LOCAL_RANK``), 2 steps, each step's losses against one process
     running the ranks' step on the same global batches within 3x that
     process's own spread, and the first rank's share alone beyond it;
     (d) ``cli.main --render_dp`` with
     a replica a card, 8 frames a replica, bit-equal to phase 16's
     one-card frames under cuDNN's deterministic algorithms, frames/s of
     the render stage; (e) GPipe of the 9-block bottleneck, 3 stages on 3
     cards, bit-equal to the blocks in sequence; (f) ``parallel.
     tensor_parallel_generator`` of the full-width generator (ngf 64, 8
     frames at 256^2) on a (n/2, 2) grid against one card within 1e-4;
     (g) ``parallel.sequence_parallel_pos`` of the full-width pos branch
     at T = 512, its attention outputs scaled by ``multichip.ATTN_GAIN``,
     against one card within 1e-4, and the first rank's frames as a
     sequence of their own beyond it; (h) ``multichip.
     dryrun_multichip(n)``. Every part runs; the phase fails after them
     if any failed. On one card it runs ``dryrun_multichip(2)`` over gloo
     ranks that share the card, and says that (a)-(g) need two or more
     cards.
 18. the last functions of the JAX package: (a) ``entry()`` (the trident
     generator at full width, 256^2) on the card against the host (PSNR
     >= 40 dB), K2's launches a forward, K2 against its plain version on
     the forward's InstanceNorm inputs, ms a forward; (b) Module1's three
     discriminators at the reference's widths, forward and backward, card
     against host (outputs within 1e-4 of their scale, gradients by
     ``grad_parity`` with a float64 host run); (c) ``mel_spectrogram`` on
     phase 3's 6 s WAV through K1, against its plain version on the card
     and against the host; (d) a ``write_video`` round trip of phase 3's
     first frames; (e) ``profile_trace`` around one renderer batch: the
     trace names K2's kernel, an event a launch. Every part runs; the
     phase fails after them if any failed.
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

``python3 chip_smoke.py --multi-card`` runs phases 0 and 1, the parts of
phase 16 that phase 17 reads, and phase 17 alone, and prints no result
line: on several cards, the multi-card paths at about half the whole
run's time.
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
        timeout=60, check=True).stdout.strip().splitlines()
    for i, line in enumerate(smi[1:], 1):
        say(f"[0] card {i}: {line}")
    smi = smi[0]
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


def k2_on_path(kept: dict, tag: str, by_shape_lines: bool = True) -> float:
    """K2 against its plain version on the activations a path fed each
    InstanceNorm; returns the largest |kernel - plain|. The bar is K2_ATOL
    on fp32 activations, one bf16 ulp at each element (``bf16_ulps``) on
    bf16 ones (K2-bf16). ``by_shape_lines`` prints a line per shape before
    the summary."""
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
            by_shape.items(), key=str) if by_shape_lines else ():
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


def k2_gradient_on_path(kept: dict, tag: str = "7",
                        by_shape_lines: bool = True) -> dict:
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
    for (shape, relu), e in sorted(by_shape.items()) if by_shape_lines \
            else ():
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
    ``torch.profiler`` trace (0 where CUPTI gives no device time), the
    number of K2 and K2b kernels the trace holds (a CUDA graph's replay
    included, which no launch counter sees), and the ``top`` kernels by
    device time. The port's spans also show on the device's timeline, as
    annotations: they are not kernels and are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {"k2": 0.0, "k2b": 0.0, "all": 0.0, "k2_calls": 0, "k2b_calls": 0}
    kernels = []
    for e in prof.key_averages():
        if (e.device_type != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        ms = float(getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0))) / 1e3
        out["all"] += ms
        kernels.append((ms, e.count, e.key))
        if "instance_norm_bwd" in e.key:
            out["k2b"] += ms
            out["k2b_calls"] += e.count
        elif "instance_norm" in e.key:
            out["k2"] += ms
            out["k2_calls"] += e.count
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
    instance_norm.launches = 0
    instance_norm_backward.launches = 0
    t0 = time.perf_counter()
    step.step(state, batch, frozen, pool_gen)
    torch.cuda.synchronize()
    say(f"[7] warm step {time.perf_counter() - t0:.3f} s (keeps the "
        f"InstanceNorm inputs)")
    # the warm step runs eagerly, and its wrappers count each launch; the
    # timed and the profiled steps replay the step's CUDA graph (the first
    # timed step captures it), in which no wrapper runs: their kernels are
    # counted in the profiled step's trace
    warm = {"instance_norm": instance_norm.launches,
            "instance_norm_backward": instance_norm_backward.launches}
    for h in hooks + count_hooks:
        h.remove()
    worst = k2_gradient_on_path(kept)
    del kept
    rows = time_training_shapes(dev, counts)

    g0 = next(state.g.parameters()).detach().clone()
    d0 = next(state.d.parameters()).detach().clone()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        metrics = step.step(state, batch, frozen, pool_gen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    prof = profiled_ms(lambda: step.step(state, batch, frozen, pool_gen))
    losses = {k: float(v) for k, v in metrics.items()}
    launches = per_step = {"instance_norm": prof["k2_calls"],
                           "instance_norm_backward": prof["k2b_calls"]}
    say(f"[7] timed: {TRAIN_STEPS} steps in {dt:.3f} s = "
        f"{TRAIN_STEPS / dt:.3f} steps/s (batch {TRAIN_BATCH}, smoke "
        f"figure, not a benchmark; one CUDA graph, captured in the first "
        f"timed step); peak memory {peak / 2 ** 30:.2f} GiB")
    say(f"[7] kernel launches: {warm} counted in the eager warm step, "
        f"{launches} in the trace of a replayed step")
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
    want = {"instance_norm": n_fwd, "instance_norm_backward": n_bwd}
    if warm != want or per_step != want:
        raise AssertionError(f"launches in the warm step {warm}, in a "
                             f"replayed step {per_step}, InstanceNorm "
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
    est = per_step_estimates(rows)
    say(f"[7] launches x per-shape time per step: K2 {est['k2']:.3f} ms, "
        f"K2b {est['k2b']:.3f} ms; launches x per-shape bound: K2 "
        f"{est['k2_bound']:.3f} ms ({100 * est['k2_bound'] / est['k2']:.0f}"
        f"% of its time), K2b {est['k2b_bound']:.3f} ms "
        f"({100 * est['k2b_bound'] / est['k2b']:.0f}%)")
    del state, frozen, batch
    torch.cuda.empty_cache()
    card_vs_host_grads(dev)
    return {"launches": launches, "per_step": per_step, "rows": rows,
            "worst": worst, "profiled": prof, "estimated": est,
            "steps_per_s": TRAIN_STEPS / dt, "peak_bytes": peak}


def per_step_estimates(rows: list) -> dict[str, float]:
    """K2's and K2b's ms per step from ``time_training_shapes``' rows:
    launches x each shape's time, and the step's least time, launches x
    each shape's bound (``k2_work`` with statistics, ``k2b_work``)."""
    return {f"{k}{tag}": sum(r[f"{k}_launches"] * r[k][field] for r in rows)
            for k in ("k2", "k2b")
            for tag, field in (("", "ms"), ("_bound", "bound_ms"))}


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
    from animateportrait_tpu_torch.nn import InstanceNorm2d
    from animateportrait_tpu_torch.utils.smoke import cancelled_biases

    worst = {}
    for net in ("g", "d"):
        ref = getattr(plain, net)
        cancelled = cancelled_biases(getattr(state, net),
                                     norms=(InstanceNorm2d,))
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
            os.path.join(tmp, "frozen"), "--device", "cuda",
            # one process on one card (the flag's default 0 takes every
            # visible card)
            "--data_parallel", "1"]
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
    est = per_step_estimates(rows)
    say(f"[10] launches x per-shape time per step: K2-bf16 {est['k2']:.3f} "
        f"ms, K2b-bf16 {est['k2b']:.3f} ms; launches x per-shape bound: "
        f"K2-bf16 {est['k2_bound']:.3f} ms "
        f"({100 * est['k2_bound'] / est['k2']:.0f}% of its time), "
        f"K2b-bf16 {est['k2b_bound']:.3f} ms "
        f"({100 * est['k2b_bound'] / est['k2b']:.0f}%)")
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


# phase 13: the Module1-side trainers (utils/smoke.py:trainer_smoke): timed
# steps at full width, then card against host at the small widths
M1_MIN_STEPS = 5          # at least this many timed steps per trainer
M1_WINDOW_S = 1.5         # over at least this long a window
M1_CONVERGENCE_STEPS = 20


# phase 13's five trainers; phase 14 takes the landmark detectors'
M1_TRAINERS = ("content", "speaker", "flow", "imtrans", "pose")


def phase13_timed(dev: torch.device, card: str, names=M1_TRAINERS,
                  tag: str = "13") -> dict:
    """Each trainer at full width: a warm step, one step timed on the host
    clock to size the window, then n steps back to back between two CUDA
    events, n the larger of ``M1_MIN_STEPS`` and what fills
    ``M1_WINDOW_S``, with the launch counters zeroed before them (no
    kernel of the port lies on these paths, so every counter must stay
    0); then one profiled step for its device time."""
    from animateportrait_tpu_torch.utils.smoke import trainer_smoke

    out = {}
    for name in names:
        s = trainer_smoke(name, dev)
        t0 = time.perf_counter()
        s.step()
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        s.step()
        torch.cuda.synchronize()
        n = max(M1_MIN_STEPS, int(np.ceil(M1_WINDOW_S
                                          / (time.perf_counter() - t0))))
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counters()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(n):
            m = s.run()
        ev[1].record()
        torch.cuda.synchronize()
        ms = ev[0].elapsed_time(ev[1]) / n
        launches = read_counters()
        peak = torch.cuda.max_memory_allocated(dev)
        m = {k: float(v) for k, v in m.items()}
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"[{tag}] {name}: non-finite metrics {m}")
        if any(launches.values()):
            raise AssertionError(f"[{tag}] {name}: kernel launches {launches} "
                                 "on a path that has no kernel of the port")
        prof = profiled_ms(s.run, top=3)
        say(f"[{tag}] {s.what}: warm step {warm:.3f} s, {n} timed steps in "
            f"{n * ms / 1e3:.3f} s (CUDA events): {1e3 / ms:.3f} steps/s "
            f"({ms:.3f} ms/step), device time of a profiled step "
            f"{prof['all']:.3f} ms ({100 * prof['all'] / ms:.1f}% of a "
            f"step), peak memory {peak / 2 ** 30:.2f} GiB on {card}; "
            f"K1/K2/K2b launches {launches}")
        say(f"[{tag}]   metrics after step {s.trainer.steps - 1}: "
            + ", ".join(f"{k} {v:.4f}" for k, v in m.items()))
        say(f"[{tag}]   top kernels: " + "; ".join(
            f"{k['name']} x{k['calls']} {k['ms']:.3f} ms"
            for k in prof["top"]))
        out[name] = {"what": s.what, "steps": n, "steps_per_s": 1e3 / ms,
                     "ms_per_step": ms, "device_ms": prof["all"],
                     "warm_s": warm, "peak_bytes": peak,
                     "launches": launches}
        del s
        torch.cuda.empty_cache()
    return out


class _KinkRecorder:
    """Stands in for a namespace (``torch``, ``torch.nn.functional``) in a
    module: records a float64 host copy of every input of ``fn`` (a
    function with a kink at 0), passes the rest through."""

    def __init__(self, space, fn: str, seen: list):
        self.space, self.fn, self.seen = space, fn, seen

    def __getattr__(self, name):
        attr = getattr(self.space, name)
        if name != self.fn:
            return attr

        def recorded(x, *args, **kwargs):
            self.seen.append(x.detach().to("cpu", torch.float64))
            return attr(x, *args, **kwargs)
        return recorded


# the kinks whose side can decide a small step's fp32 gradients: the
# image-translation ResUnet's ReLUs and the content step's L1 terms
KINKS = {"imtrans": ("animateportrait_tpu_torch.models.image_translation",
                     "F", "relu"),
         "content": ("animateportrait_tpu_torch.train.module1", "torch",
                     "abs")}


def kink_flips(name: str, device, cudnn: bool = True) -> tuple[int, float]:
    """The inputs of ``KINKS[name]`` in one fp32 step of the small trainer
    ``name`` on ``device`` whose sign differs from the float64 host run's:
    their count, and the largest such input's |value| in the float64 run
    as a fraction of its tensor's largest |value|."""
    import importlib

    from animateportrait_tpu_torch.utils.smoke import trainer_smoke

    path, space, fn = KINKS[name]
    module = importlib.import_module(path)

    def inputs(dev, dtype):
        seen, orig = [], getattr(module, space)
        setattr(module, space, _KinkRecorder(orig, fn, seen))
        try:
            trainer_smoke(name, dev, small=True, dtype=dtype).step()
        finally:
            setattr(module, space, orig)
        return seen

    ref = inputs("cpu", torch.float64)
    torch.backends.cudnn.enabled = cudnn
    try:
        got = inputs(device, torch.float32)
    finally:
        torch.backends.cudnn.enabled = True
    n, near = 0, 0.0
    for a, b in zip(ref, got):
        flip = (a > 0) != (b > 0)
        if flip.any():
            n += int(flip.sum())
            near = max(near, float(a[flip].abs().max() / a.abs().max()))
    return n, near


def phase13_parity(dev: torch.device, names=M1_TRAINERS,
                   tag: str = "13") -> dict:
    """One step of each trainer at a small width on the card and on the
    host, from the same weights and batch, through the trainers' own path
    (cuDNN on, its deterministic algorithms):

    - the metrics within rtol 1e-4 (PSNR, of uint8 levels, within 0.01 dB)
      in fp32 and in float64;
    - every gradient leaf of the float64 step within 1e-3 of its scale of
      the host's, with no fallback (``grad_parity`` without a float64
      reference): rounding this small cannot move a kink, so the card's
      code is held to the host's;
    - the fp32 gradients measured and printed, not held: at random
      weights fp32 rounding puts an input within ~1e-5 of its tensor's
      largest |value| from a kink (an L1 term of the content step, a
      ResUnet ReLU of the image-translation step) on either side, and
      one such flip moves most leaves by percent. ``grad_parity``'s fp32 value, the three farthest leaves
      with the host's and the card's distance from float64, and, for those
      two steps, the kink inputs on the other side from float64 on the
      card and on the host (for image translation also with cuDNN off)
      are printed (PERF.md, Findings)."""
    from animateportrait_tpu_torch.utils.smoke import (
        cancelled_biases, grad_parity, trainer_smoke)

    def same_metrics(name, got, want):
        for k, v in want.items():
            bar = 0.01 if k == "PSNR" else 1e-4 * max(abs(v), 1e-30)
            if not abs(got[k] - v) <= bar:
                raise AssertionError(f"[{tag}] {name}: {k} card {got[k]} "
                                     f"host {v}")

    out = {}
    torch.backends.cudnn.deterministic = True
    for name in names:
        card, host, card64, host64 = (
            trainer_smoke(name, d, small=True, dtype=dt)
            for d, dt in ((dev, torch.float32), ("cpu", torch.float32),
                          (dev, torch.float64), ("cpu", torch.float64)))
        mc, mh, mc64, mh64 = (x.step() for x in (card, host, card64, host64))
        same_metrics(name, mc, mh)
        same_metrics(f"{name} (float64)", mc64, mh64)
        noise = {f"{n}.{b}" for n, net in host.nets.items()
                 for b in cancelled_biases(net)}
        gc, gh, gd = card.grads(), host.grads(), host64.grads()
        errs64 = grad_parity(card64.grads(), gd, None, noise)
        k64 = max(errs64, key=errs64.get)
        if errs64[k64] > 1e-3:
            raise AssertionError(f"[{tag}] {name}: float64 gradient {k64} at "
                                 f"{errs64[k64]:.3e} of its scale (bar 1e-3)")
        errs = grad_parity(gc, gh, gd, noise)
        k = max(errs, key=errs.get)
        for kk in sorted(errs, key=errs.get)[-3:]:
            g, h, d = (x[kk].double().cpu() for x in (gc, gh, gd))
            sc = float(d.abs().max())

            def dist(a, b):
                return float((a - b).abs().max()) / sc
            say(f"[{tag}]   {name} fp32 {kk}: card-host {dist(g, h):.3e}, "
                f"host-f64 {dist(h, d):.3e}, card-f64 {dist(g, d):.3e} of "
                f"{sc:.3e}")
        out[name] = {"float64": errs64[k64], "float64_leaf": k64,
                     "fp32": errs[k], "fp32_leaf": k,
                     "fp32_over_1e-3": sum(v > 1e-3 for v in errs.values()),
                     "leaves": len(errs)}
        say(f"[{tag}] card vs host, {card.what}: metrics within rtol 1e-4 in "
            f"fp32 and float64; float64 gradients: worst leaf {k64} at "
            f"{errs64[k64]:.3e} of its scale (bar 1e-3); measured, not "
            f"held: fp32 worst leaf {k} at {errs[k]:.3e} by grad_parity, "
            f"{out[name]['fp32_over_1e-3']} of {len(errs)} leaves above "
            "1e-3")
        if name in KINKS:
            runs = {"card": kink_flips(name, dev),
                    "host": kink_flips(name, "cpu")}
            if name == "imtrans":
                runs["card, cuDNN off"] = kink_flips(name, dev, cudnn=False)
            out[name]["kink_flips"] = runs
            say(f"[{tag}]   {name}: {KINKS[name][2]} inputs on the other side "
                "of the kink from float64: " + "; ".join(
                    f"{where} {n} (the farthest from it {near:.2e} of its "
                    "tensor's largest |value|)"
                    for where, (n, near) in runs.items()))
        del card, host, card64, host64
    torch.backends.cudnn.deterministic = False
    return out


def phase13(dev: torch.device, card: str) -> dict:
    """The Module1-side trainers: timed at full width and card against
    host (``train.convergence`` runs in phase 14, over all seven runs)."""
    return {"timed": phase13_timed(dev, card),
            "parity": phase13_parity(dev)}


# phase 14: the landmark-detector trainers (FAN/AWing, face_of_art), the
# Module2 network registry (gan_extra's define_g / define_d) and LPIPS
FOA_TREE_PHOTOS = 8        # the synthetic ibug-style tree of train_foa
FOA_DRIVER_STEPS = 8
GAN_BATCH = 4
GAN_SIZE = 256
LPIPS_BATCH = 8


def write_foa_tree(root: str, n: int = FOA_TREE_PHOTOS,
                   size: int = 320) -> str:
    """A seeded ibug-style directory: ``n`` photos (every other one a
    baseline JPEG, the rest PNG) of a shaded face with dark strokes at its
    68 landmarks, each with its 1-based ``.pts`` file."""
    from animateportrait_tpu_torch.train.convergence import render_face
    from animateportrait_tpu_torch.utils.assets import std_face_landmarks
    from animateportrait_tpu_torch.utils.image import write_png
    from animateportrait_tpu_torch.utils.jpeg import encode_jpeg

    rng = np.random.default_rng(14)
    base = std_face_landmarks().reshape(68, 3)[:, :2]
    base = base - base.min(0)
    base = base / base.max() * (0.5 * size) + 0.25 * size
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        lm = base[:, ::-1] + rng.uniform(-4, 4, (68, 2))
        img = render_face(lm, size)
        img = np.clip(img * rng.uniform(0.6, 1.0, 3) * 255 + rng.normal(
            0, 6, img.shape), 0, 255).astype(np.uint8)
        stem = os.path.join(root, f"face{i:02d}")
        if i % 2:
            with open(stem + ".jpg", "wb") as f:
                f.write(encode_jpeg(img[:, :, ::-1]))
        else:
            write_png(stem + ".png", img)
        with open(stem + ".pts", "w") as f:
            f.write("version: 1\nn_points: 68\n{\n")
            f.writelines(f"{x + 1:.3f} {y + 1:.3f}\n" for y, x in lm)
            f.write("}\n")
    return root


def phase14_foa(dev: torch.device, card: str, tmp: str) -> dict:
    """``train_foa`` for ``FOA_DRIVER_STEPS`` steps at 256^2, batch 4, over
    a seeded ibug-style tree with augmentation on (geometric p 0.5, the
    TPS warps on the card), the host's share of the run in the data layer;
    then ``predict_artistic_landmarks`` with PDMs from ``train_pdm`` on
    synthetic shapes, ms per photo."""
    from animateportrait_tpu_torch.data import face_of_art as fdata
    from animateportrait_tpu_torch.models.face_of_art import (
        PART_INDS, predict_artistic_landmarks, train_pdm)
    from animateportrait_tpu_torch.train import face_of_art as ftrain

    root = write_foa_tree(os.path.join(tmp, "ibug"))
    t0 = time.perf_counter()
    items = fdata.load_foa_image_list(root, image_size=256)
    load_s = time.perf_counter() - t0
    if len(items) != FOA_TREE_PHOTOS:
        raise AssertionError(f"[14] {len(items)} items of "
                             f"{FOA_TREE_PHOTOS} photos")
    batches_s = []
    orig = fdata.foa_epoch_batches

    def timed_batches(*a, **kw):
        it = orig(*a, **kw)
        while True:
            t = time.perf_counter()
            try:
                b = next(it)
            except StopIteration:
                return
            batches_s.append(time.perf_counter() - t)
            yield b

    logs = []
    zero_counters()
    fdata.foa_epoch_batches = timed_batches
    try:
        t0 = time.perf_counter()
        tr = ftrain.train_foa(items, train_iter=FOA_DRIVER_STEPS,
                              batch_size=4, image_size=256, p_geom=0.5,
                              augment=True, print_every=4, seed=0,
                              log_fn=logs.append, device=dev)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        fdata.foa_epoch_batches = orig
    launches = read_counters()
    if tr.steps != FOA_DRIVER_STEPS or len(logs) != FOA_DRIVER_STEPS // 4:
        raise AssertionError(f"[14] train_foa: {tr.steps} steps, {logs}")
    if any(launches.values()):
        raise AssertionError(f"[14] train_foa launched {launches}")
    share = sum(batches_s) / total
    say(f"[14] train_foa, {FOA_DRIVER_STEPS} steps at 256^2, batch 4, "
        f"augmentation on (p_geom 0.5) over {len(items)} photos (PNG and "
        f"JPEG, loaded in {load_s:.3f} s): {total:.3f} s, "
        f"{FOA_DRIVER_STEPS / total:.3f} steps/s, the data layer (texture -> "
        f"geometric (TPS on the card) -> basic, targets) {sum(batches_s):.3f}"
        f" s = {100 * share:.1f}% of the run on {card}; last log: "
        f"{logs[-1]}; K1/K2/K2b launches {launches}")
    rng = np.random.default_rng(15)
    faces = items[0].lms[None] + rng.normal(0, 2.0, (40, 68, 2))
    pdms = {part: train_pdm(faces[:, inds], 3)
            for part, inds in PART_INDS.items()}
    model = tr.model.eval()
    predict_artistic_landmarks(items[0].image, model, pdms)
    ms = []
    for it in items:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lms = predict_artistic_landmarks(it.image, model, pdms)
        ms.append(1e3 * (time.perf_counter() - t0))
        if lms.shape != (68, 2) or not np.isfinite(lms).all():
            raise AssertionError(f"[14] predict_artistic_landmarks {lms}")
    say(f"[14] predict_artistic_landmarks (net on the card, part-PDM "
        f"correction and evidence-weighted tuning on the host): median "
        f"{np.median(ms):.2f} ms per 256^2 photo over {len(ms)} on {card}")
    return {"steps_per_s": FOA_DRIVER_STEPS / total, "host_share": share,
            "launches": launches, "predict_ms": float(np.median(ms))}


def gan_inputs(name: str, size: int, batch: int, dev, dtype=torch.float32,
               seed: int = 0) -> list:
    """Seeded inputs of ``define_g(name)``'s forward: the photo, landmark
    images, motion grids (N, H, W, 2), flow (N, 2, H, W) and mask as the
    net's mode takes them."""
    from animateportrait_tpu_torch.models import gan_extra as gx

    g = torch.Generator().manual_seed(seed)

    def u(*shape, lo=-1.0, hi=1.0):
        return (lo + (hi - lo) * torch.rand(*shape, generator=g)).to(
            dev, dtype)

    def land(c=1):
        return torch.where(u(batch, c, size, size) > 0.8, 1.0, -1.0).to(dtype)

    x = u(batch, 3, size, size)
    motion, motion2 = u(batch, size, size, 2), u(batch, size, size, 2)
    flow, mask = u(batch, 2, size, size, lo=-3, hi=3), u(batch, 1, size,
                                                         size, lo=0)
    if name in gx.CONDITIONAL:
        mode = gx.CONDITIONAL[name][1]
        return {"none": [x, land(), land()],
                "fw": [x, land(), land(), motion],
                "fw2": [x, land(), land(), motion],
                "ifw": [x, land(), land(), motion, flow, mask]}[mode]
    if name in gx.TRIDENT_VARIANTS:
        v = gx.TRIDENT_VARIANTS[name]
        lc = v.get("land_nc", 1)
        return {"both": [x, land(lc), land(lc), motion, flow, mask],
                "dual_motion": [x, land(), land(), motion, None, None,
                                motion2],
                "motion": [x, land(), land(), motion],
                "flow": [x, land(), land(), None, flow, mask]}[v["warp"]]
    if name == "resnet_9blocks_rcatland32_full_ifw":
        return [x, land(), land(), motion, flow, mask]
    if name == "resnet_9blocks_rcatland4":
        return [x, land(), land()]
    if name == "resnet_9blocks_rcatland2":
        return [x, x.roll(7, 2)]
    if name == "resnet_style2_9blocks":
        return [x, u(batch, 3, size // 4, size // 4)]
    if name == "regressor":
        return [u(batch, 3, 11, 11)]
    return [x]


def gan_net(kind: str, name: str, ngf: int, seed: int = 0) -> torch.nn.Module:
    """``define_g(name)`` (output_nc 1, the Regressor at arch 2, the one
    with InstanceNorms) or ``define_d(name)`` with seeded N(0, 0.02)
    weights (the reference's init)."""
    from animateportrait_tpu_torch.models import gan_extra as gx
    from animateportrait_tpu_torch.models.gan import init_weights

    if kind == "d":
        net = gx.define_d(name, 3, ndf=ngf)
    else:
        kw = {"arch": 2} if name == "regressor" else {}
        net = gx.define_g(name, 3, 1, ngf=ngf, **kw)
    return init_weights(net, generator=torch.Generator().manual_seed(seed))


def _mean_square(out) -> torch.Tensor:
    outs = out if isinstance(out, tuple) else (out,)
    return sum(torch.mean(torch.square(o)) for o in outs)


def gan_cases() -> list[tuple[str, str, int]]:
    """(kind, name, input side) of every define_g and define_d name: 256^2,
    the class discriminator at 512^2 (its 16x16 head), the Regressor at
    its 11x11 patches."""
    from animateportrait_tpu_torch.models import gan_extra as gx

    cases = [("g", n, 11 if n == "regressor" else GAN_SIZE)
             for n in sorted(gx.NETG)]
    return cases + [("d", n, 512 if n == "cls" else GAN_SIZE)
                    for n in sorted(gx.NETD)]


def keep_by_shape(net) -> tuple[dict, list]:
    """Pre-hooks keeping the first InstanceNorm input of each (shape, relu)
    that ``net`` feeds its norms."""
    from animateportrait_tpu_torch.nn import InstanceNorm2d

    kept, hooks = {}, []
    for mod in net.modules():
        if isinstance(mod, InstanceNorm2d):
            def keep(mod, args):
                key = f"{tuple(args[0].shape)} relu={mod.relu}"
                if key not in kept:
                    kept[key] = (args[0].detach().clone(), mod.relu)
            hooks.append(mod.register_forward_pre_hook(keep))
    return kept, hooks


def phase14_gan_extra(dev: torch.device, card: str) -> dict:
    """Every ``define_g`` / ``define_d`` name at ngf (ndf) 64, batch 4: a warm
    forward + backward that keeps the first InstanceNorm input of each
    shape, K2 against its plain version and K2 + K2b against float64 on
    those, then one forward + backward with the counters zeroed just
    before it (K2 and K2b must both launch) and its time between CUDA
    events."""
    out, worst_fwd, worst_grad = {}, 0.0, {}
    for kind, name, size in gan_cases():
        net = gan_net(kind, name, 64).to(dev).train()
        args = gan_inputs(name, size, GAN_BATCH, dev)
        kept, hooks = keep_by_shape(net)
        _mean_square(net(*args)).backward()
        for h in hooks:
            h.remove()
        net.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counters()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        loss = _mean_square(net(*args))
        ev[1].record()
        loss.backward()
        ev[2].record()
        torch.cuda.synchronize()
        launches = read_counters()
        if not (launches["instance_norm"] > 0
                and launches["instance_norm_backward"] > 0):
            raise AssertionError(f"[14] {name}: K2/K2b did not both launch: "
                                 f"{launches}")
        if not torch.isfinite(loss):
            raise AssertionError(f"[14] {name}: loss {loss}")
        tag = f"14 {name}"
        fwd = k2_on_path(kept, tag, by_shape_lines=False)
        grad = k2_gradient_on_path(kept, tag, by_shape_lines=False)
        worst_fwd = max(worst_fwd, fwd)
        for k, v in grad.items():
            worst_grad[k] = max(worst_grad.get(k, 0.0), v)
        planes = sorted({tuple(x.shape[2:]) for x, _ in kept.values()})
        say(f"[14] {kind} {name} {GAN_BATCH}x3x{size}^2: forward "
            f"{ev[0].elapsed_time(ev[1]):.3f} ms, backward "
            f"{ev[1].elapsed_time(ev[2]):.3f} ms, peak memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB on "
            f"{card}; K2 x{launches['instance_norm']}, K2b "
            f"x{launches['instance_norm_backward']}; InstanceNorm planes "
            f"{planes[0]} to {planes[-1]}")
        out[name] = {"launches": launches, "planes": planes,
                     "fwd_ms": ev[0].elapsed_time(ev[1]),
                     "bwd_ms": ev[1].elapsed_time(ev[2])}
        del net, args, kept, loss
        torch.cuda.empty_cache()
    if not any((2, 2) in r["planes"] for r in out.values()):
        raise AssertionError("[14] no 2x2 InstanceNorm plane was held")
    return {"nets": out, "k2_path_err": worst_fwd, "k2b_worst": worst_grad}


def phase14_gan_parity(dev: torch.device) -> dict:
    """Card against host at small widths (ngf 8, 64^2, batch 2; unet_256
    at ngf 4 and 256^2, the class discriminator at 512^2 and batch 1):
    every output within 1e-4 of its scale, the loss (mean square of the
    outputs) within rtol 1e-4, every gradient leaf by ``grad_parity`` with
    the host's float64 run."""
    from animateportrait_tpu_torch.utils.smoke import (
        cancelled_biases, grad_parity)

    worst = {"out": 0.0, "grad": 0.0}
    torch.backends.cudnn.deterministic = True
    for kind, name, size in gan_cases():
        small = {"unet_128": 128, "unet_256": 256, "cls": 512,
                 "regressor": 11}.get(name, 64)
        batch = 1 if name == "cls" else 2
        ngf = 4 if name == "unet_256" else 8
        runs = []
        for where, dt in ((dev, torch.float32), ("cpu", torch.float32),
                          ("cpu", torch.float64)):
            net = gan_net(kind, name, ngf).to(where, dt).train()
            out = net(*gan_inputs(name, small, batch, where, dt))
            loss = _mean_square(out)
            loss.backward()
            outs = out if isinstance(out, tuple) else (out,)
            runs.append(([o.detach().double().cpu() for o in outs],
                         float(loss.detach()),
                         {k: p.grad for k, p in net.named_parameters()}))
        (oc, lc, gc), (oh, lh, gh), (_, _, g64) = runs
        err = max(float((a - b).abs().max()) / float(b.abs().max())
                  for a, b in zip(oc, oh))
        if err > 1e-4 or abs(lc - lh) > 1e-4 * abs(lh):
            raise AssertionError(f"[14] {name}: card vs host outputs {err:.2e}"
                                 f" of their scale, loss {lc} vs {lh}")
        errs = grad_parity(gc, gh, g64, cancelled_biases(net))
        k = max(errs, key=errs.get)
        say(f"[14] card vs host, {kind} {name} {batch}x3x{small}^2 ngf "
            f"{ngf}: outputs {err:.2e} of their scale, loss rtol "
            f"{abs(lc - lh) / abs(lh):.2e}; gradients by grad_parity: worst "
            f"{k} {errs[k]:.2e} (bar 1e-3)")
        if errs[k] > 1e-3:
            raise AssertionError(f"[14] {name}: gradient {k} at {errs[k]:.3e}")
        worst["out"] = max(worst["out"], err)
        worst["grad"] = max(worst["grad"], errs[k])
    torch.backends.cudnn.deterministic = False
    return worst


def phase14_lpips(dev: torch.device, card: str, frames: np.ndarray) -> dict:
    """LPIPS (vgg, alex, squeeze; ``lpips=True`` and ``spatial=True``, seeded
    weights) on two batches of phase 3's frames, ms per pair (CUDA events
    over 5 calls after a warm one), counters 0; card against host on the
    first two pairs at 64^2 within 1e-4 of the distance's scale."""
    from animateportrait_tpu_torch.models import lpips
    from animateportrait_tpu_torch.train.convergence import seeded

    x = torch.from_numpy(frames[:2 * LPIPS_BATCH, ..., 0].astype(
        np.float32) / 127.5 - 1.0)[:, None].expand(-1, 3, -1, -1)
    a, b = x[:LPIPS_BATCH].contiguous(), x[LPIPS_BATCH:].contiguous()
    out = {}
    for pnet in ("vgg", "alex", "squeeze"):
        for spatial in (False, True):
            net = seeded(lambda: lpips.PNetLin(pnet, spatial=spatial), 3)
            host = net.eval()
            with torch.no_grad():
                want = host(a[:2, :, :64, :64], b[:2, :, :64, :64])
                card_net = copy.deepcopy(host).to(dev)
                got = card_net(a[:2, :, :64, :64].to(dev),
                               b[:2, :, :64, :64].to(dev)).cpu()
                err = float((got - want).abs().max() / want.abs().max())
                if err > 1e-4:
                    raise AssertionError(f"[14] LPIPS {pnet}: card vs host "
                                         f"{err:.2e}")
                ad, bd = a.to(dev), b.to(dev)
                card_net(ad, bd)
                zero_counters()
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                for _ in range(5):
                    d = card_net(ad, bd)
                ev[1].record()
                torch.cuda.synchronize()
            launches = read_counters()
            if any(launches.values()) or not torch.isfinite(d).all():
                raise AssertionError(f"[14] LPIPS {pnet}: {launches}")
            ms = ev[0].elapsed_time(ev[1]) / 5 / LPIPS_BATCH
            key = f"{pnet}{'_spatial' if spatial else ''}"
            out[key] = {"ms_per_pair": ms, "card_vs_host": err,
                        "launches": launches}
            say(f"[14] LPIPS {key}: {ms:.3f} ms per 256^2 pair (batch "
                f"{LPIPS_BATCH}) on {card}, distance shape "
                f"{tuple(d.shape)}, mean {float(d.mean()):.4f}; card vs host "
                f"{err:.2e} of the distance; K1/K2/K2b launches {launches}")
    return out


def phase14(dev: torch.device, card: str, main_run: dict) -> dict:
    """The landmark-detector trainers, the network registry and LPIPS, and
    ``train.convergence`` for ``M1_CONVERGENCE_STEPS`` steps over all seven
    runs."""
    from animateportrait_tpu_torch.train import convergence

    t0 = time.perf_counter()
    timed = phase13_timed(dev, card, ("fan", "foa"), "14")
    parity = phase13_parity(dev, ("fan", "foa"), "14")
    with tempfile.TemporaryDirectory() as tmp:
        foa = phase14_foa(dev, card, tmp)
    gan = phase14_gan_extra(dev, card)
    gan_parity = phase14_gan_parity(dev)
    lp = phase14_lpips(dev, card, main_run["frames"])
    zero_counters()
    t1 = time.perf_counter()
    rows = convergence.run_all(M1_CONVERGENCE_STEPS, dev, say=lambda m: None)
    torch.cuda.synchronize()
    for line in convergence.table(rows).splitlines():
        say(f"[14] {line}")
    if len(rows) != 8 or not all(last < first for _, first, last in rows):
        raise AssertionError(f"[14] a convergence metric did not fall: {rows}")
    launches = read_counters()
    if any(launches.values()):
        raise AssertionError(f"[14] kernel launches {launches} in the "
                             "convergence runs")
    say(f"[14] train.convergence --steps {M1_CONVERGENCE_STEPS}: all "
        f"{len(convergence.RUNS)} runs, {len(rows)} metrics fall, "
        f"{time.perf_counter() - t1:.1f} s; K1/K2/K2b launches {launches}")
    say(f"[14] phase 14 in {time.perf_counter() - t0:.1f} s")
    return {"timed": timed, "parity": parity, "foa": foa, "gan": gan,
            "gan_parity": gan_parity, "lpips": lp, "convergence": rows,
            "launches": launches}


# phase 15: the last modules and the training-data tools (postalign,
# av2flau, fakeB_static, get_data and puppet, the GAN convergence run with
# its stand-in frozen nets), and the card's fp32 FAN gradients
POSTALIGN_PT_ATOL = 1e-3        # tracked points, card against host, px
FAKEB_MIN_PSNR = 40.0           # the static stylizations, card vs host
VIDEO_FIXTURE = "face_clip_mjpg.avi"   # tests/torch_video_fixtures.py
FAN_KINK = ("animateportrait_tpu_torch.models.fan", "F", "relu")


def drifting_clip(n: int = 8, size: int = 96, seed: int = 1) -> np.ndarray:
    """``tests/test_postalign.py``'s drifting clip: a smoothed blocky
    texture shifted by a seeded random walk (bilinear, reflect), RGB
    float32."""
    from animateportrait_tpu_torch.pipeline.postalign import shift_reflect

    rng = np.random.default_rng(0)
    img = np.kron(rng.uniform(0, 255, (size // 8, size // 8)), np.ones((8, 8)))
    pad = np.pad(img, 2, mode="symmetric")
    img = sum(pad[i: i + size, j: j + size] for i in range(5)
              for j in range(5)) / 25.0
    offs = np.cumsum(np.random.default_rng(seed).uniform(-1.5, 1.5, (n, 2)),
                     axis=0)
    base = torch.as_tensor(img, dtype=torch.float32)
    frames = [shift_reflect(base, torch.as_tensor(o, dtype=torch.float32))
              .numpy() for o in offs]
    return np.repeat(np.stack(frames)[..., None], 3, -1)


def phase15_postalign(dev: torch.device, frames: np.ndarray) -> dict:
    from animateportrait_tpu_torch.pipeline.postalign import postalign_video

    clip = np.repeat(frames, 3, -1) if frames.shape[-1] == 1 else frames
    postalign_video(clip[:8], device=dev)               # warm
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, pts = postalign_video(clip, device=dev, return_points=True)
    dt = time.perf_counter() - t0
    launches = read_counters()
    t0 = time.perf_counter()
    out_h, pts_h = postalign_video(clip, device="cpu", return_points=True)
    dt_h = time.perf_counter() - t0
    pt_err = float(np.abs(pts - pts_h).max())
    d = np.abs(out.astype(np.int16) - out_h.astype(np.int16))
    n_off = int(np.count_nonzero(d))
    t = clip.shape[0] - 2
    say(f"[15] postalign_video on phase 3's {clip.shape[0]} frames "
        f"{clip.shape[1:]}: card {t / dt:.2f} frames/s ({dt:.3f} s), host "
        f"{t / dt_h:.2f} frames/s; card vs host: tracked points max|diff| "
        f"{pt_err:.3e} px (<= {POSTALIGN_PT_ATOL}), frames max|diff| "
        f"{int(d.max())} level(s) on {n_off} of {d.size} values (<= 1 on "
        f"<= 0.1%); kernel launches {launches}")
    if not (pt_err <= POSTALIGN_PT_ATOL and d.max() <= 1
            and n_off <= 1e-3 * d.size and out.shape == out_h.shape
            == (t,) + clip.shape[1:]):
        raise AssertionError("postalign card vs host")
    drift_clip = drifting_clip()
    stab_out = postalign_video(drift_clip, mask_region=(20, 20), device=dev)
    sl = np.s_[:, 20:-20, 20:-20, :]
    drift = float(np.mean(np.abs(np.diff(drift_clip[2:][sl], axis=0))))
    stab = float(np.mean(np.abs(np.diff(stab_out[sl], axis=0))))
    say(f"[15] postalign on a drifting 96^2 clip (tests/test_postalign.py): "
        f"mean |frame difference| {drift:.3f} -> {stab:.3f} (< half)")
    if not stab < 0.5 * drift:
        raise AssertionError("postalign did not stabilize the drifting clip")
    return {"frames_per_s": t / dt, "host_frames_per_s": t / dt_h,
            "pt_err": pt_err, "frames_off": n_off, "launches": launches}


def phase15_av2flau(dev: torch.device, tmp: str) -> dict:
    import hashlib

    from animateportrait_tpu_torch.data.av2flau import (
        Av2FlauConverter, read_video_frames)
    from animateportrait_tpu_torch.models import fan3d
    from animateportrait_tpu_torch.models.autovc import AutoVCGenerator
    from animateportrait_tpu_torch.pipeline.audio import AudioPipeline
    from animateportrait_tpu_torch.utils.assets import ASSET_DIR
    from animateportrait_tpu_torch.utils.smoke import init_random_, make_wav
    from animateportrait_tpu_torch.utils.video import write_wav

    path = os.path.join(ASSET_DIR, VIDEO_FIXTURE)
    with open(os.path.join(ASSET_DIR, "video_fixtures.json")) as f:
        rec = json.load(f)[VIDEO_FIXTURE]
    t0 = time.perf_counter()
    frames, fps = read_video_frames(path)
    ms = (time.perf_counter() - t0) * 1e3
    bad = [i for i, (a, h) in enumerate(zip(frames, rec["frames"]))
           if hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
           != h["sha256"]]
    say(f"[15] read_video_frames({VIDEO_FIXTURE}): {len(frames)} frames "
        f"{frames.shape[1:]} at {fps} fps in {ms:.1f} ms; frames whose "
        f"SHA-256 differs from OpenCV's decode: {bad}")
    if bad or len(frames) != len(rec["frames"]) or fps != rec["fps"]:
        raise AssertionError("the Motion-JPEG fixture does not decode as "
                             "OpenCV decodes it")

    # seeded full-width nets, as utils/smoke.py:write_fan_checkpoints
    torch.manual_seed(0)
    nets = {"fan": fan3d.FAN3D(), "depth": fan3d.ResNetDepth(),
            "autovc": init_random_(AutoVCGenerator(),
                                   torch.Generator().manual_seed(0))}
    wav = write_wav(os.path.join(tmp, "speech.wav"), make_wav(6.0, seed=3))

    def detector(rgb):
        h, w = rgb.shape[:2]
        return np.array([[w * 0.25, h * 0.2, w * 0.75, h * 0.8, 1.0]]), None

    runs = {}
    for label, where in (("card", dev), ("host", torch.device("cpu"))):
        fa = fan3d.FaceAlignment3D(copy.deepcopy(nets["fan"]),
                                   copy.deepcopy(nets["depth"]), where)
        hook = fan3d.make_fan_landmark_fn(fa, detector)
        raw = []

        def landmarks(frame, hook=hook, raw=raw):
            raw.append(hook(frame))
            return raw[-1]

        conv = Av2FlauConverter(landmarks, AudioPipeline(
            copy.deepcopy(nets["autovc"]), device=where))
        zero_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fl3d, feats, _ = conv.convert(path, wav, out_dir=os.path.join(
            tmp, f"av2flau_{label}"), register=True)
        dt = time.perf_counter() - t0
        runs[label] = {"fl3d": fl3d, "raw": np.stack(raw), "s": dt,
                       "feats": feats.mel_autovc, "launches": read_counters()}
    c, h = runs["card"], runs["host"]
    launches = c["launches"]
    moved = np.abs(c["raw"][..., :2] - h["raw"][..., :2]).max(-1)   # (T, 68)
    same = ~(moved > 0).any(-1)
    reg_err = float(np.abs(c["fl3d"][same] - h["fl3d"][same]).max()) \
        if same.any() else 0.0
    z_err = float(np.abs(c["raw"][same, :, 2] - h["raw"][same, :, 2]).max()
                  ) if same.any() else 0.0
    au_err = float(np.abs(c["feats"] - h["feats"]).max())
    say(f"[15] Av2FlauConverter (FAN3D + depth, seeded, full width; "
        f"AudioPipeline on 6 s): card {c['s']:.2f} s, host {h['s']:.2f} s; "
        f"{c['fl3d'].shape[0]} rows, frame indices equal: "
        f"{np.array_equal(c['fl3d'][:, 0], h['fl3d'][:, 0])}; landmarks "
        f"(x, y) that differ card vs host: {int((moved > 0).sum())} of "
        f"{moved.size}, by up to {float(moved.max()):.3f} px; on the "
        f"{int(same.sum())} frames whose (x, y) agree, raw z max|diff| "
        f"{z_err:.3e} and registered rows max|diff| {reg_err:.3e}; "
        f"AutoVC features max|diff| {au_err:.3e}; kernel launches on the "
        f"card {launches}")
    if not (np.array_equal(c["fl3d"][:, 0], h["fl3d"][:, 0])
            and np.isfinite(c["fl3d"]).all() and launches["stft_magnitude"]
            == 1 and reg_err <= 1e-3 and (moved > 0).mean() <= 0.05):
        raise AssertionError("av2flau card vs host, or K1 not once")
    return {"launches": launches, "landmarks_moved": int((moved > 0).sum()),
            "reg_err": reg_err, "card_s": c["s"]}


def phase15_fakeb(dev: torch.device, tmp: str, tree: str) -> dict:
    import shutil

    from animateportrait_tpu_torch.data import fakeb_static as fb
    from animateportrait_tpu_torch.utils.image import read_image

    out = {}
    for style in ("drawing", "cartoon"):
        root = os.path.join(tmp, f"fakeb_{style}")
        shutil.copytree(os.path.join(tree, "Photo"),
                        os.path.join(root, "Photo"))
        photos = fb.photos_of(root)
        net = fb.build_static_net(style, None, dev)
        kept, hooks = keep_instance_norm_inputs({style: net})
        fb.stylize(net, style, read_image(photos[0]))       # warm, keeps
        for h in hooks:
            h.remove()
        k2_err = k2_on_path(kept, "15", by_shape_lines=False)
        zero_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        written = fb.make_fakeb_static(root, style=style, device=dev,
                                       net=net)
        dt = time.perf_counter() - t0
        launches = read_counters()
        # the net's forward alone, CUDA events, median of 5
        size = fb.IN_SIZE[style]
        x = torch.zeros((1, 3, size, size), device=dev)
        args = (x, torch.zeros((1, 3, 128, 128), device=dev)) \
            if style == "drawing" else (x,)
        net_ms = []
        with torch.inference_mode():
            for _ in range(6):
                a, b = (torch.cuda.Event(enable_timing=True) for _ in "ab")
                a.record()
                net(*args)
                b.record()
                torch.cuda.synchronize()
                net_ms.append(a.elapsed_time(b))
        host = fb.build_static_net(style, None, "cpu")
        psnrs = [psnr(read_image(p)[:, :, ::-1], fb.stylize(
            host, style, read_image(src)), 255.0)
            for p, src in list(zip(written, photos))[:2]]
        n = len(photos)
        out[style] = {"ms_per_photo": dt / n * 1e3,
                      "net_ms": float(np.median(net_ms[1:])),
                      "k2_per_photo": launches["instance_norm"] / n,
                      "launches": launches, "k2_path_err": k2_err,
                      "psnr": min(psnrs)}
        say(f"[15] fakeB_static {style} over phase 8's {n} photos (512^2 "
            f"PNG, full width, seeded): {dt / n * 1e3:.1f} ms a photo with "
            f"the host's read, resizes and PNG write (the net's forward "
            f"{out[style]['net_ms']:.2f} ms, CUDA events, median of 5); K2 "
            f"launches a photo {launches['instance_norm'] / n:.1f} "
            f"({launches}); K2 against its plain version on the net's "
            f"{len(kept)} InstanceNorm inputs max|diff| {k2_err:.3e}; card "
            f"vs host on 2 photos: PSNR {min(psnrs):.2f} dB (>= "
            f"{FAKEB_MIN_PSNR})")
        if not (min(psnrs) >= FAKEB_MIN_PSNR and launches["instance_norm"]
                > 0 and len(written) == n):
            raise AssertionError(f"fakeB_static {style}: {out[style]}")
        del net, host
    return out


def phase15_get_data(tmp: str, tree: str) -> None:
    import shutil
    import tarfile

    from animateportrait_tpu_torch.utils.get_data import (
        GetData, validate_umlvd_layout)
    from animateportrait_tpu_torch.utils.image import read_image
    from animateportrait_tpu_torch.utils.puppet import get_puppet_info

    arch = os.path.join(tmp, "archives")
    os.makedirs(arch)
    t0 = time.perf_counter()
    with tarfile.open(os.path.join(arch, "umlvd.tar"), "w") as tf:
        tf.add(tree, arcname="umlvd")
    staged = GetData(arch, verbose=False).get(
        "umlvd.tar", save_path=os.path.join(tmp, "datasets"))
    missing = validate_umlvd_layout(staged)
    evil = os.path.join(tmp, "evil.txt")
    with open(evil, "w") as f:
        f.write("x")
    with tarfile.open(os.path.join(arch, "evil.tar"), "w") as tf:
        tf.add(evil, arcname="../evil_escape.txt")
    try:
        GetData(arch, verbose=False).get(
            "evil.tar", save_path=os.path.join(tmp, "out"))
        refused = False
    except Exception:         # refused, as tests/test_get_data.py asserts
        refused = True
    escaped = os.path.exists(os.path.join(tmp, "evil_escape.txt"))
    photo = sorted(os.listdir(os.path.join(staged, "Photo")))[0]
    shutil.copy(os.path.join(staged, "Photo", photo),
                os.path.join(tmp, "mypuppet.png"))
    np.savetxt(os.path.join(tmp, "mypuppet_scale_shift.txt"),
               [-0.01, -10.0, -20.0])
    named = get_puppet_info("cat", tmp)
    generic = get_puppet_info("mypuppet", tmp)
    say(f"[15] get_data: staged {os.path.basename(staged)} from a tar of "
        f"phase 8's tree in {time.perf_counter() - t0:.2f} s, missing "
        f"layout dirs {missing}; a '../' member refused: {refused}, "
        f"written outside: {escaped}; puppet: named bound "
        f"{named[0].shape}, generic bound {generic[0].shape} "
        f"{generic[0][0, :6].tolist()}")
    # the reference's "w" is the photo's height - 1 (utils/puppet.py)
    height = read_image(os.path.join(tmp, "mypuppet.png")).shape[0]
    if missing or not refused or escaped or generic[0].shape != (1, 24) \
            or generic[0][0, 3] != (height - 1) // 4:
        raise AssertionError("get_data / puppet")


def phase15_convergence(dev: torch.device, tmp: str) -> dict:
    from animateportrait_tpu_torch.train import gan_convergence as gc
    from animateportrait_tpu_torch.train import standin_frozen as sf

    frozen = os.path.join(tmp, "standin")
    t0 = time.perf_counter()
    summary = sf.main([frozen, "--steps", "100", "--sphere_steps", "100",
                       "--n_faces", "400", "--ids", "12", "--per_id", "20",
                       "--device", str(dev)])
    t_sf = time.perf_counter() - t0
    say(f"[15] standin_frozen, 100 + 100 steps over 400 faces and 12 x 20 "
        f"identities, in {t_sf:.1f} s: held-out landmark error "
        f"{summary['mfn_val_px_err']:.2f} px (NME "
        f"{summary['mfn_nme_pct']:.2f}%), identity accuracy "
        f"{summary['sphere_val_acc'] * 100:.1f}%")
    work = os.path.join(tmp, "gan")
    gc.build_dataset(os.path.join(work, "drawing"))
    ckpt = os.path.join(work, "ckpt")
    zero_counters()
    t0 = time.perf_counter()
    gc.run_training(os.path.join(work, "drawing"), ckpt, 256, 40, 60, 50, 64,
                    print_freq=1, frozen_dir=frozen, device=dev,
                    in_process=True)
    dt = time.perf_counter() - t0
    launches = read_counters()
    rows = gc.read_metrics(ckpt)
    keys = [k for k in rows[0] if k not in ("epoch", "iters")]
    finite = all(np.isfinite([r[k] for k in keys]).all() for r in rows)
    first = {k: float(np.mean([r[k] for r in rows[:8]])) for k in keys}
    last = {k: float(np.mean([r[k] for r in rows[-8:]])) for k in keys}
    say(f"[15] gan_convergence at crop 256, ngf 64, batch 1 with the "
        f"stand-ins: 40 steps, resumed to 60, in {dt:.1f} s (both "
        f"train_cli.main calls, their loaders and saves); loss log iters "
        f"{rows[0]['iters']}..{rows[-1]['iters']} ({len(rows)} rows), "
        f"finite: {finite}; first/last 8 means: " + ", ".join(
            f"{k} {first[k]:.4f} -> {last[k]:.4f}"
            for k in ("warp_B", "geom_B", "iden_B", "D_A", "G_A"))
        + f"; kernel launches {launches}")
    if not (finite and [r["iters"] for r in rows] == list(range(1, 61))
            and launches["instance_norm"] > 0
            and launches["instance_norm_backward"] > 0):
        raise AssertionError("the GAN convergence run")
    return {"launches": launches, "seconds": dt, "standin": summary,
            "first": first, "last": last}


def phase15_fan_gradients(dev: torch.device) -> dict:
    """The small FAN step's fp32 gradients on the card against the host's
    float64 step (ROADMAP Queue 3): with cuDNN's default algorithms, its
    deterministic ones, and cuDNN off; the host's fp32 step beside them;
    and the ReLU inputs on the other side of the kink from float64."""
    from animateportrait_tpu_torch.utils.smoke import (
        cancelled_biases, grad_parity, trainer_smoke)

    host64 = trainer_smoke("fan", "cpu", small=True, dtype=torch.float64)
    host64.step()
    gd = host64.grads()
    noise = {f"{n}.{b}" for n, net in host64.nets.items()
             for b in cancelled_biases(net)}
    out = {}
    KINKS["fan"] = FAN_KINK
    for label, where, cudnn, det in (
            ("host", "cpu", True, False),
            ("card, cuDNN default", dev, True, False),
            ("card, cuDNN deterministic", dev, True, True),
            ("card, cuDNN off", dev, False, False)):
        torch.backends.cudnn.enabled = cudnn
        torch.backends.cudnn.deterministic = det
        try:
            run = trainer_smoke("fan", where, small=True)
            run.step()
            errs = grad_parity(run.grads(), gd, None, noise)
            flips = kink_flips("fan", where, cudnn=cudnn)
        finally:
            torch.backends.cudnn.enabled = True
            torch.backends.cudnn.deterministic = False
        k = max(errs, key=errs.get)
        out[label] = {"worst": errs[k], "leaf": k,
                      "over_1e-3": sum(v > 1e-3 for v in errs.values()),
                      "leaves": len(errs), "flips": flips}
        say(f"[15] FAN small step, fp32 gradients against the host's "
            f"float64 step, {label}: worst leaf {k} at {errs[k]:.3e} of its "
            f"scale, {out[label]['over_1e-3']} of {len(errs)} leaves above "
            f"1e-3; ReLU inputs on the other side of the kink from float64: "
            f"{flips[0]} (the farthest from it {flips[1]:.2e} of its "
            f"tensor's largest |value|)")
    del KINKS["fan"]
    return out


def phase15(dev: torch.device, main_run: dict, tmp: str, tree: str) -> dict:
    t0 = time.perf_counter()
    res = {"postalign": phase15_postalign(dev, main_run["frames"]),
           "av2flau": phase15_av2flau(dev, tmp),
           "fakeb": phase15_fakeb(dev, tmp, tree)}
    phase15_get_data(tmp, tree)
    res["convergence"] = phase15_convergence(dev, tmp)
    res["fan_gradients"] = phase15_fan_gradients(dev)
    say(f"[15] phase 15 in {time.perf_counter() - t0:.1f} s")
    return res


# --- phase 16: the multi-card paths on one card ------------------------------

DP_RANKS = 2
DP_STEPS = 2
DP_LOSS_RTOL = 1e-4
DP_LEAF_BAR = 1e-3      # of a gradient leaf's scale (grad_parity)
DP_POOL_ATOL = 1e-4     # the fakes of the same G, batch 2 against batch 4
DP_POOL2_ATOL = 1e-3    # the fakes of a G after one Adam update
RENDER_DP_MIN_PSNR = 40.0
GPIPE_STAGES = 3
GPIPE_MS = [3, 6]           # microbatch counts of phase 16 (d) and 17 (e)
GPIPE_TOL = dict(rtol=2e-5, atol=2e-5)   # tests/test_parallel.py:47


def spawned(fn, devices: list, *args) -> tuple[list, float]:
    """``utils/distributed.py:spawn`` of ``fn`` on ``devices``, each rank
    writing ``rank<r>.pt``: (the ranks' records, wall seconds, the ranks'
    start included)."""
    from animateportrait_tpu_torch.utils import distributed as ddp

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ddp.spawn(fn, devices, *args, d, timeout=600)
        wall = time.perf_counter() - t0
        return [torch.load(os.path.join(d, f"rank{r}.pt"))
                for r in range(len(devices))], wall


def one_process_runs(cfg, batch: dict, dev: torch.device,
                     decompose: int | None = None) -> tuple:
    """``dp_step_run`` of phase 7's step in one process on the global
    batch (with ``decompose``, that many ranks' step emulated: each rank's
    slice alone, at the rank's batch), and its own spread: the same steps
    called again, and with cuDNN's deterministic algorithms. At full
    width and random weights a rounding-level change of the forward moves
    fp32 gradients past ReLU and PReLU kinks by percent (ROADMAP Queue 3),
    Adam turns the noise elements' gradients into +-lr steps, and a
    smaller batch a rank is such a change: each comparison with one
    process is held to the larger of its bar and 3x the wider of the two
    spreads."""
    from animateportrait_tpu_torch.utils.smoke import dp_step_run

    def run():
        return dp_step_run(cfg, batch, DP_STEPS, dev, decompose=decompose)

    single = run()
    others = {"called again": run()}
    torch.backends.cudnn.deterministic = True
    try:
        others["cuDNN deterministic"] = run()
    finally:
        torch.backends.cudnn.deterministic = False
    return single, others


def _loss_diffs(run, ref) -> list:
    return [max(abs(run["metrics"][s][k] - v) / max(abs(v), 1e-5)
                for k, v in ref["metrics"][s].items())
            for s in range(DP_STEPS)]


def _pool_diffs(run, ref) -> list:
    return [float((run["pools"][s] - ref["pools"][s]).abs().max())
            for s in range(DP_STEPS)]


def _noise(cfg, net: str) -> set:
    from animateportrait_tpu_torch.train import module2 as m2
    from animateportrait_tpu_torch.utils.smoke import cancelled_biases

    return cancelled_biases(getattr(m2.init_state(
        cfg, torch.Generator().manual_seed(0), "cpu"), net))


def spread_bars(cfg, single: dict, others: dict, tag: str) -> dict:
    """Each comparison's bar: the larger of its own and 3x the wider of
    the one process's spreads (``one_process_runs``)."""
    from animateportrait_tpu_torch.utils.smoke import grad_parity

    def spread(diffs):
        return [max(v) for v in zip(*(diffs(o, single)
                                      for o in others.values()))]

    bars = {"loss": [max(DP_LOSS_RTOL, 3 * sp)
                     for sp in spread(_loss_diffs)],
            "pool": [max(bar, 3 * sp) for sp, bar in zip(
                spread(_pool_diffs), (DP_POOL_ATOL, DP_POOL2_ATOL))]}
    for net in ("g", "d"):
        spreads = {name: grad_parity(o["grads"][0][net],
                                     single["grads"][0][net], None,
                                     _noise(cfg, net))
                   for name, o in others.items()}
        widest = max(max(v.values()) for v in spreads.values())
        bars[net] = max(DP_LEAF_BAR, 3 * widest)
        say(f"[{tag}] step 1 {net.upper()} gradients, the one process "
            f"against itself: "
            + ", ".join(f"{name}: worst {max(v.values()):.3e}, "
                        f"{sum(e > DP_LEAF_BAR for e in v.values())} of "
                        f"{len(v)} leaves above {DP_LEAF_BAR}"
                        for name, v in spreads.items()))
    return bars


def check_against(tag: str, label: str, rec: dict, ref: dict, bars: dict,
                  cfg) -> list:
    """``rec`` (a ``dp_step_run`` record) against ``ref``'s: the losses
    and the pool after each step, the first step's gradients by
    ``grad_parity`` and Adam's updates by ``adam_update_parity``, each
    printed with its bar; returns the (what, value, bar) that failed."""
    from animateportrait_tpu_torch.utils.smoke import (
        adam_update_parity, grad_parity)

    checks = []          # (what, value, bar)
    for s_, e in enumerate(_loss_diffs(rec, ref)):
        checks.append((f"losses step {s_ + 1}", e, bars["loss"][s_]))
    for s_, e in enumerate(_pool_diffs(rec, ref)):
        checks.append((f"pool step {s_ + 1}", e, bars["pool"][s_]))
    for net in ("g", "d"):
        errs = grad_parity(rec["grads"][0][net], ref["grads"][0][net], None,
                           _noise(cfg, net))
        k = max(errs, key=errs.get)
        checks.append((f"step 1 {net.upper()} gradients, worst leaf {k}",
                       errs[k], bars[net]))
    for net in ("g", "d"):
        bound, decided = adam_update_parity(
            rec["params"][1][net], ref["params"][1][net],
            ref["params"][0][net], ref["grads"][0][net], cfg.lr)
        checks.append((f"{net.upper()}'s step 1 Adam update, decisive "
                       f"elements", decided, 1.0))
        checks.append((f"{net.upper()}'s updates, of 1.5 lr a step", max(
            bound, adam_update_parity(
                rec["params"][DP_STEPS][net], ref["params"][DP_STEPS][net],
                ref["params"][0][net], ref["grads"][0][net], cfg.lr,
                DP_STEPS)[0]), 1.0))
    for what, value, bar in checks:
        say(f"[{tag}] {label}, {what}: {value:.3e} (<= {bar:.3e})")
    if rec["pool_counts"] != ref["pool_counts"]:
        checks.append(("pool counts", rec["pool_counts"], ref["pool_counts"]))
        return checks[-1:]
    return [c for c in checks if not c[1] <= c[2]]


def fault_check(tag: str, cfg, batch: dict, world: int, single: dict,
                bars: dict, dev: torch.device, card: str) -> list:
    """The fault the gradient bars are for, rank 0's own slice of the
    batch alone (the all-reduce left out), against one process: it must
    exceed each net's bar. Returns the (what, value, bar) that did not."""
    from animateportrait_tpu_torch.utils.smoke import dp_step_run, grad_parity

    half = dp_step_run(cfg, {k: v[:TRAIN_BATCH // world]
                             for k, v in batch.items()}, 1, dev)
    failed = []
    for net in ("g", "d"):
        errs = grad_parity(half["grads"][0][net], single["grads"][0][net],
                           None, _noise(cfg, net))
        say(f"[{tag}] step 1 {net.upper()} gradients of rank 0's "
            f"{TRAIN_BATCH // world} of {TRAIN_BATCH} alone (the fault) "
            f"against one process: worst {max(errs.values()):.3e} (> "
            f"{bars[net]:.3e}; {card})")
        if not max(errs.values()) > bars[net]:
            failed.append((f"step 1 {net.upper()} gradients of the fault",
                           max(errs.values()), bars[net]))
    return failed


def check_ranks(tag: str, ranks: list, card: str, what: str) -> None:
    """Each rank's record: K2 and K2b launched, K2 against its plain
    version on the rank's InstanceNorm inputs; printed with its ms a step
    and the bytes of its collectives."""
    for r, rec in enumerate(ranks):
        extra = ""
        if "fsdp_bytes" in rec:
            extra = (f", {rec['reduce_scatter_bytes'] / 2 ** 20:.1f} MiB "
                     f"reduce-scattered and all-gathered a step")
        say(f"[{tag}] {what} rank {r} ({rec['device']}, "
            f"{rec['backend']}): ms a step "
            f"{', '.join(f'{t:.1f}' for t in rec['ms'])}, "
            f"{rec['allreduce_bytes'] / 2 ** 20:.1f} MiB all-reduced a "
            f"step{extra}, launches {rec['launches']}, K2 vs plain on its "
            f"InstanceNorm inputs {rec['k2_err']:.2e} ({card}; smoke "
            f"figures)")
        if min(rec["launches"].values()) <= 0:
            raise AssertionError(f"{what} rank {r}: a kernel never "
                                 f"launched: {rec['launches']}")
        if rec["k2_err"] > K2_ATOL:
            raise AssertionError(f"{what} rank {r}: K2 vs plain "
                                 f"{rec['k2_err']}")


def phase16_dp_step(dev: torch.device, card: str) -> dict:
    """(a) phase 7's step on a global batch of 4 over 2 ranks on this card
    (gloo), against the single-process step on the same batch."""
    from animateportrait_tpu_torch.utils.smoke import dp_step_rank

    ref = dp_reference(dev)
    cfg, batch, single, bars = (ref[k] for k in ("cfg", "batch", "single",
                                                 "bars"))
    ranks, wall = spawned(dp_step_rank, [dev] * DP_RANKS, cfg, batch,
                          DP_STEPS)
    for rec in ranks:
        rec["device"] = str(dev)
    check_ranks("16", ranks, card, f"DP step (batch {TRAIN_BATCH // DP_RANKS}"
                f" of {TRAIN_BATCH})")
    say(f"[16] the 2 ranks took {wall:.1f} s of wall time, their start "
        f"included")
    dp = ranks[0]
    failed = check_against("16", "2 ranks vs one process", dp, single, bars,
                           cfg)
    same = all(torch.equal(p, q) for p, q in zip(ranks[0]["params"][-1]["g"]
                                                  .values(),
                                                  ranks[1]["params"][-1]["g"]
                                                  .values()))
    say(f"[16] pool counts {dp['pool_counts']} (one process "
        f"{single['pool_counts']}); the ranks' G bit-equal: {same}")
    failed += fault_check("16", cfg, batch, DP_RANKS, single, bars, dev, card)
    if failed or not same:
        raise AssertionError(f"DP step: {failed}, ranks equal {same}")
    return dict(ref, launches={f"dp_step_rank{r}": rec["launches"]
                               for r, rec in enumerate(ranks)},
                k2_err=max(rec["k2_err"] for rec in ranks))


def dp_inputs() -> tuple:
    """Phase 7's step (fp32, batch 4) and a seeded random global batch
    (numpy), the step of phase 16 (a) and phase 17 (a, b)."""
    from animateportrait_tpu_torch.train import module2 as m2

    cfg = m2.Module2Config(batch_d_passes=True)
    return cfg, {k: v.numpy() for k, v in m2.make_random_batch(
        cfg, TRAIN_BATCH, torch.Generator().manual_seed(2), "cpu").items()}


def dp_reference(dev: torch.device) -> dict:
    """``dp_inputs``' step in one process, with its own spread and the bars
    it sets (``spread_bars``): the reference of phase 16 (a)."""
    cfg, batch = dp_inputs()
    single, others = one_process_runs(cfg, batch, dev)
    say(f"[16] single process, batch {TRAIN_BATCH}: ms a step "
        f"{', '.join(f'{t:.1f}' for t in single['ms'])}")
    return {"cfg": cfg, "batch": batch, "single": single,
            "bars": spread_bars(cfg, single, others, "16")}


def phase16_multihost(dev: torch.device, tree: str, tmp: str) -> dict:
    """(b) ``train_cli.main --multihost 1`` as one process (NCCL at world
    size 1) over phase 8's tree, 2 steps."""
    from animateportrait_tpu_torch import train_cli
    from animateportrait_tpu_torch.io.checkpoint import CheckpointManager
    from animateportrait_tpu_torch.utils.distributed import free_port

    ck = os.path.join(tmp, "ck_mh")
    argv = ["--dataroot", tree, *README_DRAWING, "--crop_size", "256",
            "--load_size", "286", "--ngf", "64", "--ndf", "64",
            "--batch_size", str(TRAIN_BATCH), "--num_threads", "8",
            "--print_freq", "1", "--max_steps", "2", "--checkpoints_dir", ck,
            "--frozen_dir", os.path.join(tmp, "frozen"), "--multihost", "1",
            "--num_processes", "1", "--process_id", "0",
            "--coordinator_address", f"127.0.0.1:{free_port()}"]
    zero_counters()
    t0 = time.perf_counter()
    run = train_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    exp = os.path.join(ck, "training", "drawing1")
    with open(os.path.join(exp, "loss_log.txt")) as f:
        log = f.read()
    steps = CheckpointManager(os.path.join(exp, "checkpoints")).all_steps()
    say(f"[16] train_cli.main --multihost 1 --num_processes 1 (NCCL) over "
        f"phase 8's tree: 2 steps in {wall:.1f} s of wall time; "
        f"{log.count('(epoch')} loss lines, checkpoint steps {steps}, "
        f"launches {launches}")
    if not (log.count("Training Loss") == 1 and log.count("(epoch") == 2
            and steps == [2] and run.state.step == 2
            and sorted(os.listdir(ck)) == ["training"]):
        raise AssertionError(f"multihost trainer: log {log!r}, steps {steps}")
    if min(launches["instance_norm"], launches["instance_norm_backward"]) \
            <= 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    return {"launches": launches}


def render_cli(tmp: str, out: str, flags: list) -> tuple:
    """``cli.main --exp formal/cartoon --frame_batch 8`` on a synthetic
    PPM and a 6 s WAV (seeded; written into ``tmp`` once) with ``flags``,
    under cuDNN's deterministic algorithms: (its ``RunResult``, its frames
    as int16)."""
    from animateportrait_tpu_torch import cli
    from animateportrait_tpu_torch.utils.smoke import (
        make_wav, write_mtcnn_weights)
    from animateportrait_tpu_torch.utils.video import read_avi, write_wav

    photo, wav_path = (os.path.join(tmp, "portrait.ppm"),
                       os.path.join(tmp, "speech.wav"))
    ckpt = os.path.join(tmp, "ckpt")
    if not os.path.exists(photo):
        write_photo(photo)
        write_wav(wav_path, make_wav(6.0, seed=3))
        write_mtcnn_weights(os.path.join(ckpt, "mtcnn"), seed=0)
    torch.backends.cudnn.deterministic = True
    try:
        res = cli.main(["--jpg", photo, "--audio", wav_path, "--exp",
                        "formal/cartoon", "--frame_batch", "8", "--ckpt_dir",
                        ckpt, *flags, "--output", os.path.join(tmp, out)])
    finally:
        torch.backends.cudnn.deterministic = False
    return res, read_avi(res.path)["frames"].astype(np.int16)


def phase16_render(dev: torch.device, main_run: dict) -> dict:
    """(c) ``cli.main --render_dp`` on one card against the same call
    without it, and two renderer replicas on this card on phase 3's
    inputs."""
    from animateportrait_tpu_torch.utils.smoke import (
        build_pipeline, full_width_nets, make_wav)

    # without the flag, again without it, and with it where this machine
    # has one card (with more, the flag takes every card: phase 17 (d));
    # cuDNN's default algorithms are not bit-repeatable on the card (1
    # level at ~2500 values between two calls), its deterministic ones are
    one_card = torch.cuda.device_count() == 1
    with tempfile.TemporaryDirectory() as tmp:
        frames, cli_launches, render_s = [], [], []
        for i, flag in enumerate(([], [], ["--render_dp"])[:3 if one_card
                                                            else 2]):
            zero_counters()
            res, f = render_cli(tmp, f"out{i}", flag)
            cli_launches.append(read_counters())
            frames.append(f)
            render_s.append(res.stage_seconds["render"])

    def diff(a, b):
        return int(np.abs(a - b).max()), int(np.count_nonzero(a != b))

    # one card is one replica, the path without the flag: the same
    # launches and the same frames
    again = diff(frames[1], frames[0])
    dp = diff(frames[2], frames[0]) if one_card else again
    say(f"[16] cli.main on one card, cuDNN's deterministic algorithms: "
        f"{frames[0].shape[0]} frames; a second run max |diff| {again[0]} "
        f"levels at {again[1]} of {frames[0].size} values; "
        + (f"--render_dp (one replica): {dp[0]} levels at {dp[1]}; launches "
           f"{cli_launches[2]} (without the flag {cli_launches[0]})"
           if one_card else "--render_dp takes every card here: phase 17 "
           "(d)"))
    if not (dp == again == (0, 0) and cli_launches[-1] == cli_launches[0]
            and min(cli_launches[-1]["stft_magnitude"],
                    cli_launches[-1]["instance_norm"]) > 0):
        raise AssertionError(f"--render_dp on one card: {dp} against the "
                             f"CLI's own {again}, launches "
                             f"{cli_launches}")

    nets = full_width_nets(seed=0)
    pipe = build_pipeline(nets, dev, frame_batch=8, output_uint8=True,
                          data_parallel=True, devices=[dev, dev])
    photo = np.random.default_rng(0).uniform(0, 255, (512, 512, 3)).astype(
        np.uint8)
    second = pipe.renderer.replicas[1][0]
    kept, hooks = keep_instance_norm_inputs({"replica1": second})
    with torch.inference_mode():
        pipe(photo, make_wav(6.0, seed=1))
        torch.cuda.synchronize()
        for h in hooks:
            h.remove()
        zero_counters()
        t0 = time.perf_counter()
        out = pipe(photo, make_wav(6.0, seed=2))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = read_counters()
    T = out.frames.shape[0]
    diff = int(np.abs(out.frames.astype(np.int16)
                      - main_run["frames"].astype(np.int16)).max())
    p = psnr(out.frames, main_run["frames"], peak=255.0)
    say(f"[16] 2 renderer replicas on one card, phase 3's inputs: {T} "
        f"frames in {dt:.3f} s = {T / dt:.2f} frames/s (phase 3, one "
        f"replica: {main_run['frames_per_s']:.2f}; smoke figures); vs phase "
        f"3's frames max |diff| {diff} levels, PSNR {p:.2f} dB (>= "
        f"{RENDER_DP_MIN_PSNR}); launches {launches}")
    if not (out.frames.shape == main_run["frames"].shape
            and p >= RENDER_DP_MIN_PSNR and second is not pipe.renderer.g
            and len(pipe.renderer.replicas) == 2):
        raise AssertionError(f"2 replicas: PSNR {p}, {out.frames.shape}")
    if min(launches["stft_magnitude"], launches["instance_norm"]) <= 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    return {"launches": {"render_dp_cli" if one_card else "cartoon_cli_16":
                         cli_launches[-1], "render_dp_replicas": launches},
            "k2_err": k2_on_path(kept, "16"), "frames": frames[0],
            "render_s": render_s[0]}


def phase16_gpipe(dev: torch.device, card: str) -> dict:
    """(d) the generator's 9-block bottleneck at full width (256 channels
    at 64^2, batch 6) as a 3-stage GPipe on this card (gloo), M = 3 and 6,
    against the 9 blocks in sequence."""
    from animateportrait_tpu_torch.models.gan import ResnetBlock
    from animateportrait_tpu_torch.parallel import seq_apply
    from animateportrait_tpu_torch.utils.smoke import (
        gpipe_run, jobs_rank, resnet_blocks)

    blocks = resnet_blocks(256, 9, seed=5)
    x = np.random.default_rng(6).standard_normal(
        (6, 256, 64, 64)).astype(np.float32)
    ms = GPIPE_MS
    ranks, wall = spawned(jobs_rank, [dev] * GPIPE_STAGES,
                          {"gpipe": (gpipe_run, (blocks, x, ms))})
    ranks = [rec["gpipe"] for rec in ranks]
    mods = []
    for sd in blocks:
        b = ResnetBlock(x.shape[1])
        b.load_state_dict(sd)
        mods.append(b.to(dev).eval())
    xt = torch.as_tensor(x, device=dev)
    worst = 0.0
    for m in ms:
        # the same microbatch shapes as the pipeline's, so cuDNN takes the
        # same algorithms; and the whole batch at once, printed
        want = torch.cat([seq_apply(mods, c) for c in xt.chunk(m)]).cpu()
        whole = seq_apply(mods, xt).cpu()
        errs = [float((rec["y"][m] - want).abs().max()) for rec in ranks]
        worst = max(worst, *errs)
        ms_by_rank = ", ".join(f"{rec['ms'][m]:.1f}" for rec in ranks)
        say(f"[16] GPipe, 3 stages x 3 blocks, M = {m}: max |pipe - "
            f"sequence| by rank {', '.join(f'{e:.2e}' for e in errs)} "
            f"(rtol = atol = 2e-5); the whole batch in sequence "
            f"{float((ranks[-1]['y'][m] - whole).abs().max()):.2e} off; "
            f"ms a call by rank {ms_by_rank}; K2 launches by rank "
            f"{[rec['launches'][m] for rec in ranks]} ({card}; smoke "
            f"figures)")
        for r, rec in enumerate(ranks):
            if not torch.allclose(rec["y"][m], want, **GPIPE_TOL):
                raise AssertionError(f"GPipe M={m} rank {r}: {errs[r]}")
    for r, rec in enumerate(ranks):
        want = {m: 3 * 2 * m for m in ms}
        if rec["launches"] != want or rec["k2_err"] > K2_ATOL or \
                "not divisible" not in (rec["indivisible"] or ""):
            raise AssertionError(f"GPipe rank {r}: launches "
                                 f"{rec['launches']} (want {want}), K2 "
                                 f"{rec['k2_err']}, {rec['indivisible']}")
    say(f"[16] GPipe ranks ran over {ranks[0]['backend']} in {wall:.1f} s "
        f"of wall time, their start included; an indivisible batch raised "
        f"{ranks[0]['indivisible']!r}")
    return {"launches": {f"gpipe_rank{r}": {"instance_norm": sum(
        rec["launches"].values())} for r, rec in enumerate(ranks)},
        "k2_err": max(rec["k2_err"] for rec in ranks),
        "ms": [max(rec["ms"][m] for rec in ranks) for m in ms]}


def phase16(dev: torch.device, card: str, main_run: dict, tmp: str,
            tree: str) -> dict:
    t0 = time.perf_counter()
    out = {"dp": phase16_dp_step(dev, card)}
    out["multihost"] = phase16_multihost(dev, tree, tmp)
    out["render"] = phase16_render(dev, main_run)
    out["gpipe"] = phase16_gpipe(dev, card)
    say(f"[16] phase 16 in {time.perf_counter() - t0:.1f} s")
    return out


# --- phase 17: the multi-card paths, one rank a card ----------------------

P17_MAX_WORLD = 4
TP_GRID_MODEL = 2           # the model axis of the TP grid (JAX's)
TP_FRAMES = 8               # the renderer's frame batch
TP_G = dict(output_nc=1, ngf=64, n_blocks=9, div=3, disp=3)
SP_T = 512                  # one segment of the pos branch


def phase17_spawn(devices: list) -> tuple[dict, dict, float]:
    """(a, b), (e), (f) and (g) in one spawn of a rank a card over NCCL
    (``utils/smoke.py:jobs_rank``): (each part's records by rank, each
    part's inputs, the spawn's wall seconds, the ranks' start included).
    """
    from animateportrait_tpu_torch.models.audio2landmark import (
        Audio2landmarkPos)
    from animateportrait_tpu_torch.models.gan import TridentGeneratorFullIFW
    from animateportrait_tpu_torch.multichip import (
        gain_attention, generator_inputs, pos_inputs, sp_run, tp_run)
    from animateportrait_tpu_torch.utils.smoke import (
        fsdp_steps, gpipe_run, init_random_, jobs_rank, resnet_blocks)

    n = len(devices)
    stages = min(GPIPE_STAGES, n)
    inputs = {
        "gpipe": (resnet_blocks(256, 3 * stages, seed=5),
                  np.random.default_rng(6).standard_normal(
                      (6, 256, 64, 64)).astype(np.float32)),
        "tp": (init_random_(TridentGeneratorFullIFW(**TP_G),
                            torch.Generator().manual_seed(7)).state_dict(),
               generator_inputs(np.random.default_rng(8), TP_FRAMES, 256)),
        "sp": (gain_attention(init_random_(
            Audio2landmarkPos(), torch.Generator().manual_seed(9))
            .state_dict()), pos_inputs(np.random.default_rng(10), SP_T))}
    jobs = {"steps": (fsdp_steps, (*dp_inputs(), DP_STEPS, 2 ** 16)),
            "gpipe": (gpipe_run, (*inputs["gpipe"], GPIPE_MS, stages)),
            "tp": (tp_run, ((n // TP_GRID_MODEL, TP_GRID_MODEL), TP_G,
                            *inputs["tp"])),
            "sp": (sp_run, inputs["sp"])}
    ranks, wall = spawned(jobs_rank, devices, jobs)
    return {name: [rec[name] for rec in ranks] for name in jobs}, inputs, wall


def phase17_steps(ranks: list, devices: list, card: str) -> dict:
    """(a) phase 7's step at global batch 4 over one rank a card (NCCL)
    against one process running the ranks' step (each rank's slice alone,
    at the rank's batch: ``utils/smoke.py:decomposed_grads``), at phase
    16 (a)'s rule: 3x that process's own spread, and the fault, rank 0's
    slice alone, beyond each gradient bar; (b) the same step
    FSDP-sharded against (a)'s ranks at the same bars."""
    cfg, batch = dp_inputs()
    n = len(devices)
    single, others = one_process_runs(cfg, batch, devices[0], decompose=n)
    bars = spread_bars(cfg, single, others, "17")
    n = len(devices)
    dp = [r["dp"] for r in ranks]
    fs = [r["fsdp"] for r in ranks]
    for rec, d in zip(ranks, devices):
        rec["dp"]["device"] = rec["fsdp"]["device"] = str(d)
        rec["dp"]["backend"] = rec["fsdp"]["backend"] = rec["backend"]
        if rec["backend"] != "nccl":
            raise AssertionError(f"rank on {d}: {rec['backend']}")
    check_ranks("17", dp, card, f"(a) DP step ({TRAIN_BATCH // n} of "
                f"{TRAIN_BATCH})")
    check_ranks("17", fs, card, f"(b) FSDP step ({TRAIN_BATCH // n} of "
                f"{TRAIN_BATCH})")
    say(f"[17] (a, b) one process running the {n} ranks' step: ms a step "
        f"{', '.join(f'{t:.1f}' for t in single['ms'])}")
    failed = check_against("17", f"(a) {n} ranks vs one process", dp[0],
                           single, bars, cfg)
    failed += fault_check("17", cfg, batch, n, single, bars, devices[0],
                          card)
    failed += check_against("17", f"(b) FSDP vs DP, {n} ranks", fs[0], dp[0],
                            bars, cfg)

    def ranks_equal(run):
        last = run[0]["params"][-1]
        return all(torch.equal(v, last[net][k]) for rec in run[1:]
                   for net in ("g", "d")
                   for k, v in rec["params"][-1][net].items())

    same = [ranks_equal(dp), ranks_equal(fs)]
    for r, (a, b) in enumerate(zip(dp, fs)):
        by = b["fsdp_bytes"]
        say(f"[17] (b) rank {r}: parameters + Adam moments "
            f"{(by['sharded'] + by['replicated']) / 2 ** 20:.2f} MiB "
            f"sharded ({by['sharded'] / 2 ** 20:.2f} MiB of sharded leaves, "
            f"unsharded {by['unsharded'] / 2 ** 20:.2f} MiB), DP "
            f"{(by['unsharded'] + by['replicated']) / 2 ** 20:.2f} MiB; "
            f"peak memory in the first step FSDP "
            f"{b['peak_bytes'] / 2 ** 30:.3f} GiB, DP "
            f"{a['peak_bytes'] / 2 ** 30:.3f} GiB ({card})")
        if by["sharded"] * n != by["unsharded"]:
            raise AssertionError(f"rank {r}: {by}")
    say(f"[17] the ranks' parameters bit-equal after {DP_STEPS} steps "
        f"(DP, FSDP): {same}")
    if failed or not all(same):
        raise AssertionError(f"(a, b): {failed}, ranks equal {same}")
    return {"launches": {
        **{f"dp_step_nccl_rank{r}": rec["launches"]
           for r, rec in enumerate(dp)},
        **{f"fsdp_step_nccl_rank{r}": rec["launches"]
           for r, rec in enumerate(fs)}},
        "k2_err": max(rec["k2_err"] for rec in dp + fs)}


def trainer_records(ck: str, name: str) -> list:
    with open(os.path.join(ck, *name.split("/"), "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def phase17_trainer(n: int, tree: str, tmp: str, card: str) -> dict:
    """(c) ``train_cli.main --data_parallel n`` and ``--multihost`` as n
    processes (``LOCAL_RANK`` picks each one's card), 2 steps each at the
    readme's drawing command over phase 8's tree, against one process on
    the same global batches, in this process. The ranks' step emulated in
    one process (``utils/smoke.py:decomposed_grads``: each rank's slice
    alone, at the rank's batch) is the reference of both steps: each
    step's losses within the larger of ``DP_LOSS_RTOL`` and 3x its own
    spread (called again, and under cuDNN's deterministic algorithms),
    and the fault, the first rank's share alone, beyond that bar. The
    step at the whole batch in one process is printed beside: at the
    second step Adam's first update has turned the rounding of a rank's
    convs against the whole batch's into steps of lr."""
    import subprocess
    import sys

    from animateportrait_tpu_torch import train_cli
    from animateportrait_tpu_torch.data.umlvd_ifw import (
        UMLVDIFWDataset, loader)
    from animateportrait_tpu_torch.io.reference import load_frozen
    from animateportrait_tpu_torch.train import module2 as m2
    from animateportrait_tpu_torch.utils.distributed import free_port
    from animateportrait_tpu_torch.utils.options import to_configs
    from animateportrait_tpu_torch.utils.smoke import decomposed_grads

    base = ["--dataroot", tree, *README_DRAWING, "--crop_size", "256",
            "--load_size", "286", "--ngf", "64", "--ndf", "64",
            "--batch_size", str(TRAIN_BATCH), "--num_threads", "4",
            "--print_freq", "1", "--max_steps", "2",
            "--frozen_dir", os.path.join(tmp, "frozen")]
    name = "training/drawing1"
    runs, walls = {}, {}
    ck = os.path.join(tmp, "ck17_dp")
    t0 = time.perf_counter()
    train_cli.main([*base, "--data_parallel", str(n), "--checkpoints_dir",
                    ck])
    walls["dp"] = time.perf_counter() - t0
    runs["dp"] = trainer_records(ck, name)
    # --multihost: one process per card, each loading its own slice
    ck = os.path.join(tmp, "ck17_mh")
    argv = [*base, "--checkpoints_dir", ck, "--multihost", "1",
            "--num_processes", str(n), "--coordinator_address",
            f"127.0.0.1:{free_port()}"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "animateportrait_tpu_torch.train_cli", *argv,
         "--process_id", str(i)], env=dict(os.environ, LOCAL_RANK=str(i)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    walls["multihost"] = time.perf_counter() - t0
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"--multihost process {i}:\n{out[-3000:]}")
    runs["multihost"] = trainer_records(ck, name)
    if f"{n} ranks over nccl" not in outs[0]:
        raise AssertionError(f"--multihost: {outs[0][-2000:]}")

    # one process on the global batches each mode loads: --data_parallel's
    # rank 0 loads them from default_rng(0), each --multihost process its
    # slice from default_rng(process id)
    args = train_cli.build_argparser().parse_args(argv + ["--process_id",
                                                          "0"])
    cfg, data_cfg = to_configs(args)
    ds = UMLVDIFWDataset(data_cfg)
    dev = torch.device("cuda", 0)
    per = -(-max(TRAIN_BATCH, n) // n)       # train_cli's slice a rank
    streams = {"dp": [loader(ds, per * n, np.random.default_rng(0), 0,
                             False)],
               "multihost": [loader(ds, per, np.random.default_rng(i), 0,
                                    False) for i in range(n)]}
    frozen = load_frozen(args.frozen_dir, cfg,
                         torch.Generator().manual_seed(1), dev)
    step = m2.build_train_step(cfg)

    def steps(batches, fn):
        """The losses of ``fn(state, batch, gen)`` from the trainer's
        initial state over ``batches``, the pool drawn as train_cli draws
        it."""
        state = m2.init_state(cfg, torch.Generator().manual_seed(0), dev)
        return [{k: float(v) for k, v in fn(
            state, {k: v.to(dev) for k, v in b.items()},
            torch.Generator(device=dev).manual_seed(i)).items()}
            for i, b in enumerate(batches)]

    def whole(state, b, gen):
        return step.step(state, b, frozen, gen)

    def ranks(state, b, gen):
        grads = decomposed_grads(step, state, b, frozen, gen, n)
        step.apply_grads(state, grads)
        return grads.metrics

    def alone(state, b, gen):
        return step.step(state, {k: v[:per] for k, v in b.items()}, frozen,
                         gen)

    def worst(run, ref):
        """Each step's largest relative loss difference, and its loss."""
        out = []
        for got, want in zip(run, ref):
            d = {k: abs(got[k] - v) / max(abs(v), 1e-5)
                 for k, v in want.items()}
            k = max(d, key=d.get)
            out.append((d[k], k))
        return out

    failed = []
    for mode, what in (("dp", "--data_parallel"), ("multihost",
                                                   "--multihost")):
        its = [iter(s) for s in streams[mode]]
        batches = []
        for _ in range(2):
            parts = [next(it) for it in its]
            batches.append({k: torch.cat([p[k] for p in parts])
                            for k in parts[0]})
        ref = steps(batches, ranks)
        others = [steps(batches, ranks)]
        torch.backends.cudnn.deterministic = True
        try:
            others.append(steps(batches, ranks))
        finally:
            torch.backends.cudnn.deterministic = False
        spread = [max(w[s][0] for w in (worst(o, ref) for o in others))
                  for s in range(2)]
        fault = worst(steps(batches, alone), ref)
        got = worst(runs[mode], ref)
        at_once = worst(runs[mode], steps(batches, whole))
        for s_ in range(2):
            bar = max(DP_LOSS_RTOL, 3 * spread[s_])
            say(f"[17] (c) train_cli {what} {n}, losses step {s_ + 1}: "
                f"against the ranks' step in one process {got[s_][0]:.3e} "
                f"({got[s_][1]}) (<= {bar:.3e}: 3x that process's own "
                f"{spread[s_]:.3e}), the first rank's share alone (the "
                f"fault) {fault[s_][0]:.3e} ({fault[s_][1]}) (> the bar); "
                f"against one process at the whole batch {at_once[s_][0]:.3e}"
                f" ({at_once[s_][1]}) (printed)")
            if not got[s_][0] <= bar < fault[s_][0]:
                failed.append((what, s_ + 1, got[s_][0], bar, fault[s_][0]))
    say(f"[17] (c) wall s with the start: --data_parallel {n} "
        f"{walls['dp']:.1f}, --multihost x {n} {walls['multihost']:.1f} "
        f"({card}; smoke figures)")
    if failed:
        raise AssertionError(f"(c) trainer losses (mode, step, reading, "
                             f"bar, fault): {failed}")
    return {}


def phase17_render(n: int, card: str, one_card: dict) -> dict:
    """(d) ``cli.main --render_dp`` with a replica on each of the n cards,
    at a frame batch of 8 a replica, against phase 16's run on one card:
    bit-equal frames under cuDNN's deterministic algorithms; frames/s of
    the render stage beside one replica's."""
    with tempfile.TemporaryDirectory() as tmp:
        zero_counters()
        res, frames = render_cli(tmp, "out", ["--render_dp", "--frame_batch",
                                              str(8 * n)])
        launches = read_counters()
    T = frames.shape[0]
    d = np.abs(frames - one_card["frames"])
    say(f"[17] (d) cli.main --render_dp, {n} replicas on {n} cards, 8 "
        f"frames a replica: render stage {T / res.stage_seconds['render']:.2f}"
        f" frames/s (one replica, phase 16: "
        f"{T / one_card['render_s']:.2f}); against one card max |diff| "
        f"{int(d.max())} levels at {int(np.count_nonzero(d))} of {d.size} "
        f"values; launches {launches} ({card}; smoke figures)")
    if frames.shape != one_card["frames"].shape or d.max() != 0:
        raise AssertionError("--render_dp on n cards is not bit-equal to "
                             "one card")
    if min(launches["stft_magnitude"], launches["instance_norm"]) <= 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    return {"launches": {"render_dp_cli_cards": launches}}


def phase17_gpipe(ranks: list, inputs: tuple, devices: list, card: str,
                  gloo_ms: list | None) -> dict:
    """(e) GPipe of the 9-block bottleneck, 3 stages on 3 cards over NCCL
    (no host staging), bit-equal to the blocks in sequence on the same
    microbatches; printed beside phase 16 (d)'s ms over gloo where it
    ran."""
    from animateportrait_tpu_torch.models.gan import ResnetBlock
    from animateportrait_tpu_torch.parallel import seq_apply

    ranks = [r for r in ranks if r is not None]
    stages = len(ranks)
    blocks, x = inputs
    mods = []
    for sd in blocks:
        b = ResnetBlock(x.shape[1])
        b.load_state_dict(sd)
        mods.append(b.to(devices[0]).eval())
    xt = torch.as_tensor(x, device=devices[0])
    for m in GPIPE_MS:
        want = torch.cat([seq_apply(mods, c) for c in xt.chunk(m)]).cpu()
        errs = [float((rec["y"][m] - want).abs().max()) for rec in ranks]
        say(f"[17] (e) GPipe, {stages} stages on {stages} cards "
            f"({ranks[0]['backend']}), M = {m}: max |pipe - sequence| by "
            f"rank {', '.join(f'{e:.2e}' for e in errs)} (bit-equal); ms "
            f"a call by rank {', '.join(f'{r['ms'][m]:.1f}' for r in ranks)}"
            + (f" (gloo on one card, phase 16: "
               f"{gloo_ms[GPIPE_MS.index(m)]:.1f})" if gloo_ms else "")
            + f"; K2 launches by rank "
            f"{[r['launches'][m] for r in ranks]} ({card}; smoke figures)")
        if max(errs) != 0.0:
            raise AssertionError(f"GPipe M={m} over NCCL: {errs}")
    for r, rec in enumerate(ranks):
        want = {m: 3 * 2 * m for m in GPIPE_MS}
        if rec["backend"] != "nccl" or rec["launches"] != want or \
                rec["k2_err"] > K2_ATOL:
            raise AssertionError(f"GPipe rank {r}: {rec['backend']}, "
                                 f"launches {rec['launches']}, K2 "
                                 f"{rec['k2_err']}")
    return {"launches": {f"gpipe_nccl_rank{r}": {"instance_norm": sum(
        rec["launches"].values())} for r, rec in enumerate(ranks)},
        "k2_err": max(rec["k2_err"] for rec in ranks)}


def phase17_tp(ranks: list, inputs: tuple, dev: torch.device, card: str
               ) -> dict:
    """(f) the full-width trident generator (ngf 64, 9 blocks) on 8 frames
    at 256^2, tensor-parallel on a (n/2, 2) grid of cards, against one
    card."""
    from animateportrait_tpu_torch.models.gan import TridentGeneratorFullIFW
    from animateportrait_tpu_torch.multichip import TP_ATOL

    state_dict, frames = inputs
    g = TridentGeneratorFullIFW(**TP_G)
    g.load_state_dict(state_dict)
    g = g.to(dev).eval()
    args = [torch.as_tensor(a, device=dev) for a in frames]
    with torch.inference_mode():
        g(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = g(*args)
        torch.cuda.synchronize()
        one_ms = 1e3 * (time.perf_counter() - t0)
    want = want.cpu()
    errs = [float((r["y"] - want).abs().max()) for r in ranks]
    say(f"[17] (f) TP generator, grid ({len(ranks) // TP_GRID_MODEL}, "
        f"{TP_GRID_MODEL}) over {ranks[0]['backend']}, {ranks[0]['sliced']} "
        f"convs sliced, {TP_FRAMES} frames at 256^2: max |TP - one card| by "
        f"rank {', '.join(f'{e:.2e}' for e in errs)} (<= {TP_ATOL}); ms a "
        f"call by rank {', '.join(f'{r['ms']:.1f}' for r in ranks)}, one "
        f"card {one_ms:.1f}; K2 by rank "
        f"{[r['launches']['instance_norm'] for r in ranks]}, K2 vs plain "
        f"{max(r['k2_err'] for r in ranks):.2e} ({card}; smoke figures)")
    for r, rec in enumerate(ranks):
        if not (errs[r] <= TP_ATOL and rec["backend"] == "nccl"
                and rec["launches"]["instance_norm"] > 0
                and rec["k2_err"] <= K2_ATOL):
            raise AssertionError(f"TP rank {r}: {errs[r]}, {rec['backend']},"
                                 f" {rec['launches']}, {rec['k2_err']}")
    return {"launches": {f"tp_generator_rank{r}": rec["launches"]
                         for r, rec in enumerate(ranks)},
            "k2_err": max(rec["k2_err"] for rec in ranks)}


def phase17_sp(ranks: list, inputs: tuple, dev: torch.device, card: str
               ) -> dict:
    """(g) the full-width pos branch on one 512-frame segment,
    sequence-parallel over the cards, against one card, with the
    attention's output projections scaled (``multichip.gain_attention``)
    so that the first rank's frames as a sequence of their own miss the
    bar, which is held too."""
    from animateportrait_tpu_torch.models.audio2landmark import (
        Audio2landmarkPos)
    from animateportrait_tpu_torch.multichip import (
        ATTN_GAIN, SP_ATOL, first_rank_alone)

    state_dict, segment = inputs
    n = len(ranks)
    pos = Audio2landmarkPos()
    pos.load_state_dict(state_dict)
    pos = pos.to(dev).eval()
    args = [torch.as_tensor(a, device=dev) for a in segment]
    with torch.inference_mode():
        pos(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = pos(*args)[0]
        torch.cuda.synchronize()
        one_ms = 1e3 * (time.perf_counter() - t0)
        alone = first_rank_alone(pos, args, n)
    alone = float((alone - want[:alone.shape[0]]).abs().max())
    want = want.cpu()
    errs = [float((r["y"] - want).abs().max()) for r in ranks]
    say(f"[17] (g) SP pos, T = {SP_T} over {n} cards "
        f"({ranks[0]['backend']}), attention outputs x {ATTN_GAIN}: max |SP "
        f"- one card| by rank {', '.join(f'{e:.2e}' for e in errs)} (<= "
        f"{SP_ATOL}); the first rank's {SP_T // n} frames as a sequence of "
        f"their own (the fault) {alone:.2e} (> {SP_ATOL}); ms a call by "
        f"rank {', '.join(f'{r['ms']:.1f}' for r in ranks)}, one card "
        f"{one_ms:.1f} ({card}; smoke figures)")
    if not (max(errs) <= SP_ATOL < alone) or ranks[0]["backend"] != "nccl":
        raise AssertionError(f"SP: {errs}, the fault {alone}, "
                             f"{ranks[0]['backend']}")
    return {}


def phase17_dryrun(n: int, card: str) -> dict:
    """(h) ``dryrun_multichip(n)``: one card a rank where there are n."""
    from animateportrait_tpu_torch.multichip import dryrun_multichip

    t0 = time.perf_counter()
    recs = dryrun_multichip(n)
    wall = time.perf_counter() - t0
    for r, rec in enumerate(recs):
        st = rec["step"]
        say(f"[17] (h) dryrun_multichip({n}) rank {r} ({rec['device']}, "
            f"{rec['backend']}): step ms {st['ms']:.1f}, launches "
            f"{st['launches']}, K2 vs plain {st['k2_err']:.2e}, bytes "
            f"{st['bytes']}; TP {rec.get('tp', {}).get('err', 'n/a')}, SP "
            f"{rec['sp']['err']:.2e} (first rank alone "
            f"{rec['sp']['alone']:.2e}), GPipe {rec['pp']['err']:.2e} "
            f"({card})")
        if min(st["launches"].values()) <= 0 or st["k2_err"] > K2_ATOL:
            raise AssertionError(f"dryrun rank {r}: {st['launches']}, "
                                 f"{st['k2_err']}")
    say(f"[17] (h) dryrun_multichip({n}) in {wall:.1f} s of wall time")
    return {"launches": {f"dryrun_rank{r}": rec["step"]["launches"]
                         for r, rec in enumerate(recs)},
            "k2_err": max(rec["step"]["k2_err"] for rec in recs)}


def phase17(card: str, multi16: dict, tmp: str, tree: str) -> dict:
    """The multi-card paths one rank a card over NCCL, (a)-(h), on an even
    count of up to 4 cards (the TP grid's model axis is 2); each part
    runs, and the phase fails after them if any failed. On one card, the
    dry run over gloo ranks that share it."""
    import traceback

    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    if cards < 2:
        say("[17] one card: the one-rank-a-card parts (a)-(g) need two or "
            "more cards and did not run; dryrun_multichip(2) runs over "
            "gloo ranks that share this card")
        out = {"dryrun": phase17_dryrun(2, card)}
        say(f"[17] phase 17 in {time.perf_counter() - t0:.1f} s")
        return out
    n = min(P17_MAX_WORLD, cards)
    n -= n % TP_GRID_MODEL
    devices = [torch.device("cuda", i) for i in range(n)]
    say(f"[17] {n} ranks, one a card, over NCCL ({cards} cards visible)")
    recs, inputs, wall = phase17_spawn(devices)
    say(f"[17] (a, b, e, f, g) one spawn of {n} ranks in {wall:.1f} s of "
        f"wall time, their start included")
    parts = {
        "steps": lambda: phase17_steps(recs["steps"], devices, card),
        "trainer": lambda: phase17_trainer(n, tree, tmp, card),
        "render": lambda: phase17_render(n, card, multi16["render"]),
        "gpipe": lambda: phase17_gpipe(recs["gpipe"], inputs["gpipe"],
                                       devices, card, multi16.get(
                                           "gpipe", {}).get("ms")),
        "tp": lambda: phase17_tp(recs["tp"], inputs["tp"], devices[0],
                                 card),
        "sp": lambda: phase17_sp(recs["sp"], inputs["sp"], devices[0], card),
        "dryrun": lambda: phase17_dryrun(n, card)}
    out, failed = {}, []
    for name, part in parts.items():
        try:
            out[name] = part()
        except Exception as e:     # the phase fails below, after every part
            traceback.print_exc()
            failed.append(f"{name}: {e!r}"[:2000])
    say(f"[17] phase 17 in {time.perf_counter() - t0:.1f} s")
    if failed:
        raise AssertionError("phase 17: " + "; ".join(failed))
    return out


# --- phase 18: the last functions of the JAX package ----------------------

# phase 18 (c): mel_spectrogram through K1 against its plain version on the
# card and against the host, as phase 4 holds the front end's mel
MEL_ATOL = 2e-3
# phase 18 (d): the frames of phase 3 that go through write_video
VIDEO_FRAMES = 16


def phase18_entry(dev: torch.device) -> dict:
    """(a) ``entry()`` at full width on the card against the same forward
    on the host (PSNR >= 40 dB), K2's launches in one card forward, K2
    against its plain version on the forward's InstanceNorm inputs, and
    ms a forward (CUDA events over 10 forwards after a warm one)."""
    from animateportrait_tpu_torch.entry import entry

    fn, args = entry(dev)
    kept, hooks = keep_instance_norm_inputs({"entry": fn})
    with torch.inference_mode():
        fn(*args)
        for h in hooks:
            h.remove()
        zero_counters()
        y = fn(*args)
        torch.cuda.synchronize()
        launches = read_counters()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(10):
            fn(*args)
        t1.record()
        torch.cuda.synchronize()
        ms = t0.elapsed_time(t1) / 10
        hfn, hargs = entry("cpu")
        want = hfn(*hargs).numpy()
    got = y.cpu().numpy()
    p = psnr(got, want, peak=2.0)
    say(f"[18] (a) entry() on the card: TridentGeneratorFullIFW ngf 64 at "
        f"256^2, {ms:.3f} ms a forward (10 after a warm one), K2 launches "
        f"{launches['instance_norm']} a forward; card vs host PSNR "
        f"{p:.2f} dB (>= 40)")
    if launches["instance_norm"] <= 0:
        raise AssertionError(f"entry() launched no K2: {launches}")
    if not p >= 40.0:
        raise AssertionError(f"entry(): card vs host PSNR {p:.2f} dB < 40")
    return {"launches": launches, "ms": ms, "psnr": p,
            "k2_err": k2_on_path(kept, "18", by_shape_lines=False)}


def phase18_discriminators(dev: torch.device) -> dict:
    """(b) Module1's three discriminators at the reference's widths
    (``TransformerDT`` d_model 64 over 36 windows of 64 frames,
    ``DiscriminatorGRU`` hidden 256 x 3 over 65 windows of 32 pooled
    frames, ``DiscriminatorMLP`` on 100 frames), forward and backward on
    the card against the host, from the same weights and inputs: the
    outputs within 1e-4 of their scale, every parameter's and input's
    gradient by ``grad_parity`` (1e-3) with a float64 host run."""
    from animateportrait_tpu_torch.models import audio2landmark as a2l
    from animateportrait_tpu_torch.utils.smoke import (
        cancelled_biases, grad_parity, init_random_)

    T = 100
    nets = {"mlp": (a2l.DiscriminatorMLP, (204,)),
            "transformer_dt": (a2l.TransformerDT, (204, 128)),
            "gru": (a2l.DiscriminatorGRU, (256, 204))}
    out = {}
    for name, (cls, widths) in nets.items():
        rng = np.random.default_rng(len(name))
        xs = [rng.standard_normal((T, w)) for w in widths]
        runs = []
        for where, dt in ((dev, torch.float32), ("cpu", torch.float32),
                          ("cpu", torch.float64)):
            net = init_random_(cls(), torch.Generator().manual_seed(0))
            net = net.to(device=where, dtype=dt)
            inp = [torch.tensor(x, dtype=dt, device=where,
                                requires_grad=True) for x in xs]
            y = net(*inp)
            names = [k for k, _ in net.named_parameters()]
            grads = torch.autograd.grad(
                y.square().sum(), [p for _, p in net.named_parameters()]
                + inp)
            runs.append((
                y.detach().double().cpu(),
                {k: g.detach().cpu() for k, g in zip(
                    names + [f"input{i}" for i in range(len(inp))], grads)}))
        (yc, gc), (yh, gh), (_, g64) = runs
        out_err = float((yc - yh).abs().max() / yh.abs().max())
        errs = grad_parity(gc, gh, g64, cancelled_biases(cls()))
        worst = max(errs, key=errs.get)
        say(f"[18] (b) {name}: output {tuple(yc.shape)}, card vs host "
            f"{out_err:.2e} of its scale (<= 1e-4); gradients of "
            f"{len(errs)} leaves by grad_parity, worst {errs[worst]:.2e} "
            f"at {worst} (<= 1e-3)")
        if not out_err <= 1e-4 or errs[worst] > 1e-3:
            raise AssertionError(f"[18] {name}: card vs host output "
                                 f"{out_err}, gradient {worst} "
                                 f"{errs[worst]}")
        out[name] = {"out_err": out_err, "grad_err": errs[worst]}
    return out


def phase18_mel(dev: torch.device) -> dict:
    """(c) ``ops/spectral.py:mel_spectrogram`` on phase 3's 6 s WAV (the
    front end's conditioned signal): through K1 on the card (one launch),
    against its plain version on the card (the plain |STFT| and the same
    mel scaling) and against the host, each within ``MEL_ATOL``."""
    from animateportrait_tpu_torch.ops.spectral import (
        mel_scale, mel_spectrogram, stft_magnitude)
    from animateportrait_tpu_torch.pipeline.audio import (
        condition_signal, normalize_dbfs)
    from animateportrait_tpu_torch.utils.smoke import make_wav

    x = torch.as_tensor(condition_signal(normalize_dbfs(make_wav(
        6.0, seed=2))), dtype=torch.float32)
    xc = x.to(dev)
    with torch.inference_mode():
        zero_counters()
        got = mel_spectrogram(xc)
        torch.cuda.synchronize()
        launches = read_counters()
        plain = mel_scale(stft_magnitude(xc))
        host = mel_spectrogram(x)
    e_plain = float((got - plain).abs().max())
    e_host = float((got.cpu() - host).abs().max())
    say(f"[18] (c) mel_spectrogram of the 6 s WAV {tuple(got.shape)}: K1 "
        f"launches {launches['stft_magnitude']}; max|K1 path - plain on the "
        f"card| {e_plain:.3e}, max|card - host| {e_host:.3e} (atol "
        f"{MEL_ATOL})")
    if launches["stft_magnitude"] != 1:
        raise AssertionError(f"mel_spectrogram: K1 launches {launches}")
    if not max(e_plain, e_host) <= MEL_ATOL:
        raise AssertionError(f"mel_spectrogram: plain {e_plain}, host "
                             f"{e_host}")
    return {"launches": launches, "err": max(e_plain, e_host)}


def phase18_video(frames: np.ndarray, tmp: str) -> dict:
    """(d) ``utils/video.py:write_video`` of the first ``VIDEO_FRAMES`` of
    phase 3's frames (gray uint8) and ``read_video_frames`` back: the
    frame count and rate, each frame the decode of its quality-95 JPEG
    (the container loses nothing), and the PSNR against the frames."""
    from animateportrait_tpu_torch.utils.jpeg import (
        decode_mjpeg_frame, encode_jpeg)
    from animateportrait_tpu_torch.utils.video import (
        read_video_frames, write_video)

    clip = frames[:VIDEO_FRAMES]
    t0 = time.perf_counter()
    path = write_video(os.path.join(tmp, "p18.mp4"), clip, fps=62.5)
    t_write = time.perf_counter() - t0
    got, fps = read_video_frames(path)
    rgb = np.repeat(clip, 3, axis=-1)
    if (not path.endswith(".avi") or fps != 62.5
            or got.shape != (len(clip), *rgb.shape[1:])):
        raise AssertionError(f"write_video: {path}, {fps} fps, "
                             f"{got.shape}")
    for g, f in zip(got, rgb):
        if not np.array_equal(g, decode_mjpeg_frame(encode_jpeg(
                np.ascontiguousarray(f[:, :, ::-1])))):
            raise AssertionError("write_video: a frame read back is not "
                                 "its JPEG's decode")
    p = min(psnr(g[:, :, ::-1].astype(np.float64), f.astype(np.float64),
                 peak=255.0) for g, f in zip(got, rgb))
    say(f"[18] (d) write_video: {len(clip)} frames to "
        f"{os.path.basename(path)} in {t_write:.2f} s ({os.path.getsize(path)}"
        f" bytes), read back exact to their JPEGs; min PSNR against the "
        f"frames {p:.2f} dB")
    return {"psnr": p}


def phase18_trace(dev: torch.device, landmarks: np.ndarray, tmp: str
                  ) -> dict:
    """(e) ``utils/observe.py:profile_trace`` around one 8-frame batch of a
    full-width drawing renderer (seeded weights) on phase 3's landmarks:
    the Chrome trace exists, names K2's kernel, and its K2 events number
    K2's launches in the batch."""
    from animateportrait_tpu_torch.entry import entry
    from animateportrait_tpu_torch.models.flowunet import FlowUnet
    from animateportrait_tpu_torch.models.gan import ResnetStyle2Generator
    from animateportrait_tpu_torch.models.modnet import MODNet
    from animateportrait_tpu_torch.pipeline.render import Module2Renderer
    from animateportrait_tpu_torch.utils.observe import profile_trace
    from animateportrait_tpu_torch.utils.smoke import init_random_

    gen = torch.Generator().manual_seed(1)
    renderer = Module2Renderer(
        entry(dev)[0], init_random_(FlowUnet(), gen),
        init_random_(MODNet(), gen),
        init_random_(ResnetStyle2Generator(), gen), frame_batch=8,
        device=dev)
    photo = np.random.default_rng(1).uniform(-1, 1, (256, 256, 3)).astype(
        np.float32)
    tb68 = (landmarks[:8, :, :2] * 0.5).astype(np.float32)
    with torch.inference_mode():
        renderer(photo, tb68.mean(0), tb68)           # warm
        zero_counters()
        with profile_trace(os.path.join(tmp, "p18_trace")) as path:
            renderer(photo, tb68.mean(0), tb68)
        launches = read_counters()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    k2 = [e for e in events if e.get("cat") == "kernel"
          and "instance_norm" in e.get("name", "")]
    say(f"[18] (e) profile_trace around one renderer batch: "
        f"{os.path.getsize(path)} bytes, {len(events)} events, {len(k2)} "
        f"K2 kernel events ({k2[0]['name'][:60] if k2 else None}), K2 "
        f"launches {launches['instance_norm']}")
    if not k2 or len(k2) != launches["instance_norm"]:
        raise AssertionError(f"profile_trace: {len(k2)} K2 events against "
                             f"{launches['instance_norm']} launches")
    return {"launches": launches}


def phase18(dev: torch.device, main_run: dict, tmp: str) -> dict:
    """The last functions of the JAX package, (a)-(e); each part runs, and
    the phase fails after them if any failed."""
    import traceback

    t0 = time.perf_counter()
    parts = {"entry": lambda: phase18_entry(dev),
             "discriminators": lambda: phase18_discriminators(dev),
             "mel": lambda: phase18_mel(dev),
             "video": lambda: phase18_video(main_run["frames"], tmp),
             "trace": lambda: phase18_trace(dev, main_run["landmarks"],
                                            tmp)}
    out, failed = {}, []
    for name, part in parts.items():
        try:
            out[name] = part()
        except Exception as e:     # the phase fails below, after every part
            traceback.print_exc()
            failed.append(f"{name}: {e!r}"[:2000])
    say(f"[18] phase 18 in {time.perf_counter() - t0:.1f} s")
    if failed:
        raise AssertionError("phase 18: " + "; ".join(failed))
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


def multi_card(card: str, dev: torch.device) -> None:
    """``--multi-card``: phase 1, the part of phase 16 that phase 17 reads
    (the one-card render) and phase 17, over phase 8's tree: the
    multi-card paths alone, in about half the whole run's time. It prints
    no result line."""
    from animateportrait_tpu_torch.utils.smoke import write_umlvd_tree

    t0 = time.perf_counter()
    phase1()
    with tempfile.TemporaryDirectory() as tmp:
        tree = write_umlvd_tree(os.path.join(tmp, "data"), n_photos=16,
                                n_styles=16, clips=2, frames=8, size=512,
                                seed=0, png_filter=4)
        res, frames = render_cli(tmp, "out0", [])
        multi = {"render": {"frames": frames,
                            "render_s": res.stage_seconds["render"]}}
        phase17(card, multi, tmp, tree)
    stop_processes()
    say(f"[done] --multi-card: phase 17 and what it reads passed in "
        f"{time.perf_counter() - t0:.1f} s")


def main() -> None:
    import argparse

    p = argparse.ArgumentParser(description="Drive the port on the card.")
    p.add_argument("--multi-card", action="store_true",
                   help="run phase 17 (the multi-card paths) and only what "
                        "it reads; no result line")
    multi_only = p.parse_args().multi_card
    card = phase0()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    if multi_only:
        multi_card(card, dev)
        return
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
        trainers = phase13(dev, card)
        zoo = phase14(dev, card, main_run)
        p15 = os.path.join(tmp, "p15")
        os.makedirs(p15)
        tools = phase15(dev, main_run, p15, os.path.join(tmp, "data"))
        multi = phase16(dev, card, main_run, tmp, os.path.join(tmp, "data"))
        cards = phase17(card, multi, tmp, os.path.join(tmp, "data"))
        last = phase18(dev, main_run, tmp)
    rec["instance_norm"]["max_abs_err"] = max(
        last["entry"]["k2_err"],
        rec["instance_norm"]["max_abs_err"],
        surface["test_cli"]["k2_path_err"],
        surface["p2c_full"]["k2_path_err"], zoo["gan"]["k2_path_err"],
        *(r["k2_path_err"] for r in tools["fakeb"].values()),
        *(multi[k]["k2_err"] for k in ("dp", "render", "gpipe")),
        *(r["k2_err"] for r in cards.values() if "k2_err" in r))
    k2b = rec.setdefault("instance_norm_backward", {})
    k2b["max_abs_err"] = max(k2b.get("max_abs_err", 0.0),
                             zoo["gan"]["k2b_worst"]["k2b_abs"])
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
                estimated_ms=run["estimated"][key],
                bound_ms=run["estimated"].get(key + "_bound"))})
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
        "video_cli": surface["video"]["launches"],
        **{f"train_{name}": run["launches"]
           for name, run in (*trainers["timed"].items(),
                             *zoo["timed"].items())},
        "train_foa_driver": zoo["foa"]["launches"],
        **{f"gan_extra_{name}": run["launches"]
           for name, run in zoo["gan"]["nets"].items()},
        **{f"lpips_{name}": run["launches"]
           for name, run in zoo["lpips"].items()},
        "train_convergence": zoo["launches"],
        "postalign": tools["postalign"]["launches"],
        "av2flau": tools["av2flau"]["launches"],
        **{f"fakeb_static_{style}": run["launches"]
           for style, run in tools["fakeb"].items()},
        "gan_convergence": tools["convergence"]["launches"],
        **multi["dp"]["launches"],
        "train_cli_multihost": multi["multihost"]["launches"],
        **multi["render"]["launches"], **multi["gpipe"]["launches"],
        **{k: v for r in cards.values() for k, v in r.get(
            "launches", {}).items()},
        "entry": last["entry"]["launches"],
        "mel_spectrogram": last["mel"]["launches"],
        "profile_trace_render": last["trace"]["launches"]}
    # "launches": K1's, K2's and K2-bf16's on the user's entry point (the
    # cartoon CLI runs of phases 5 and 9), K2b's in one replayed step of the
    # training step's CUDA graph, counted in its trace (phase 7), and
    # K2b-bf16's in the timed bf16 steps (phase 10); "launches_by_path" has
    # every path's count
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
