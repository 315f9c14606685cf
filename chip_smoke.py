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
     and the speaker embedding.

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
    return rec


def keep_instance_norm_inputs(nets) -> tuple[dict, list]:
    """Forward pre-hooks that keep a copy of the first input of every
    InstanceNorm2d of ``nets``, by module name."""
    from animateportrait_tpu_torch.nn import InstanceNorm2d

    kept, hooks = {}, []
    for net_name, net in nets.items():
        for name, mod in net.named_modules():
            if isinstance(mod, InstanceNorm2d):
                def keep(mod, args, key=f"{net_name}.{name}"):
                    if key not in kept:
                        kept[key] = (args[0].clone(), mod.relu)
                hooks.append(mod.register_forward_pre_hook(keep))
    return kept, hooks


def k2_on_path(kept: dict, tag: str) -> float:
    """K2 against its plain version on the activations a path fed each
    InstanceNorm; returns the largest |kernel - plain|."""
    from animateportrait_tpu_torch.ops.instnorm import (
        instance_norm, instance_norm_plain)

    by_shape = {}
    with torch.inference_mode():
        for key, (x, relu) in kept.items():
            want = instance_norm_plain(x, relu=relu)
            err = float((instance_norm(x, relu=relu) - want).abs().max())
            ratio = float((x.mean((2, 3)).abs()
                           / x.std((2, 3)).clamp_min(1e-12)).max())
            k = (tuple(x.shape), relu)
            worst = by_shape.get(k, (0.0, "", 0.0, 0.0))
            by_shape[k] = max(worst, (err, key, ratio,
                                      float(want.abs().max())))
    for (shape, relu), (err, key, ratio, top) in sorted(by_shape.items()):
        say(f"[{tag}] K2 on path activations {shape} relu={relu}: "
            f"max|kernel-plain|={err:.3e} (atol {K2_ATOL}) at {key}, "
            f"max |mean|/std there {ratio:.2f}, max |y| {top:.1f}")
    err, key, ratio, top = max(by_shape.values())
    say(f"[{tag}] K2 on path activations: {len(kept)} InstanceNorms, "
        f"{len(by_shape)} shapes, max|kernel-plain|={err:.3e} at {key} "
        f"(max |y| there {top:.1f}; fp32 spacing at |y| = {top:.1f} is "
        f"{float(np.spacing(np.float32(top))):.2e})")
    if err > K2_ATOL:
        raise AssertionError(f"K2 disagrees with its plain version on the "
                             f"main path's activations at {key}: {err}")
    return err


def k2_time_on_path(renderer, landmarks: np.ndarray, tag: str) -> dict:
    """K2's device time in a renderer, per photo (the static nets and
    encode_static) and per frame batch, each part run once after a warm-up:
    summed from a ``torch.profiler`` trace of the part (0 where CUPTI gives
    no device time), and as its launches x each shape's ``device_ms``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from animateportrait_tpu_torch.nn import InstanceNorm2d
    from animateportrait_tpu_torch.ops.instnorm import instance_norm
    from animateportrait_tpu_torch.ops.tps import triangulate_frames
    from animateportrait_tpu_torch.pipeline.render import (
        CROP_SIZE, landmark_dot_images)
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
        cache = renderer.g.encode_static(fore,
                                         landmark_dot_images(a68, CROP_SIZE))
        state["args"] = (cache, mask, static)

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
                key = (tuple(args[0].shape), mod.relu)
                counts[key] = counts.get(key, 0) + 1

            hooks = [m.register_forward_pre_hook(count) for m in norms]
            launches0 = instance_norm.launches
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            launches = instance_norm.launches - launches0
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
            for (shape, relu), n in counts.items():
                x = k2_input(shape, dev)
                est += n * device_ms(lambda: instance_norm(x, relu=relu))
            mix = {}
            for (shape, _), n in counts.items():
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
            "k2_path_err": k2_err,
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
    say(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    sources = {"stft_magnitude": ("animateportrait_tpu_torch/csrc/stft.cu",
                                  K1_REPLACES),
               "instance_norm": ("animateportrait_tpu_torch/csrc/instnorm.cu",
                                 K2_REPLACES)}
    rec["instance_norm"]["ms_by_path"] = {
        "cartoon_cli": cli_run["k2_time"],
        "drawing_pipeline": main_run["k2_time"]}
    # "launches": the user's entry point (phase 5, the cartoon CLI run);
    # "launches_by_path" adds the drawing pipeline of phase 3
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": repl,
         "launches": cli_run["launches"][name],
         "launches_by_path": {
             "cartoon_cli": cli_run["launches"][name],
             "drawing_pipeline": main_run["launches"][name]},
         **rec[name]}
        for name, (src, repl) in sources.items()]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
