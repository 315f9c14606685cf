"""Clips through the port's CLI path, back to back: a closed loop of one
client, as a CLI user waits for each clip.

Set-up writes the seeded checkpoints the CLI loads and the inputs of the
mix (JPEG photos, WAV files), builds the pipeline once with
``cli.build_pipeline``, and warms it on a clip of the mix's shortest and
one of its longest speech. Each clip then makes the calls ``cli.main``
makes for one photo and one WAV: ``read_image`` (once per session of the
mix's ``replies_per_photo`` clips), ``load_wav``, the pipeline under
``inference_mode`` and ``write_video_with_audio``; the AVI is deleted
after its clip. The window starts clips until ``--seconds`` have passed
and finishes the clip in flight.

Each stage of the pipeline is tapped (what went in, what came out), so
that the plain reference can follow the port stage by stage once the
window has closed (``reference/drawing.py``)."""
from __future__ import annotations

import contextlib
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from portbench import inputs
from portbench.reference import drawing


class Tap:
    """Passes calls through to ``target`` and keeps, in ``record``, what
    went in and what came out, under a profiler span of its own."""

    def __init__(self, target, key: str):
        self.target, self.key, self.record = target, key, None
        self.span = f"portbench.{key}"

    def __getattr__(self, name):
        return getattr(self.target, name)

    def __call__(self, *args, **kwargs):
        with torch.profiler.record_function(self.span):
            out = self.target(*args, **kwargs)
        if self.record is not None:
            self.record[self.key] = out
            self.record[self.key + "_in"] = args
        return out


class Driver:
    """``clips``: the drawing CLI's per-clip path. ``control``: the frozen
    reference pipeline in TF32 in the port's place, without the AVI."""

    def __init__(self, cell, seed: int, device: torch.device,
                 control: bool = False):
        self.cell, self.cfg, self.mix = cell, cell.config, cell.traffic
        self.seed, self.device, self.control = seed, device, control
        self.tmp = None

    # --- set-up ------------------------------------------------------------

    def _inputs(self) -> None:
        mix, cfg = self.mix, self.cfg
        size, q = cfg["photo_size"], mix["jpeg_quality"]
        self.photo_paths = [
            inputs.write_jpeg(os.path.join(self.tmp, f"photo{i}.jpg"),
                              inputs.face_photo(inputs.sub_seed(
                                  self.seed, f"photo{i}"), size), q)
            for i in range(mix["photos"])]
        self.warm_photo = inputs.write_jpeg(
            os.path.join(self.tmp, "warm.jpg"), inputs.face_photo(
                inputs.sub_seed(self.seed, "warm_photo"), size), q)
        self.wav_paths = [
            inputs.write_wav(os.path.join(self.tmp, f"speech{i}.wav"),
                             inputs.make_wav(s, inputs.sub_seed(
                                 self.seed, f"speech{i}")))
            for i, s in enumerate(mix["speech_seconds"])]
        lengths = mix["speech_seconds"]
        self.warm = [(self.warm_photo, self.wav_paths[lengths.index(s)])
                     for s in (min(lengths), max(lengths))]

    def setup(self) -> None:
        cfg = self.cfg
        if cfg["fan3d"]:
            raise ValueError("fan3d: this driver writes no FAN checkpoint, "
                             "so the CLI takes its 5-point fit")
        self.tmp = tempfile.mkdtemp(prefix="portbench-")
        self._inputs()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if self.control:
            from portbench.reference.frozen.pipeline.audio import load_wav
            from portbench.reference.frozen.utils.image import read_image

            self.pipeline = drawing.build_pipeline(
                cfg, drawing.make_nets(cfg, self.seed, self.device),
                self.device)
            self.read_image, self.load_wav, self.write = (
                read_image, load_wav, None)
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        else:
            from animateportrait_tpu_torch import cli
            from animateportrait_tpu_torch.pipeline.audio import load_wav
            from animateportrait_tpu_torch.utils.image import read_image
            from animateportrait_tpu_torch.utils.video import (
                write_video_with_audio)

            ckpt = os.path.join(self.tmp, "checkpoints")
            nets = drawing.make_nets(cfg, self.seed, self.device)
            drawing.write_checkpoints(nets, ckpt, cfg["exp"])
            del nets
            self.args = cli.build_argparser().parse_args([
                "--jpg", self.photo_paths[0], "--audio", self.wav_paths[0],
                "--exp", cfg["exp"], "--ckpt_dir", ckpt,
                "--frame_batch", str(cfg["frame_batch"]),
                "--warp_mode", cfg["warp_mode"],
                "--ngf", str(cfg["ngf"]), "--flow_nf", str(cfg["flow_nf"]),
                "--static_ngf", str(cfg["static_ngf"]),
                "--output", os.path.join(self.tmp, "output"),
                "--device", str(self.device)])
            self.pipeline = cli.build_pipeline(self.args)
            self.read_image, self.load_wav, self.write = (
                read_image, load_wav, write_video_with_audio)
        p = self.pipeline
        self.taps = []
        for attr, key in (("detector", "detect"), ("audio", "audio"),
                          ("predictor", "predictor"), ("renderer", "render")):
            self.taps.append(Tap(getattr(p, attr), key))
            setattr(p, attr, self.taps[-1])
        for photo, wav in self.warm:
            self._clip(photo, wav, self.read_image(photo), None)

    # --- the window ----------------------------------------------------------

    def _clip(self, photo: str, wav_path: str, img: np.ndarray,
              rec: dict | None) -> dict:
        """One clip, as ``cli.main`` runs it after the build."""
        cfg = self.cfg
        for tap in self.taps:
            tap.record = rec
        t0 = time.perf_counter()
        with torch.profiler.record_function("portbench.load_wav"):
            wav = self.load_wav(wav_path)
        t1 = time.perf_counter()
        audio_name = os.path.splitext(os.path.basename(wav_path))[0]
        with torch.inference_mode(), torch.profiler.record_function(
                "portbench.pipeline"):
            out = self.pipeline(img, wav, gender=cfg["gender"],
                                rng=np.random.default_rng(0),
                                spk_emb_override=None, output_folder=None,
                                dump_dir=None, audio_name=audio_name)
        t2 = time.perf_counter()
        if self.write is not None:
            with torch.profiler.record_function("portbench.write_video"):
                base = os.path.join(
                    self.args.output, os.path.splitext(
                        os.path.basename(photo))[0] + "-" + audio_name)
                os.makedirs(base, exist_ok=True)
                path = self.write(os.path.join(
                    base, f"output_{cfg['exp'].replace('/', '_')}.avi"),
                    out.frames, wav, fps=out.fps)
                os.remove(path)
        t3 = time.perf_counter()
        return {"frames_n": int(out.frames.shape[0]),
                "padded": (-out.frames.shape[0]) % cfg["frame_batch"],
                "io_s": (t1 - t0) + (t3 - t2), "wall_s": t3 - t0,
                "stages": dict(out.stage_seconds), "frames": out.frames,
                "aligned": out.aligned_photo}

    def window(self, seconds: float, tracer) -> dict:
        mix = self.mix
        per = mix["replies_per_photo"]
        units, failed, errors, img = [], 0, [], None
        ctx = tracer.window() if tracer else contextlib.nullcontext()
        with ctx:
            start = time.perf_counter()
            k = 0
            while True:
                photo = self.photo_paths[(k // per) % len(self.photo_paths)]
                wav = self.wav_paths[k % len(self.wav_paths)]
                rec = {"photo": photo, "wav_path": wav,
                       "gender": self.cfg["gender"]}
                try:
                    t0 = time.perf_counter()
                    if k % per == 0:
                        with torch.profiler.record_function(
                                "portbench.read_image"):
                            img = self.read_image(photo)
                    read_s = time.perf_counter() - t0
                    rec.update(self._clip(photo, wav, img, rec))
                    rec["img"] = img
                    rec["io_s"] += read_s
                    rec["wall_s"] += read_s
                    units.append(rec)
                except Exception as e:   # a failed clip counts as failed
                    failed += 1
                    errors.append(f"clip {k}: {type(e).__name__}: {e}")
                k += 1
                if time.perf_counter() - start >= seconds:
                    break
            end = time.perf_counter()
        for e in errors[:5]:
            print(f"[portbench] {e}", file=sys.stderr)
        return {"units": units, "attempted": k, "failed": failed,
                "window_s": end - start}

    def end_to_end(self, win: dict) -> dict:
        frames = sum(u["frames_n"] for u in win["units"])
        return {"frames_per_s": frames / win["window_s"]}

    def records(self, win: dict) -> dict:
        from portbench.counts import flops

        cfg = self.cfg
        return {"units": win["units"], "window_s": win["window_s"],
                "work": flops.renderer_work(
                    cfg["ngf"], cfg["flow_nf"], cfg["static_ngf"],
                    cfg["output_nc"], cfg["frame_batch"], cfg["crop_size"])}

    def release(self) -> None:
        for tap in self.taps:
            tap.record = None
        self.pipeline = self.taps = None
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    # --- the check -------------------------------------------------------------

    def check(self, win: dict) -> dict:
        units = win["units"]
        if not units:
            return {k: float("inf") for k in self.cfg["limits"]}
        photos = {}
        for u in units:
            photos.setdefault(u["photo"], (u["photo"], u["img"]))
        clips = [{"img": u["img"], "detect": u["detect"],
                  "detect_in": u["detect_in"], "aligned": u["aligned"],
                  "wav_path": u["wav_path"], "gender": u["gender"],
                  "mel_autovc": u["audio"].mel_autovc,
                  "predictor_in": u["predictor_in"],
                  "landmarks": u["predictor"],
                  "render_in": u["render_in"], "frames": u["frames"]}
                 for u in units]
        sample = render_sample(len(clips), [u["frames_n"] for u in units],
                               self.mix["render_checks"], self.seed)
        nets = drawing.make_nets(self.cfg, self.seed, self.device)
        return drawing.compare(self.cfg, clips, photos, self.device, nets,
                               sample)

    def close(self) -> None:
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)
            self.tmp = None


def render_sample(n: int, lengths: list, k: int, seed: int) -> list[int]:
    """The clips whose frames are rendered again: the longest, and
    ``k - 1`` more drawn from the seed."""
    longest = int(np.argmax(lengths))
    rest = [i for i in range(n) if i != longest]
    rng = np.random.default_rng(inputs.sub_seed(seed, "render_sample"))
    more = rng.choice(rest, size=min(k - 1, len(rest)), replace=False)
    return sorted({longest, *(int(i) for i in more)})
