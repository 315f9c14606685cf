"""End-to-end pipeline: one face photo + one speech WAV -> frames. Port of
``animateportrait_tpu/pipeline/end2end.py``.

The stages pass numpy arrays, as in the JAX package: detect (device, with
the NMS loops on the host), align (host), the 68 source landmarks (FAN3D
and its depth net on the device through ``landmark_fn`` when one is given,
timed as the "fan" stage; else the 5-point canonical-face fit), audio
features (device), landmark prediction (device), landmark
un-normalization, blinks and smoothing (host), rendering (device). The JAX pipeline's background
warm-up thread existed to overlap XLA compiles; PyTorch compiles nothing,
so the port has no such thread.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import time
from typing import Callable

import numpy as np
import torch

from animateportrait_tpu_torch.ops import geometry
from animateportrait_tpu_torch.pipeline.align import (
    align_detections, detect, estimate_landmarks_from_5pt)
from animateportrait_tpu_torch.pipeline.audio import (
    AudioPipeline, load_wav, normalize_audio_features)
from animateportrait_tpu_torch.pipeline.landmark import (
    LandmarkPredictor, sliding_windows)
from animateportrait_tpu_torch.pipeline.render import Module2Renderer
from animateportrait_tpu_torch.utils import assets, observe
from animateportrait_tpu_torch.utils.image import resize_bicubic

FPS = 62.5  # 16000 Hz / 256-sample hop


@dataclasses.dataclass
class PipelineOutputs:
    frames: np.ndarray          # (T, 256, 256, nc): [-1,1] f32 or uint8
    landmarks: np.ndarray       # (T, 68, 3) in aligned-512 space
    aligned_photo: np.ndarray   # (512, 512, 3) BGR uint8
    stage_seconds: dict[str, float] = dataclasses.field(default_factory=dict)
    fps: float = FPS


def face_shape(shape_3d: np.ndarray):
    """68 x 3 landmarks in aligned-512 pixels -> (the raw shape, normalized
    shape, scale, shift): the manual lip/eye adjustment
    (main_end2end_module2.py:195-198), then ``norm_input_face``."""
    shape_3d = np.array(shape_3d, np.float64)
    shape_3d[49:54, 1] += 1.0
    shape_3d[55:60, 1] -= 1.0
    shape_3d[[37, 38, 43, 44], 1] -= 2.0
    shape_3d[[40, 41, 46, 47], 1] += 2.0
    raw_shape = shape_3d.copy()
    norm_shape, scale, shift = geometry.norm_input_face(
        shape_3d, assets.std_face_landmarks())
    return raw_shape, norm_shape, scale, shift


def write_stage_dumps(dump_dir: str, mel_autovc: np.ndarray,
                      spk_emb: np.ndarray, audio_name: str) -> None:
    """The reference driver's ``random_val_{fl,au,gaze}.pickle`` dumps
    (main_end2end_module2.py:230-251): a landmark placeholder, the AutoVC
    audio and zero gaze, in the format the Module1 trainers read."""
    os.makedirs(dump_dir, exist_ok=True)
    Tm = mel_autovc.shape[0]
    info = (0, audio_name, np.asarray(spk_emb))
    dumps = {
        "fl": [(np.zeros((Tm, 204), np.float32), info)],
        "au": [(np.asarray(mel_autovc), info)],
        "gaze": {"rot_trans": [np.zeros((Tm, 3, 4))],
                 "rot_quat": [np.zeros((Tm, 4))],
                 "anchor_t_shape": [np.zeros((Tm, 204))]},
    }
    for k, v in dumps.items():
        with open(os.path.join(dump_dir, f"random_val_{k}.pickle"),
                  "wb") as fp:
            pickle.dump(v, fp)


class TalkingPortraitPipeline:
    """photo (BGR uint8) + wav (array or path) -> frames.

    landmark_fn: the aligned BGR 512 photo -> its (68, 3) landmarks (the
    CLI's FAN3D hook, ``models/fan3d.py:make_fan_landmark_fn``); without
    one, the 5-point canonical-face fit. Each call is a clip: the span
    ``clip`` (``utils/observe.py``), whose request id counts the clips of
    this pipeline from 0."""

    def __init__(self, detector, landmark_predictor: LandmarkPredictor,
                 audio_pipeline: AudioPipeline, renderer: Module2Renderer,
                 landmark_fn: Callable[[np.ndarray], np.ndarray] | None = None):
        self.detector = detector
        self.predictor = landmark_predictor
        self.audio = audio_pipeline
        self.renderer = renderer
        self.landmark_fn = landmark_fn
        self.clips = 0

    def __call__(self, img_bgr: np.ndarray, wav: np.ndarray | str,
                 gender: str = "F",
                 rng: np.random.Generator | None = None,
                 spk_emb_override: np.ndarray | None = None,
                 output_folder: str | None = None,
                 dump_dir: str | None = None,
                 audio_name: str = "audio") -> PipelineOutputs:
        """spk_emb_override: a 256-d speaker embedding for the landmark
        branch in place of the one computed from ``wav`` (the CLI's
        ``--reuse_train_emb_list``). output_folder: also write
        ``pred_fls_<audio_name>_audio_embed.txt``, the normalized predicted
        landmarks (train_audio2landmark.py:340-342). dump_dir: also write
        the stage dumps (``write_stage_dumps``)."""
        observe.request(self.clips)
        self.clips += 1
        with observe.span("clip"):
            return self._clip(img_bgr, wav, gender, rng, spk_emb_override,
                              output_folder, dump_dir, audio_name)

    def _clip(self, img_bgr, wav, gender, rng, spk_emb_override,
              output_folder, dump_dir, audio_name) -> PipelineOutputs:
        times: dict[str, float] = {}
        t = time.perf_counter()

        def mark(stage: str):
            nonlocal t
            if self.renderer.device.type == "cuda":
                torch.cuda.synchronize(self.renderer.device)
            now = time.perf_counter()
            times[stage] = now - t
            t = now

        if isinstance(wav, str):
            wav = load_wav(wav)
        boxes, lms = detect(img_bgr, self.detector)
        mark("detect")
        with observe.span("clip.align"):
            aligned, five = align_detections(img_bgr, boxes, lms)
            if self.landmark_fn is None:
                raw_shape, norm_shape, scale, shift = face_shape(
                    estimate_landmarks_from_5pt(five))
        mark("align")
        if self.landmark_fn is not None:
            raw_shape, norm_shape, scale, shift = face_shape(
                self.landmark_fn(aligned))
            mark("fan")
        feats = self.audio(wav, gender)
        if dump_dir:
            write_stage_dumps(dump_dir, feats.mel_autovc, feats.spk_emb,
                              audio_name)
        mark("audio")
        windows = sliding_windows(normalize_audio_features(feats.mel_autovc))
        face_id = norm_shape.reshape(1, 204).astype(np.float32)
        spk = (np.asarray(spk_emb_override, np.float32).reshape(-1)
               if spk_emb_override is not None else feats.spk_emb)
        fl = self.predictor(windows, spk, face_id)
        if output_folder:
            os.makedirs(output_folder, exist_ok=True)
            np.savetxt(os.path.join(
                output_folder, f"pred_fls_{audio_name}_audio_embed.txt"),
                np.asarray(fl).reshape(-1, 204), fmt="%.6f")
        mark("landmarks")

        with observe.span("clip.post"):
            # un-normalize back to aligned-512 pixel space (:265-266)
            fl = fl.reshape(-1, 68, 3).astype(np.float64)
            fl[:, :, 0:2] = -fl[:, :, 0:2]
            fl[:, :, 0:2] = fl[:, :, 0:2] / scale - shift
            fl = geometry.add_naive_eye(fl, rng or np.random.default_rng(0))
            flat = fl.reshape(-1, 204)
            T = flat.shape[0]
            w_face = min(15, (T - 1) // 2 * 2 + 1)
            w_lip = min(5, (T - 1) // 2 * 2 + 1)
            if w_face >= 5:
                from scipy.signal import savgol_filter

                flat[:, : 48 * 3] = savgol_filter(flat[:, : 48 * 3], w_face,
                                                  3, axis=0)
                flat[:, 48 * 3:] = savgol_filter(flat[:, 48 * 3:], w_lip, 3,
                                                 axis=0)
            fl = flat.reshape(-1, 68, 3)

            # render at 256: photo and landmarks scale by 256/512
            photo256 = resize_bicubic(aligned, (256, 256))
            photo_rgb = photo256[:, :, ::-1].astype(np.float32) / 127.5 - 1.0
            a68 = (raw_shape[:, :2] * (256.0 / 512.0)).astype(np.float32)
            tb68 = (fl[:, :, :2] * (256.0 / 512.0)).astype(np.float32)
        frames = self.renderer(photo_rgb, a68, tb68)
        mark("render")
        return PipelineOutputs(frames=frames, landmarks=fl,
                               aligned_photo=aligned, stage_seconds=times)
