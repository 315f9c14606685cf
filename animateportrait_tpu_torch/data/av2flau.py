"""Dataset builder: video -> per-frame 3D landmarks (+ audio features).
Port of ``animateportrait_tpu/data/av2flau.py`` (reference:
``Module1/src/dataset/utils/Av2Flau_Convertor.py``): per-frame facial
landmarks, the raw fl3d dump, audio features, and the ICP registration to
the 9-point anchor T-shape.

Frames come from ``utils/video.py:read_video_frames`` (raw and Motion-JPEG
AVI, decoded as ``cv2.VideoCapture`` decodes them; no FFmpeg, so the audio
is a separate WAV). The landmark source is injectable; the port's is
FAN3D with its depth net behind MTCNN
(``models/fan3d.py:make_fan_landmark_fn``), on the card. The audio
features are ``pipeline/audio.py:AudioPipeline``'s, whose STFT is the K1
kernel on the card.

One deliberate difference from the JAX converter: that one skips a frame
on any exception of ``landmark_fn``. Here a frame is skipped only when
``landmark_fn`` returns None or raises ``NoFaceError`` (the detector found
no face); any other error (a CUDA or kernel failure among them)
propagates.
"""
from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch

from animateportrait_tpu_torch.models.fan3d import NoFaceError
from animateportrait_tpu_torch.ops.geometry import best_fit_transform
from animateportrait_tpu_torch.utils import assets
from animateportrait_tpu_torch.utils.video import read_video_frames


def register_to_anchor(fl3d: np.ndarray) -> np.ndarray:
    """Rigidly register every frame's 9 anchor points to the canonical
    T-shape and apply the transform to all 68 points
    (Av2Flau_Convertor.__single_landmark_3d_register__ semantics), in
    float64 on the host. (T, 204) -> (T, 204)."""
    idx = list(assets.T_SHAPE_IDX)
    anchor = torch.from_numpy(assets.std_face_landmarks()[idx])
    out = np.array(fl3d, np.float64).reshape(-1, 68, 3)
    for t in range(out.shape[0]):
        _, r, tr = best_fit_transform(torch.from_numpy(out[t, idx]), anchor)
        out[t] = out[t] @ r.numpy().T + tr.numpy()
    return out.reshape(-1, 204)


class Av2FlauConverter:
    """video (+ wav) -> (fl3d (T, 1+204), audio features, fps).

    fl3d rows are [frame_index, 68x3 landmarks] like the reference's
    raw_fl3d txt dumps.
    """

    def __init__(self, landmark_fn: Callable[[np.ndarray], np.ndarray | None],
                 audio_pipeline=None):
        """landmark_fn: BGR frame -> (68, 3) landmarks, or None / a raised
        ``NoFaceError`` to skip the frame."""
        self.landmark_fn = landmark_fn
        self.audio_pipeline = audio_pipeline

    def convert(self, video_path: str, wav_path: str | None = None,
                out_dir: str | None = None, max_frames: int = 250,
                register: bool = False):
        frames, fps = read_video_frames(video_path, max_frames)
        rows = []
        for i, frame in enumerate(frames):
            try:
                lm = self.landmark_fn(frame)
            except NoFaceError:
                lm = None
            if lm is None:
                continue
            rows.append(np.concatenate(
                [[i], np.asarray(lm, np.float64).reshape(-1)]))
        if len(rows) < 9:
            raise ValueError("landmark sequence too short "
                             f"({len(rows)} frames)")
        fl3d = np.stack(rows)
        if register:
            fl3d = np.concatenate(
                [fl3d[:, :1], register_to_anchor(fl3d[:, 1:])], axis=1)

        feats = None
        if wav_path is not None and self.audio_pipeline is not None:
            from animateportrait_tpu_torch.pipeline.audio import load_wav

            with torch.inference_mode():
                feats = self.audio_pipeline(load_wav(wav_path))

        if out_dir is not None:
            os.makedirs(os.path.join(out_dir, "raw_fl3d"), exist_ok=True)
            base = os.path.splitext(os.path.basename(video_path))[0]
            np.savetxt(os.path.join(out_dir, "raw_fl3d",
                                    f"fan_{base}_3d.txt"), fl3d, fmt="%.2f")
        return fl3d, feats, fps
