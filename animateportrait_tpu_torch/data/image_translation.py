"""The image-translation (MakeItTalk renderer) dataset. Port of
``animateportrait_tpu/data/image_translation.py``: pairs a reference
frame with a target frame and the target's landmark sketch (image_in =
cat(reference frame, sketch), image_out = target frame, in [0, 1], NHWC
numpy as the JAX module emits them), and the ``_with_audio`` variant with
the log-power STFT window of each target frame, resized as OpenCV does by
default (``utils/image.py:resize_linear_float``). Host numpy; sketches
are drawn as OpenCV 5.0 draws them (``utils/vis.py``).
"""
from __future__ import annotations

import numpy as np

from animateportrait_tpu_torch.utils.image import resize_linear_float
from animateportrait_tpu_torch.utils.vis import (
    CURVES, CURVES_98, vis_landmark_on_img)


def render_sketch(lm: np.ndarray, size: int, linewidth: int = 2
                  ) -> np.ndarray:
    """Black canvas + coloured landmark curves, float [0, 1] (H, W, 3)."""
    img = np.zeros((size, size, 3), np.uint8)
    curves = CURVES_98 if lm.shape[0] >= 98 else CURVES
    vis_landmark_on_img(img, lm[:, :2], linewidth, curves)
    return img.astype(np.float32) / 255.0


class ImageTranslationDataset:
    """frames (T, H, W, 3) uint8 + landmarks (T, 68|98, 2) -> training
    pairs; the reference frame is drawn per item (raw98 semantics)."""

    def __init__(self, frames: np.ndarray, landmarks: np.ndarray):
        assert frames.shape[0] == landmarks.shape[0]
        self.frames = frames
        self.landmarks = landmarks

    def __len__(self):
        return self.frames.shape[0]

    def sample(self, index: int, rng: np.random.Generator) -> dict:
        t = index % len(self)
        ref = int(rng.integers(0, len(self)))
        size = self.frames.shape[1]
        tgt = self.frames[t].astype(np.float32) / 255.0
        src = self.frames[ref].astype(np.float32) / 255.0
        sketch = render_sketch(self.landmarks[t], size)
        return {"image_in": np.concatenate([src, sketch], axis=-1),
                "image_out": tgt}

    def batch(self, indices, rng: np.random.Generator) -> dict:
        items = [self.sample(i, rng) for i in indices]
        return {k: np.stack([it[k] for it in items]) for k in items[0]}


def audio_stft_map(samples: np.ndarray, sample_rate: int = 16000
                   ) -> np.ndarray:
    """The log-power STFT map of the ``_with_audio`` datasets
    (image_translation_dataset.py:813-817): ``scipy.signal.stft`` with
    nperseg 640, noverlap 560 (hop 80: 8 columns per 25 fps video frame),
    log power over its max. (321, T_stft), in the samples' float
    precision."""
    from scipy.signal import stft

    if samples.ndim > 1:
        samples = samples[:, 0]
    _, _, zxx = stft(samples, fs=sample_rate, nperseg=640, noverlap=560)
    m = np.log(np.abs(zxx) ** 2 + 1e-10)
    return m / np.max(m)


class ImageTranslationWithAudioDataset(ImageTranslationDataset):
    """``image_translation_raw98_with_audio_dataset`` (:736-830): (image_in,
    image_out, audio_in) over randomly drawn frames, audio_in the
    +-5-frame (80-column) slice of the log-STFT map resized to (size,
    size); 25 fps. The drawn indices are sorted, as in the JAX package
    (its note on the reference's order-dependent pairing):
    image_in[k] = frames[s[k+1]], image_out[k] = frames[s[k]], audio_in[k]
    the window around s[k]."""

    def __init__(self, frames: np.ndarray, landmarks: np.ndarray,
                 wav: np.ndarray, sample_rate: int = 16000,
                 num_frames: int = 1):
        super().__init__(frames, landmarks)
        if len(frames) < 12 + num_frames + 1:
            raise ValueError(
                f"clip too short: need >= {12 + num_frames + 1} frames "
                f"for the +-5-frame audio windows, got {len(frames)}")
        self.stft_map = audio_stft_map(wav, sample_rate)
        self.num_random_frames = num_frames + 1

    def sample_with_audio(self, rng: np.random.Generator) -> dict:
        length = len(self)
        size = self.frames.shape[1]
        # drawn from [5, length - 12 + 5) so the window stays in range
        idx = np.sort(rng.permutation(length - 12)[
            :self.num_random_frames] + 5)
        frames = self.frames[idx].astype(np.float32) / 255.0
        audio_in = []
        for t in idx[:-1]:          # the windows around the target frames
            clip = self.stft_map[:, (t - 5) * 8:(t + 5) * 8]
            if clip.shape[1] != 80:
                raise ValueError(f"audio window out of range at frame {t}")
            audio_in.append(resize_linear_float(clip, (size, size)))
        return {"image_in": frames[1:], "image_out": frames[:-1],
                "audio_in": np.stack(audio_in).astype(np.float32)[..., None]}
