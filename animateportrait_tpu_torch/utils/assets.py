"""The data tables the port reads (``animateportrait_tpu_torch/assets``).

Copies of the reference's data files, with the loader names of the JAX
package's ``utils/assets.py``: the canonical 68-point face shape, the
audio-feature normalization constants and the Obama target speaker
embedding used by the AutoVC normalizer. They are data, not code; the port
keeps its own copy so that it imports nothing of the JAX package.
"""
from __future__ import annotations

import functools
import os

import numpy as np

ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets")


@functools.lru_cache(maxsize=None)
def std_face_landmarks() -> np.ndarray:
    """Canonical 68x3 face shape (STD_FACE_LANDMARKS.txt)."""
    return np.loadtxt(os.path.join(ASSET_DIR, "STD_FACE_LANDMARKS.txt"))


@functools.lru_cache(maxsize=None)
def autovc_mel_au_mean_std() -> tuple[np.ndarray, np.ndarray]:
    """(mean, std) for AutoVC-mel audio features
    (MEAN_STD_AUTOVC_RETRAIN_MEL_AU.txt, first/second half)."""
    ms = np.loadtxt(
        os.path.join(ASSET_DIR, "MEAN_STD_AUTOVC_RETRAIN_MEL_AU.txt"))
    return ms[: ms.shape[0] // 2], ms[ms.shape[0] // 2:]


@functools.lru_cache(maxsize=None)
def obama_speaker_emb() -> np.ndarray:
    """256-d target speaker embedding for voice normalization."""
    return np.loadtxt(os.path.join(ASSET_DIR, "obama_emb.txt"))
