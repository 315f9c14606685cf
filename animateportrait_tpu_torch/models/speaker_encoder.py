"""Speaker-embedding encoder (resemblyzer ``VoiceEncoder`` layout). Port of
``animateportrait_tpu/models/speaker_encoder.py`` (reference:
Module1/thirdparty/resemblyer_util/speaker_emb.py:6-21).

A 3-layer LSTM (40 -> 256) over 40-bin power-mel frames (n_fft 400, hop
160), then Linear(256, 256) + ReLU and L2 normalization. An utterance
embeds as the normalized mean over partial 160-frame windows, which go
through the net as one batch on the encoder's device. The mel front end
uses the plain STFT (``ops/spectral.py``), as the JAX package does: kernel
K1 is built for n_fft 1024 / hop 256 only.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from animateportrait_tpu_torch.ops.spectral import (
    mel_filterbank, stft_magnitude)
from animateportrait_tpu_torch.utils.device import (
    DEFAULT_DEVICE, resolve_device)

MEL_N_CHANNELS = 40
MEL_WINDOW_STEP = 160
MEL_N_FFT = 400
PARTIAL_N_FRAMES = 160


class VoiceEncoder(nn.Module):
    """(B, T, 40) mel frames -> (B, 256) L2-normalized embeddings."""

    def __init__(self, hidden: int = 256, emb_size: int = 256,
                 num_layers: int = 3):
        super().__init__()
        self.lstm = nn.LSTM(MEL_N_CHANNELS, hidden, num_layers,
                            batch_first=True)
        self.linear = nn.Linear(hidden, emb_size)

    def forward(self, mels):
        _, (h, _) = self.lstm(mels)
        raw = torch.relu(self.linear(h[-1]))
        return raw / torch.clamp(raw.norm(dim=-1, keepdim=True), min=1e-8)


def wav_to_mel40(wav: np.ndarray, sr: int = 16000,
                 device: torch.device | str = DEFAULT_DEVICE
                 ) -> torch.Tensor:
    """resemblyzer's front end: (T, 40) power mel on ``device``."""
    device = resolve_device(device)
    fb = mel_filterbank(sr=sr, n_fft=MEL_N_FFT, n_mels=MEL_N_CHANNELS,
                        fmin=0.0, fmax=sr / 2)
    mag = stft_magnitude(torch.as_tensor(wav, dtype=torch.float32,
                                         device=device),
                         n_fft=MEL_N_FFT, hop=MEL_WINDOW_STEP)
    return (mag * mag) @ torch.from_numpy(np.ascontiguousarray(fb.T)).to(
        device)


def preprocess_wav(wav: np.ndarray, sr: int = 16000,
                   target_dbfs: float = -30.0, vad_window_ms: float = 30.0,
                   vad_threshold: float = 0.01) -> np.ndarray:
    """Normalize the volume to -30 dBFS and drop long silences. The JAX
    package's stand-in for webrtcvad: a moving-RMS gate at
    ``vad_threshold``, dilated so word-internal dips survive."""
    wav = np.asarray(wav, np.float64)
    rms = np.sqrt(np.mean(np.square(wav))) or 1e-12
    wav = wav * 10 ** ((target_dbfs - 20 * np.log10(rms)) / 20.0)
    win = max(1, int(sr * vad_window_ms / 1000))
    energy = np.sqrt(np.convolve(wav ** 2, np.ones(win) / win, "same"))
    voiced = np.convolve((energy > vad_threshold).astype(np.float64),
                         np.ones(win * 8), "same") > 0
    if voiced.any():
        wav = wav[voiced]
    return wav


@torch.inference_mode()
def embed_utterance(encoder: VoiceEncoder, wav: np.ndarray, sr: int = 16000,
                    rate: float = 2.0, min_coverage: float = 0.75
                    ) -> np.ndarray:
    """Normalized mean of the partial-window embeddings (resemblyzer
    ``embed_utterance``), computed on the encoder's device."""
    mels = wav_to_mel40(wav, sr, next(encoder.parameters()).device)
    T = mels.shape[0]
    frame_step = max(1, int(np.round((sr / rate) / MEL_WINDOW_STEP)))
    wins = []
    for s in range(0, max(1, T - PARTIAL_N_FRAMES + frame_step), frame_step):
        e = s + PARTIAL_N_FRAMES
        if e > T:
            if (T - s) / PARTIAL_N_FRAMES < min_coverage and wins:
                continue
            s, e = max(0, T - PARTIAL_N_FRAMES), T
        wins.append(F.pad(mels[s:e], (0, 0, 0, PARTIAL_N_FRAMES - (e - s))))
    raw = encoder(torch.stack(wins)).cpu().numpy().mean(axis=0)
    return raw / max(np.linalg.norm(raw), 1e-8)


def get_spk_emb(encoder: VoiceEncoder, wav: np.ndarray, sr: int = 16000,
                segment_len: float = 60.0) -> np.ndarray:
    """Reference ``get_spk_emb``: preprocess, then the renormalized mean
    embedding over 60-second segments."""
    wav = preprocess_wav(wav, sr)
    n = int(segment_len * sr)
    embs = [embed_utterance(encoder, wav[i: i + n], sr)
            for i in range(0, max(1, len(wav)), n)
            if len(wav[i: i + n]) > sr // 4 or i == 0]
    emb = np.mean(np.stack(embs), axis=0)
    return emb / max(np.linalg.norm(emb), 1e-8)
