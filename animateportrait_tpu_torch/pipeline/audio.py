"""Audio front end: WAV -> (AutoVC-normalized mel, speaker embedding). Port
of ``animateportrait_tpu/pipeline/audio.py``.

The host keeps the WAV IO, the -20 dBFS gain, the 30 Hz high-pass and the
dither (numpy/scipy). The device runs the rest: |STFT| through kernel K1,
the mel/dB scaling, the f0 tracker with its normalization and one-hot
code, the speaker encoder when there is one, and AutoVC over chunks.
"""
from __future__ import annotations

import dataclasses
import wave

import numpy as np
import torch

from animateportrait_tpu_torch.models.autovc import AutoVCGenerator
from animateportrait_tpu_torch.models.speaker_encoder import (
    VoiceEncoder, get_spk_emb)
from animateportrait_tpu_torch.ops.f0 import track_f0
from animateportrait_tpu_torch.ops.spectral import (
    mel_filterbank, quantize_f0_onehot, speaker_normalize_f0)
from animateportrait_tpu_torch.ops.stft import stft_magnitude
from animateportrait_tpu_torch.utils import assets
from animateportrait_tpu_torch.utils.device import (
    DEFAULT_DEVICE, resolve_device)

SR = 16000
HOP = 256
N_FFT = 1024


def load_wav(path: str, target_sr: int = SR) -> np.ndarray:
    """Load a WAV file to float64 mono in [-1, 1), resampled to 16 kHz."""
    try:
        with wave.open(path, "rb") as w:
            sr, n = w.getframerate(), w.getnframes()
            ch, width = w.getnchannels(), w.getsampwidth()
            raw = w.readframes(n)
        if width == 2:
            x = np.frombuffer(raw, np.int16).astype(np.float64) / 32768.0
        elif width == 4:
            x = np.frombuffer(raw, np.int32).astype(np.float64) / 2147483648.0
        elif width == 1:
            x = (np.frombuffer(raw, np.uint8).astype(np.float64) - 128) / 128
        else:
            raise ValueError(f"unsupported sample width {width}")
        if ch > 1:
            x = x.reshape(-1, ch)[:, 0]
    except wave.Error:
        from scipy.io import wavfile

        sr, x = wavfile.read(path)
        scale = {np.dtype(np.int16): 32768.0,
                 np.dtype(np.int32): 2147483648.0}.get(x.dtype)
        if x.dtype == np.uint8:
            x = (x.astype(np.float64) - 128) / 128
        else:
            x = x.astype(np.float64) / (scale or 1.0)
        if x.ndim > 1:
            x = x[:, 0]
    if sr != target_sr:
        from math import gcd

        from scipy.signal import resample_poly

        g = gcd(sr, target_sr)
        x = resample_poly(x, target_sr // g, sr // g)
    return x


def normalize_dbfs(x: np.ndarray, target_dbfs: float = -20.0) -> np.ndarray:
    """Gain to the target RMS dBFS, then an int16 round trip (pydub
    match_target_amplitude + export, AutoVC...py:223-225)."""
    rms = np.sqrt(np.mean(np.square(x)))
    gain = 10 ** ((target_dbfs - 20 * np.log10(max(rms, 1e-12))) / 20.0)
    y = np.clip(x * gain, -1.0, 1.0)
    return np.round(y * 32768.0).clip(-32768, 32767) / 32768.0


def frontend(w: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Filtered, dithered fp32 signal -> packed (T, 80 + 1 + 257): mel-S,
    normalized f0, f0 one-hot."""
    mag = stft_magnitude(w, N_FFT, HOP)
    fb = torch.from_numpy(np.ascontiguousarray(
        mel_filterbank(SR, N_FFT, 80, 90.0, 7600.0).T)).to(w.device)
    min_level = float(np.exp(-100 / 20 * np.log(10)))
    d_db = 20.0 * torch.log10(torch.clamp(mag @ fb, min=min_level)) - 16.0
    s = (d_db + 100.0) / 100.0
    logf0, voiced = track_f0(w, lo, hi)
    f0_norm = speaker_normalize_f0(logf0, voiced)
    T = min(s.shape[0], f0_norm.shape[0])
    return torch.cat([s[:T], f0_norm[:T, None],
                      quantize_f0_onehot(f0_norm[:T])], dim=1)


def condition_signal(wav: np.ndarray, seed: int = 0) -> np.ndarray:
    """The host half of extract_f0_func_audiofile: one appended sample
    when n % 256 == 0, a 5th-order 30 Hz Butterworth high-pass (filtfilt)
    and the 1e-6 dither. Returns the float64 signal the device half takes."""
    from scipy import signal

    x = np.asarray(wav, np.float64)
    if x.shape[0] % 256 == 0:
        x = np.concatenate([x, np.array([1e-06])])
    b, a = signal.butter(5, 30 / (SR / 2), "high")
    y = signal.filtfilt(b, a, x)
    prng = np.random.RandomState(seed)
    return y * 0.95 + (prng.rand(y.shape[0]) - 0.5) * 1e-06


def extract_frontend(wav: np.ndarray, gender: str = "F", seed: int = 0,
                     device: torch.device | str = DEFAULT_DEVICE
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """extract_f0_func_audiofile (extract_f0_func.py:95-127). Returns
    (S (T, 80), f0_norm (T,), f0_onehot (T, 257))."""
    lo, hi = (50.0, 250.0) if gender == "M" else (100.0, 600.0)
    w = torch.as_tensor(condition_signal(wav, seed),
                        dtype=torch.float32).to(resolve_device(device))
    packed = frontend(w, lo, hi).cpu().numpy()
    return packed[:, :80], packed[:, 80].copy(), packed[:, 81:]


@dataclasses.dataclass
class AudioFeatures:
    mel_autovc: np.ndarray      # (T, 80) voice-normalized mel
    spk_emb: np.ndarray         # (256,) speaker embedding
    mel_raw: np.ndarray         # (T, 80) pre-AutoVC mel
    f0_norm: np.ndarray         # (T,) normalized f0


class AudioPipeline:
    """WAV -> AutoVC-normalized features, in chunks like the reference.

    The source speaker embedding comes from ``voice_encoder`` when one is
    given, and is zero otherwise, as in the JAX pipeline without
    voice-encoder weights (AutoVC conditions on the target Obama embedding
    either way).
    """

    def __init__(self, autovc: AutoVCGenerator,
                 voice_encoder: VoiceEncoder | None = None,
                 chunk: int = 4096, device: torch.device | str = DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.autovc = autovc.to(self.device).eval()
        self.voice_encoder = (None if voice_encoder is None
                              else voice_encoder.to(self.device).eval())
        self.chunk = chunk

    def speaker_embedding(self, wav: np.ndarray) -> np.ndarray:
        if self.voice_encoder is None:
            return np.zeros(256, np.float32)
        return get_spk_emb(self.voice_encoder, wav)

    def __call__(self, wav: np.ndarray, gender: str = "F") -> AudioFeatures:
        wav = normalize_dbfs(wav)
        mel, f0_norm, f0_oh = extract_frontend(wav, gender,
                                               device=self.device)
        emb = self.speaker_embedding(wav)
        dev = self.device
        emb_t = torch.as_tensor(emb, dtype=torch.float32, device=dev)[None]
        trg_t = torch.as_tensor(assets.obama_speaker_emb(),
                                dtype=torch.float32, device=dev)[None]
        outs = []
        for i in range(0, mel.shape[0], self.chunk):
            m = mel[i: i + self.chunk]
            f = f0_oh[i: i + self.chunk]
            pad = (-m.shape[0]) % 32
            m = np.pad(m, ((0, pad), (0, 0)))
            f = np.pad(f, ((0, pad), (0, 0)))
            _, post, _ = self.autovc(
                torch.as_tensor(m, device=dev)[None], emb_t, trg_t,
                torch.as_tensor(f, device=dev)[None])
            outs.append(post[0, : post.shape[1] - pad].cpu().numpy())
        return AudioFeatures(mel_autovc=np.concatenate(outs, axis=0),
                             spk_emb=emb, mel_raw=mel, f0_norm=f0_norm)


def normalize_audio_features(au: np.ndarray) -> np.ndarray:
    """Normalize by the vendored mean/std (audio2landmark_dataset.py:47-53)."""
    mean, std = assets.autovc_mel_au_mean_std()
    return ((au - mean) / std).astype(np.float32)
