"""Audio -> landmark inference with the full post chain. Port of
``animateportrait_tpu/pipeline/landmark.py`` (reference:
Module1/src/approaches/train_audio2landmark.py:101-351,594-617).

Per 512-frame segment, on the device: the pos branch, Savitzky-Golay
smoothing, the close-mouth blend, the content branch with its min-K
calibration, and the inverse-lip fix; then the nose-top revision and a
final 5-tap smoothing over the whole track.
"""
from __future__ import annotations

import numpy as np
import torch

from animateportrait_tpu_torch.models.audio2landmark import (
    Audio2landmarkContent, Audio2landmarkPos)
from animateportrait_tpu_torch.ops.filters import savgol_filter
from animateportrait_tpu_torch.ops.geometry import area_of_signed_polygon
from animateportrait_tpu_torch.utils.device import (
    DEFAULT_DEVICE, resolve_device)

SEG_BS = 512
NUM_WINDOW_FRAMES = 18

_OUT_UP = list(range(49, 54))      # outer-lip upper arc
_OUT_LO = list(range(59, 54, -1))  # outer-lip lower arc (reversed pairs)
_IN_UP = list(range(61, 64))       # inner-lip upper arc
_IN_LO = list(range(67, 64, -1))   # inner-lip lower arc


def sliding_windows(au: np.ndarray, window: int = NUM_WINDOW_FRAMES,
                    step: int = 1) -> np.ndarray:
    """(T, 80) -> (T-window, window, 80) stride-1 windows (the reference
    collate drops the final window)."""
    T = au.shape[0]
    idx = np.arange(0, T - window, step)[:, None] + np.arange(window)[None, :]
    return au[idx]


def close_mouth_blend(fl: torch.Tensor, ratio: float = 0.99) -> torch.Tensor:
    """Blend the upper/lower lip arcs toward their midline
    (train_audio2landmark.py:118-129). fl: (T, 68, 3)."""
    fl = fl.clone()
    for up, lo in ((_OUT_UP, _OUT_LO), (_IN_UP, _IN_LO)):
        mean = 0.5 * (fl[:, up] + fl[:, lo])
        new_up = mean * ratio + fl[:, up] * (1 - ratio)
        new_lo = mean * ratio + fl[:, lo] * (1 - ratio)
        fl[:, up] = new_up
        fl[:, lo] = new_lo
    return fl


def calibrate_content(baseline: torch.Tensor, amp_lip_x: float,
                      amp_lip_y: float, ratio: float = 0.5) -> torch.Tensor:
    """Per-coordinate min-K de-biasing + lip amplification
    (train_audio2landmark.py:235-245). baseline: (T, 204)."""
    K = int(baseline.shape[0] * ratio)
    m = torch.sort(baseline, dim=0).values[:K].mean(dim=0, keepdim=True)
    out = baseline - m
    lip = torch.arange(48, 68, device=baseline.device)
    out[:, lip * 3] *= amp_lip_x
    out[:, lip * 3 + 1] *= amp_lip_y
    return out


def _collapse_inner_lip(f: torch.Tensor) -> torch.Tensor:
    """Collapse inner-lip pairs 63/65, 62/66, 61/67 to their means.
    f: (T, 68, 3)."""
    f = f.clone()
    for up, lo in ((63, 65), (62, 66), (61, 67)):
        mean = 0.5 * (f[:, up] + f[:, lo])
        f[:, lo] = mean
        f[:, up] = mean
    return f


def _lip_y_offsets(f: torch.Tensor) -> torch.Tensor:
    """The y offsets the inversion fix carries from the previous frame:
    rows 55..58 - 64..67, 59 - 60, 49..53 - 60..64. f: (T, 68, 3)."""
    y = f[..., 1]
    return torch.cat([y[:, 55:59] - y[:, 64:68], y[:, 59:60] - y[:, 60:61],
                      y[:, 49:54] - y[:, 60:65]], dim=1)


def solve_inverse_lip(fl: torch.Tensor) -> torch.Tensor:
    """The reference's mouth-inversion fix over a (T, 204) segment
    (train_audio2landmark.py:594-617), without a per-frame loop.

    A frame whose inner-lip polygon has negative area gets its inner lip
    collapsed and its outer-lip y values rebuilt as ``inner + offset``,
    where ``offset`` is the previous *fixed* frame's outer-minus-inner y
    difference. A fixed frame inherits its predecessor's offsets exactly,
    so the offset of any frame is that of the latest frame before it that
    was left alone (or of frame 0, which is only collapsed): a running
    maximum of indices replaces the JAX ``lax.scan``. The sums associate
    differently from the scan, so results agree to float rounding.
    """
    T = fl.shape[0]
    f = fl.reshape(T, 68, 3)
    neg = area_of_signed_polygon(f[:, 60:68, 0:2]) < 0
    col = _collapse_inner_lip(f)
    base = torch.where(neg[:, None, None], col, f)  # collapse where negative
    idx = torch.arange(T, device=fl.device)
    keep = ~neg
    keep[0] = True
    src = torch.cummax(torch.where(keep, idx, torch.zeros_like(idx)),
                       dim=0).values
    prev = torch.cat([idx[:1], src[:-1]])   # offset source for each frame
    off = _lip_y_offsets(base)[prev]
    y = base[..., 1].clone()
    y[:, 55:59] = y[:, 64:68] + off[:, 0:4]
    y[:, 59:60] = y[:, 60:61] + off[:, 4:5]
    y[:, 49:54] = y[:, 60:65] + off[:, 5:10]
    fixed = base.clone()
    fixed[..., 1] = y
    transfer = neg & (idx > 0)            # frame 0 is only collapsed
    out = torch.where(transfer[:, None, None], fixed, base)
    return out.reshape(T, 204)


def revise_nose_top(fl: torch.Tensor) -> torch.Tensor:
    """Extrapolate nose-top point 27 from 28/29 (:304). fl: (T, 204)."""
    fl = fl.clone()
    fl[:, 81:84] = fl[:, 84:87] * 2 - fl[:, 87:90]
    return fl


class LandmarkPredictor:
    """Drives the pos and content branches over audio windows, with the
    defaults of the reference's main_end2end_module2.py: amp_pos 0.5,
    amp_lip_x = amp_lip_y = 2."""

    def __init__(self, pos: Audio2landmarkPos, content: Audio2landmarkContent,
                 amp_pos: float = 0.5, amp_lip_x: float = 2.0,
                 amp_lip_y: float = 2.0, emb_coef: float = 3.0,
                 device: torch.device | str = DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.pos = pos.to(self.device).eval()
        self.content = content.to(self.device).eval()
        self.amp_pos = amp_pos
        self.amp_lip_x = amp_lip_x
        self.amp_lip_y = amp_lip_y
        self.emb_coef = emb_coef

    def _segment(self, aus: torch.Tensor, embs: torch.Tensor,
                 face_id: torch.Tensor, smooth_win: int = 31) -> torch.Tensor:
        T = aus.shape[0]
        z = torch.zeros((T, 128), dtype=torch.float32, device=aus.device)
        fl_dis, _, _ = self.pos(aus, embs * self.emb_coef, face_id, z)
        smooth_len = min(T - 1, smooth_win) // 2 * 2 + 1
        fl_dis = savgol_filter(fl_dis, smooth_len, 3)
        fl_dis = close_mouth_blend(fl_dis.reshape(-1, 68, 3)).reshape(-1, 204)
        fl_dis = fl_dis * self.amp_pos
        baseline, _ = self.content(aus[:, :NUM_WINDOW_FRAMES], face_id)
        baseline = calibrate_content(baseline, self.amp_lip_x, self.amp_lip_y)
        return solve_inverse_lip(fl_dis + baseline + face_id[0:1])

    def __call__(self, au_windows: np.ndarray, emb: np.ndarray,
                 face_id: np.ndarray) -> np.ndarray:
        """au_windows (T, 18, 80), emb (256,), face_id (1, 204) -> (T, 204).
        Segments of 512 windows; a trailing segment under 10 frames is
        dropped, as in the reference (:284-285)."""
        dev = self.device
        aus = torch.as_tensor(au_windows, dtype=torch.float32, device=dev)
        fid = torch.as_tensor(face_id, dtype=torch.float32,
                              device=dev).reshape(1, 204)
        T = aus.shape[0]
        emb_t = torch.as_tensor(emb, dtype=torch.float32,
                                device=dev)[None].expand(T, -1)
        outs = [self._segment(aus[j: j + SEG_BS], emb_t[j: j + SEG_BS], fid)
                for j in range(0, T, SEG_BS)
                if aus[j: j + SEG_BS].shape[0] >= 10]
        fl = revise_nose_top(torch.cat(outs, dim=0))
        return savgol_filter(fl, 5, 3).cpu().numpy()
