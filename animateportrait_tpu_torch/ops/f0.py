"""NCCF pitch tracker with RAPT's dynamic program. Port of
``animateportrait_tpu/ops/f0.py`` (see that module for the signal model
and why it substitutes for RAPT).

The batched parts — framing, the all-lag NCCF through an rFFT
cross-correlation, top-K candidates and their parabolic refinement — are
tensor ops on the signal's device. The Viterbi recursion is a loop over
frames (the JAX ``lax.scan``), and the backtrack walks the back-pointers
on the host, where indexing one state per frame costs no launch.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


SR = 16000
HOP = 256
FRAME_LEN = 280
N_CANDS = 12
# the DP weights the JAX package tuned against RAPT (its ops/f0.py)
VO_BIAS, TRANS_C, FREQ_WT, DOUBL_C, LAG_WT = 0.08, 0.05, 0.1, 0.35, 0.3


def track_f0(x: torch.Tensor, lo: float = 50.0, hi: float = 600.0
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Track f0 of a mono fp32 16 kHz signal (n,) in the band [lo, hi] Hz.
    Returns (logf0, voiced), both (n//256 + 1,): natural-log f0 with
    unvoiced = -1e10, and the voicing mask."""
    sr, hop, win, K = SR, HOP, FRAME_LEN, N_CANDS
    lag_min = int(sr / hi)
    lag_max = int(np.ceil(sr / lo))
    span = win + lag_max
    n = x.shape[0]
    n_frames = n // hop + 1
    dev = x.device

    xp = F.pad(x, (win // 2, span))
    frames = xp.unfold(0, span, hop)[:n_frames]           # (T, span)
    a = frames[:, :win]
    nfft = _next_pow2(span + win)
    fa = torch.fft.rfft(a, n=nfft)
    ff = torch.fft.rfft(frames, n=nfft)
    corr = torch.fft.irfft(torch.conj(fa) * ff, n=nfft)[:, : lag_max + 1]

    # RAPT's absolute energy floor (A_FACT at 16-bit scale, unit input)
    a_fact = 10000.0 / 32768.0 ** 2
    csum = torch.cumsum(frames * frames, dim=1)
    csum = torch.cat([torch.zeros_like(csum[:, :1]), csum], dim=1)
    lags = torch.arange(lag_max + 1, device=dev)
    ek = csum[:, lags + win] - csum[:, lags]
    e0 = csum[:, win:win + 1] - csum[:, 0:1]
    nccf = corr / torch.sqrt((e0 + a_fact) * (ek + a_fact))

    # candidates: top-K local maxima inside the lag band
    band = (lags >= lag_min) & (lags <= lag_max)
    neg_inf = torch.full_like(nccf[:, :1], -math.inf)
    left = torch.cat([neg_inf, nccf[:, :-1]], dim=1)
    right = torch.cat([nccf[:, 1:], neg_inf], dim=1)
    is_max = (nccf >= left) & (nccf >= right) & band[None, :]
    cand_score = torch.where(is_max, nccf, torch.full_like(nccf, -math.inf))
    cvals, cidx = torch.topk(cand_score, K, dim=1)
    have = torch.isfinite(cvals)
    cvals = torch.where(have, cvals, torch.zeros_like(cvals))

    # parabolic sub-lag refinement
    ym = torch.gather(nccf, 1, torch.clamp(cidx - 1, 0, lag_max))
    y0 = torch.gather(nccf, 1, torch.clamp(cidx, 0, lag_max))
    yp = torch.gather(nccf, 1, torch.clamp(cidx + 1, 0, lag_max))
    denom2 = ym - 2.0 * y0 + yp
    delta = torch.where(torch.abs(denom2) > 1e-8, 0.5 * (ym - yp) / denom2,
                        torch.zeros_like(denom2))
    delta = torch.clamp(delta, -0.5, 0.5)
    clag = torch.clamp(cidx.to(torch.float32) + delta, min=1.0)

    # RAPT's dynamic program over K voiced states + 1 unvoiced state
    local_v = torch.where(have, 1.0 - cvals * (1.0 - LAG_WT * clag / lag_max),
                          torch.full_like(cvals, 1e3))
    local_u = VO_BIAS + torch.max(cvals, dim=1).values
    local = torch.cat([local_v, local_u[:, None]], dim=1)    # (T, K+1)
    loglag = torch.log(clag)
    ln2 = float(np.log(2.0))
    tc = torch.zeros((K + 1, K + 1), dtype=torch.float32, device=dev)
    tc[:K, K] = TRANS_C                                      # U(prev) -> V
    tc[K, :K] = TRANS_C                                      # V(prev) -> U

    cost = local[0]
    bps = []
    for t in range(1, n_frames):
        d = torch.abs(loglag[t][:, None] - loglag[t - 1][None, :])
        step = tc.clone()
        step[:K, :K] = FREQ_WT * torch.minimum(d, DOUBL_C + torch.abs(d - ln2))
        tot = cost[None, :] + step
        best, bp = torch.min(tot, dim=1)
        cost = local[t] + best
        cost = cost - torch.min(cost)
        bps.append(bp)

    # backtrack on the host: bps[t-1] maps frame t's state to frame t-1's
    state = int(torch.argmin(cost))
    states = [state]
    for bp in (torch.stack(bps).cpu().numpy()[::-1] if bps else []):
        state = int(bp[state])
        states.append(state)
    states = torch.as_tensor(states[::-1], device=dev)
    voiced = states < K
    vstate = torch.clamp(states, max=K - 1)
    lag_trk = torch.gather(clag, 1, vstate[:, None])[:, 0]
    f0 = torch.clamp(sr / torch.clamp(lag_trk, min=1.0), lo, hi)
    logf0 = torch.where(voiced, torch.log(f0), torch.full_like(f0, -1e10))
    return logf0, voiced
