"""The batched front end: MTCNN over many photos and landmark prediction
over many audios. Port of ``animateportrait_tpu/pipeline/batch.py``.

``detect_faces_batch`` runs PNet once per pyramid level on the stacked
photos and RNet and ONet once on every photo's candidates; the NMS runs
photo by photo on the host, as for one photo
(``models/mtcnn.py:MTCNNDetector.detect_batch``).

``BatchedLandmarkPredictor`` groups the audios by window count: each
512-window segment of a group is one call of
``pipeline/landmark.py:LandmarkPredictor._segment`` with the group as its
batch (a segment is one attention sequence, so the batch is across
audios, never along time), the body the single predictor runs with a
batch of one; then the nose-top revision and the final smoothing per
audio, as the single predictor does.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from animateportrait_tpu_torch.ops.filters import savgol_filter
from animateportrait_tpu_torch.pipeline.landmark import (
    SEG_BS, LandmarkPredictor, revise_nose_top)


def detect_faces_batch(detector, imgs: np.ndarray,
                       min_face_size: float = 20.0,
                       thresholds=(0.6, 0.7, 0.8),
                       nms_thresholds=(0.7, 0.7, 0.7)) -> list:
    """MTCNN over a stack of same-size RGB images (B, H, W, 3) -> a list
    of (boxes (k, 5), landmarks (k, 10)) per image, those of the detector
    called on each image alone."""
    return detector.detect_batch(imgs, min_face_size, thresholds,
                                 nms_thresholds)


class BatchedLandmarkPredictor:
    """Runs a ``LandmarkPredictor`` (its nets, amplitudes and device) for
    many audios at once; per audio the numbers are those of the predictor
    alone, to float rounding."""

    def __init__(self, predictor: LandmarkPredictor):
        self.p = predictor

    @torch.inference_mode()
    def __call__(self, windows_list, embs, face_ids) -> list[np.ndarray]:
        """windows_list: one (T_i, 18, 80) array per audio; embs: one
        (256,) each; face_ids: one (1, 204) each -> one (T_i, 204) float32
        array per audio, (0, 204) for an audio of fewer than 10 windows."""
        dev = self.p.device
        groups = collections.defaultdict(list)
        for i, w in enumerate(windows_list):
            groups[w.shape[0]].append(i)
        results: dict[int, np.ndarray] = {}
        for T, idxs in groups.items():
            if T < 10:
                for i in idxs:
                    results[i] = np.zeros((0, 204), np.float32)
                continue
            aus = torch.as_tensor(np.stack([windows_list[i] for i in idxs]),
                                  dtype=torch.float32, device=dev)
            emb = torch.as_tensor(np.stack([np.asarray(embs[i]) for i in idxs]),
                                  dtype=torch.float32, device=dev)
            fids = torch.as_tensor(np.stack(
                [np.asarray(face_ids[i]).reshape(1, 204) for i in idxs]),
                dtype=torch.float32, device=dev)
            segs = []
            for j in range(0, T, SEG_BS):
                seg = aus[:, j: j + SEG_BS]
                if seg.shape[1] < 10:
                    continue
                segs.append(self.p._segment(
                    seg, emb[:, None].expand(-1, seg.shape[1], -1), fids))
            fl = torch.cat(segs, dim=1)
            for k, i in enumerate(idxs):
                results[i] = savgol_filter(revise_nose_top(fl[k]), 5,
                                           3).cpu().numpy()
        return [results[i] for i in range(len(windows_list))]
