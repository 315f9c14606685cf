"""The audio2landmark training datasets: the reference's pickle dumps.
Port of ``animateportrait_tpu/data/audio2landmark.py``
(Module1/src/dataset/audio2landmark/audio2landmark_dataset.py): the
``{name}_{status}_{au,fl}.pickle`` dumps (lists of (array, info) tuples)
shuffled with the reference's ``random.Random(0)``, audio normalized by
the vendored mean/std (:47-53) and collated into 18-frame stride-1
windows (:63-84); the speaker-aware branch's dataset with its gaze pickle
(:169-288) and the registration that produces that pickle (:111-165),
with quaternions in scipy's (x, y, z, w) order. Host numpy, as the JAX
module; the ICP runs through the port's ``ops/geometry.py`` in float64.
"""
from __future__ import annotations

import os
import pickle
import random

import numpy as np
import torch

from animateportrait_tpu_torch.pipeline.audio import normalize_audio_features
from animateportrait_tpu_torch.pipeline.landmark import sliding_windows
from animateportrait_tpu_torch.utils.assets import (
    T_SHAPE_IDX, anchor_t_shape_9)


def _load(dump_dir: str, name: str):
    with open(os.path.join(dump_dir, name), "rb") as fp:
        return pickle.load(fp)


def estimate_neck(fl: np.ndarray) -> np.ndarray:
    """audio2landmark_dataset.py:108-110."""
    mid_ch = (fl[2, :] + fl[14, :]) * 0.5
    return (mid_ch * 2 - fl[33, :]).reshape(1, 3)


class Audio2landmarkDataset:
    """The fl/au pickle dumps as windowed training items."""

    def __init__(self, dump_dir: str, dump_name: str = "random",
                 status: str = "val", num_window_frames: int = 18,
                 num_window_step: int = 1, normalize_au: bool = True):
        self.num_window_frames = num_window_frames
        self.num_window_step = num_window_step
        self.fl_data = _load(dump_dir, f"{dump_name}_{status}_fl.pickle")
        self.au_data = _load(dump_dir, f"{dump_name}_{status}_au.pickle")
        # the reference's shuffle with its fixed seed (:40-45)
        valid_idx = list(range(len(self.au_data)))
        random.Random(0).shuffle(valid_idx)
        self.fl_data = [self.fl_data[i] for i in valid_idx]
        self.au_data = [self.au_data[i] for i in valid_idx]
        if normalize_au:
            self.au_data = [(normalize_audio_features(au), info)
                            for au, info in self.au_data]

    def __len__(self):
        return len(self.fl_data)

    def __getitem__(self, item):
        return self.fl_data[item], self.au_data[item]

    def collate_in_segments(self, batch):
        """(fls (N,W,204), aus (N,W,80), embs (N,256)) over the stride-1
        windows of every clip in ``batch`` (:63-84)."""
        fls, aus, embs = [], [], []
        w, s = self.num_window_frames, self.num_window_step
        for (fl, _), (au, au_info) in batch:
            assert fl.shape[0] == au.shape[0]
            fls.append(sliding_windows(np.asarray(fl, np.float32), w, s))
            aus.append(sliding_windows(np.asarray(au, np.float32), w, s))
            emb = np.asarray(au_info[2], np.float32).reshape(-1)
            embs.append(np.tile(emb[None], (fls[-1].shape[0], 1)))
        return (np.concatenate(fls), np.concatenate(aus),
                np.concatenate(embs))


# the reference's 11 speakers of the speaker-aware branch's filter
_11SPK = ('48uYS3bHIA8', 'E0zgrhQ0QDw', 'E_kmpT-EfOg', 'J-NPsvtQ8lE',
          'Z7WRt--g-h4', '_ldiVrXgZKc', 'irx71tYyI-Q', 'sxCbrYjBsGA',
          'wAAMEC1OsRc', 'W6uRNCJmdtI', 'bXpavyiCu10')


def _quat_from_matrix(m: np.ndarray) -> np.ndarray:
    """Rotation matrices -> quaternions in scipy's (x, y, z, w) order."""
    from scipy.spatial.transform import Rotation
    return Rotation.from_matrix(m).as_quat()


def default_anchor_t_shape() -> np.ndarray:
    """ANCHOR_T_SHAPE_9 normalized the reference's way (:116-122)."""
    anchor = anchor_t_shape_9()
    s = np.abs(anchor[5, 0] - anchor[8, 0])
    anchor = anchor / s
    return anchor - np.mean(anchor[[4, 5, 8], :], axis=0)


def norm_output_fls_rot(fl_data: np.ndarray,
                        anchor_t_shape: np.ndarray | None = None
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Register every frame's 9 anchor landmarks onto the anchor T-shape by
    ICP (:111-153): (rot_trans (T,3,4), rot_quats (T,4) xyzw, registered
    fls (T,68,3)), the producer of the ``_gaze.pickle`` dumps."""
    from animateportrait_tpu_torch.ops.geometry import icp

    if anchor_t_shape is None:
        anchor_t_shape = default_anchor_t_shape()
    else:
        anchor_t_shape = anchor_t_shape.reshape(68, 3)[list(T_SHAPE_IDX)]
    fl = fl_data.reshape(-1, 68, 3).astype(np.float64)
    anchor = torch.from_numpy(np.asarray(anchor_t_shape, np.float64))
    t_hom = np.stack([
        icp(torch.from_numpy(f[list(T_SHAPE_IDX)]), anchor)[0].numpy()
        for f in fl])
    rot = t_hom[:, :3, :3]
    trans = t_hom[:, :3, 3]
    fl = np.einsum("tij,tpj->tpi", rot, fl) + trans[:, None, :]
    return t_hom[:, :3, :], _quat_from_matrix(rot), fl


def _signed_area(pts: np.ndarray) -> float:
    x, y = pts[:, 0], pts[:, 1]
    return 0.5 * np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)


def close_face_lip(fl: np.ndarray) -> int:
    """Index of the frame with the most closed mouth (:155-165)."""
    fl = fl.reshape(-1, 68, 3)
    areas = [abs(float(_signed_area(f[60:68, 0:2]))) for f in fl]
    return int(np.argmin(areas))


class SpeakerAwareDataset:
    """Speaker_aware_branch_Dataset (:169-288): the au/fl dumps and the
    gaze pickle (rot_trans, rot_quat, anchor_t_shape), the optional
    11-speaker filter, the fixed-seed shuffle, mean/std audio
    normalization."""

    def __init__(self, dump_dir: str, dump_name: str = "random",
                 status: str = "val", num_window_frames: int = 18,
                 num_window_step: int = 1, use_11spk_only: bool = False,
                 noautovc: str = ""):
        self.num_window_frames = num_window_frames
        self.num_window_step = num_window_step
        self.au_data = _load(dump_dir,
                             f"{dump_name}_{status}_{noautovc}au.pickle")
        self.fl_data = _load(dump_dir,
                             f"{dump_name}_{status}_{noautovc}fl.pickle")
        gaze = _load(dump_dir, f"{dump_name}_{status}_gaze.pickle")
        self.rot_trans = gaze["rot_trans"]
        self.rot_quats = gaze["rot_quat"]
        self.anchor_t_shape = gaze["anchor_t_shape"]
        valid_idx = [i for i, fl in enumerate(self.fl_data)
                     if not use_11spk_only
                     or fl[1][1][:-4].split("_x_")[1] in _11SPK]
        random.Random(0).shuffle(valid_idx)
        for name in ("fl_data", "au_data", "rot_trans", "rot_quats",
                     "anchor_t_shape"):
            src = getattr(self, name)
            setattr(self, name, [src[i] for i in valid_idx])
        self.au_data = [(normalize_audio_features(au), info)
                        for au, info in self.au_data]

    def __len__(self):
        return len(self.fl_data)

    def __getitem__(self, item):
        return (self.fl_data[item], self.au_data[item],
                self.rot_trans[item], self.rot_quats[item],
                self.anchor_t_shape[item])

    def collate_in_segments(self, batch):
        """(fls, aus, embs, regist_fls, rot_trans, rot_quats) over the
        stride-1 windows; rot_trans has [I | 0] subtracted (:263-266)."""
        out = [[] for _ in range(6)]
        w, s = self.num_window_frames, self.num_window_step
        minus_eye = np.concatenate(
            [np.eye(3), np.zeros((3, 1))], axis=1)[None]
        for fl, au, rot_tran, rot_quat, anchor in batch:
            fl_data, au_data, emb = fl[0], au[0], au[1][2]
            assert fl_data.shape[0] == au_data.shape[0]
            fls = sliding_windows(np.asarray(fl_data, np.float32), w, s)
            n = fls.shape[0]
            for dst, x in zip(out, (
                    fls,
                    sliding_windows(np.asarray(au_data, np.float32), w, s),
                    np.tile(np.asarray(emb, np.float32).reshape(-1)[None],
                            (n, 1)),
                    sliding_windows(np.asarray(anchor, np.float32)
                                    .reshape(-1, 204), w, s),
                    sliding_windows(np.asarray(rot_tran, np.float32)
                                    - minus_eye, w, s),
                    sliding_windows(np.asarray(rot_quat, np.float32), w, s))):
                dst.append(x)
        return tuple(np.concatenate(x) for x in out)
