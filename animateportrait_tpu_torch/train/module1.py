"""Module1 trainers: the content branch and the speaker-aware branch. Port
of ``animateportrait_tpu/train/module1.py`` (the reference's
Module1/src/approaches/train_content.py:80-141 and
train_speaker_aware.py:177-339): the lip-openness-weighted L1, the
motion-delta loss, the Laplacian smoothness over the 68-point rings and
(speaker branch) the quaternion + translation head-pose loss, each step
one Adam update with optax.adam's defaults.

Each trainer is an ``AdamTrainer`` (``train/optim.py``): ``step`` runs
one forward in training mode (the content net's BatchNorms update their
running statistics as flax's do), one backward and one update, and
leaves the step's gradients in the parameters' ``.grad``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from animateportrait_tpu_torch.models.audio2landmark import (
    Audio2landmarkContent, Audio2landmarkSpeakerAware)
from animateportrait_tpu_torch.train.optim import AdamTrainer
from animateportrait_tpu_torch.utils.device import (
    DEFAULT_DEVICE, resolve_device)


def laplacian_rings() -> tuple[np.ndarray, np.ndarray]:
    """The reference's n1/n2 neighbour index rings (train_content.py:
    112-117)."""
    n1 = ([1] + list(range(0, 16)) + [18] + list(range(17, 21)) + [23]
          + list(range(22, 26)) + [28] + list(range(27, 35)) + [41]
          + list(range(36, 41)) + [47] + list(range(42, 47)) + [59]
          + list(range(48, 59)) + [67] + list(range(60, 67)))
    n2 = (list(range(1, 17)) + [15] + list(range(18, 22)) + [20]
          + list(range(23, 27)) + [25] + list(range(28, 36)) + [34]
          + list(range(37, 42)) + [36] + list(range(43, 48)) + [42]
          + list(range(49, 60)) + [48] + list(range(61, 68)) + [60])
    return np.asarray(n1), np.asarray(n2)


def laplacian_l1(pred_flat: torch.Tensor, gt_flat: torch.Tensor
                 ) -> torch.Tensor:
    """Mean |L(pred) - L(gt)| of the 68-point mesh Laplacians."""
    n1, n2 = (torch.as_tensor(n, device=pred_flat.device)
              for n in laplacian_rings())
    v = pred_flat.reshape(-1, 68, 3)
    g = gt_flat.reshape(-1, 68, 3)
    lv = v - 0.5 * (v[:, n1] + v[:, n2])
    lg = g - 0.5 * (g[:, n1] + g[:, n2])
    return torch.mean(torch.abs(lv - lg))


@dataclasses.dataclass(frozen=True)
class ContentConfig:
    lr: float = 1e-3
    use_lip_weight: bool = True
    use_motion_loss: bool = True
    lambda_laplacian: float = 1.0


class ContentTrainer(AdamTrainer):
    """step(fls (N,W,204), aus (N,W,80), face_id (1,204)) -> {"loss"}."""

    span_prefix = "m1_content"

    def __init__(self, cfg: ContentConfig, model: Audio2landmarkContent,
                 device: torch.device | str = DEFAULT_DEVICE):
        super().__init__(model, resolve_device(device), cfg.lr)
        self.cfg = cfg

    def losses(self, fls, aus, face_id) -> dict[str, torch.Tensor]:
        cfg = self.cfg
        fls_gt = fls[:, 0, :]
        fl_dis_pred, _ = self.model(aus, face_id)
        pred = fl_dis_pred + face_id[0:1]
        if cfg.use_lip_weight:
            w = torch.abs(fls[:, 0, 66 * 3 + 1] - fls[:, 0, 62 * 3 + 1])
            w = 1.0 / (w * 4.0 + 0.1)
            lip_w = torch.ones_like(pred)
            lip_w[:, 48 * 3:] = w[:, None]
            loss = torch.mean(torch.abs(pred - fls_gt) * lip_w)
        else:
            loss = torch.mean(torch.abs(pred - fls_gt))
        if cfg.use_motion_loss:
            loss = loss + torch.mean(torch.abs(
                (fl_dis_pred[:-1] - fl_dis_pred[1:])
                - (fls_gt[:-1] - fls_gt[1:])))
        if cfg.lambda_laplacian > 0:
            loss = loss + laplacian_l1(pred, fls_gt)
        return {"loss": loss}


@dataclasses.dataclass(frozen=True)
class SpeakerAwareConfig:
    lr: float = 1e-3
    emb_coef: float = 3.0
    lambda_laplacian: float = 1.0
    pos_dim: int = 7


class SpeakerAwareTrainer(AdamTrainer):
    """step(aus (T,W,80), embs (T,256), face_id (1,204), reg_fls_gt
    (T,204), rot_quat (T,4), rot_trans (T,3,4), z=None, generator=None)
    -> {"loss", "reg", "lap", "pos"}: train_speaker_aware.py:255-339
    without the frozen content net's residual path, as the JAX step. z is
    the unit normal draw of the speaker code's noise (drawn from
    ``generator`` when not given)."""

    span_prefix = "m1_speaker"

    def __init__(self, cfg: SpeakerAwareConfig,
                 model: Audio2landmarkSpeakerAware,
                 device: torch.device | str = DEFAULT_DEVICE):
        super().__init__(model, resolve_device(device), cfg.lr)
        self.cfg = cfg

    def losses(self, aus, embs, face_id, reg_fls_gt, rot_quat, rot_trans,
               z=None, generator=None) -> dict[str, torch.Tensor]:
        cfg = self.cfg
        fl_dis_pred, pos_pred, _, _ = self.model(
            aus, embs * cfg.emb_coef, face_id, add_z_spk=True, z=z,
            generator=generator)
        pred = fl_dis_pred + face_id[0:1]
        loss_reg = torch.mean(torch.abs(pred - reg_fls_gt))
        # the reference adds face_id twice inside its Laplacian term
        # (train_speaker_aware.py:300,316), kept as it is
        loss_lap = laplacian_l1(pred + face_id[0:1], reg_fls_gt) \
            if cfg.lambda_laplacian > 0 else pred.new_zeros(())
        if cfg.pos_dim == 7:
            pos_gt = torch.cat([rot_quat, rot_trans[:, :, 3]], dim=1)
        else:
            pos_gt = rot_trans.reshape(-1, 12)
        loss_pos = torch.mean(torch.abs(pos_pred - pos_gt))
        loss = loss_reg + loss_lap * cfg.lambda_laplacian + loss_pos
        return {"loss": loss, "reg": loss_reg, "lap": loss_lap,
                "pos": loss_pos}
