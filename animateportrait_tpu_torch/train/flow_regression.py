"""Intrinsic-flow regressor training (the provenance of the frozen netF).
Port of ``animateportrait_tpu/train/flow_regression.py``
(Module2/intrinsic_flow_models/{flow_regression_model,modules}.py): the
masked L1/L2/EPE flow metrics, the flownet2-style MultiScaleFlowLoss
(avg/max-pool pyramid, div_flow 0.05, weights 0.32/2^s), the
segmentation-sensitive flow loss, the cross-entropy visibility loss and
the Adam step over FlowUnet in training mode. Flows are NCHW (N, 2, H, W)
in (dx, dy) order; masks (N, 1, H, W).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from animateportrait_tpu_torch.models.flowunet import (
    FlowUnet, kp_to_map_binary)
from animateportrait_tpu_torch.ops.warp import warp_acc_flow
from animateportrait_tpu_torch.train.optim import AdamTrainer
from animateportrait_tpu_torch.utils.device import (
    DEFAULT_DEVICE, resolve_device)


def _per_item(err: torch.Tensor, mask: torch.Tensor, denom: float
              ) -> torch.Tensor:
    bsz = err.shape[0]
    count = mask.reshape(bsz, -1).sum(dim=1, keepdim=True)
    return (err.reshape(bsz, -1) / (count * bsz * denom + 1e-8)).sum()


def masked_l1(inp, tgt, mask):
    """modules.L1 (:374-384)."""
    return _per_item(torch.abs(tgt - inp) * mask, mask, 2.0)


def masked_l2(inp, tgt, mask):
    return _per_item(torch.linalg.norm(tgt - inp, dim=1, keepdim=True)
                     * mask, mask, 1.0)


def epe(inp, tgt, mask):
    """modules.EPE (:361-372)."""
    return masked_l2(inp, tgt, mask)


def multi_scale_flow_loss(flow_pyramid, target_flow, vis_mask,
                          start_scale: int = 2, l_weight: float = 0.32,
                          div_flow: float = 0.05, loss_type: str = "l1"):
    """MultiScaleFlowLoss (modules.py:400-429): (loss, epe)."""
    loss_fn = masked_l1 if loss_type == "l1" else masked_l2
    target = target_flow * div_flow
    loss = e = 0.0
    for i, inp in enumerate(flow_pyramid):
        k = start_scale * (2 ** i)
        t = F.avg_pool2d(target, k, k)
        m = F.max_pool2d(vis_mask, k, k)
        w = l_weight / (2 ** i)
        loss = loss + w * loss_fn(inp, t, m)
        e = e + w * epe(inp, t, m)
    return loss, e


def ss_flow_loss(input_flow, target_flow, seg_1, seg_2, vis_2,
                 loss_type: str = "l1", div_flow: float = 0.05):
    """modules.SS_FlowLoss (:431-460): the flow error only where the
    predicted flow lands in a wrong segmentation region of the source.
    input_flow/target_flow (N,2,H,W) in pixels; seg_1/seg_2 (N,ns,H,W)
    one-hot with channel 0 the background; vis_2 (N,H,W) or (N,1,H,W).
    The mask is built without gradient, as the reference's no_grad."""
    if vis_2.dim() == 3:
        vis_2 = vis_2[:, None]
    with torch.no_grad():
        seg_1w = (warp_acc_flow(seg_1[:, 1:], input_flow) > 0).to(
            input_flow.dtype)
        mask = torch.sum(seg_2[:, 1:] * (1.0 - seg_1w), dim=1, keepdim=True)
        mask = mask * (vis_2 == 0).to(input_flow.dtype)
    err = (input_flow - target_flow) * div_flow * mask
    if loss_type == "l1":
        return torch.mean(torch.abs(err))
    return torch.mean(torch.linalg.norm(err, dim=1))


@dataclasses.dataclass(frozen=True)
class FlowRegConfig:
    lr: float = 2e-4
    beta1: float = 0.9
    num_scale: int = 4
    loss_weight_vis: float = 1.0
    # --use_ss_flow_loss (flow_regression_model.py:47-48,123-124)
    use_ss_flow_loss: bool = False
    loss_weight_flow_ss: float = 1.0


class FlowRegTrainer(AdamTrainer):
    """step(kp1 (N,68,2), kp2 (N,68,2), flow_gt (N,2,224,224), vis_gt
    (N,224,224) int {0,1,2}[, seg_1, seg_2]) -> {"loss", "flow", "vis",
    "epe"[, "flow_ss"]}: the joint-heatmap input type
    (flow_regression_model.py:94-129)."""

    span_prefix = "flowreg"

    def __init__(self, cfg: FlowRegConfig, model: FlowUnet,
                 device: torch.device | str = DEFAULT_DEVICE):
        super().__init__(model, resolve_device(device), cfg.lr, cfg.beta1)
        self.cfg = cfg

    def losses(self, kp1, kp2, flow_gt, vis_gt, seg_1=None, seg_2=None
               ) -> dict[str, torch.Tensor]:
        cfg = self.cfg
        inp = torch.cat([kp_to_map_binary((224, 224), kp1),
                         kp_to_map_binary((224, 224), kp2)], dim=1)
        flow_out, vis_out, flow_pyr, _ = self.model(inp)
        vis_mask = (vis_gt < 2).float()[:, None]
        l_flow, e = multi_scale_flow_loss(flow_pyr, flow_gt, vis_mask)
        logp = F.log_softmax(vis_out, dim=1)
        l_vis = -torch.mean(torch.gather(logp, 1, vis_gt[:, None].long()))
        loss = l_flow + cfg.loss_weight_vis * l_vis
        m = {"loss": loss, "flow": l_flow, "vis": l_vis, "epe": e}
        if cfg.use_ss_flow_loss:
            m["flow_ss"] = ss_flow_loss(flow_out * 20.0, flow_gt, seg_1,
                                        seg_2, vis_gt)
            m["loss"] = loss + cfg.loss_weight_flow_ss * m["flow_ss"]
        return m
