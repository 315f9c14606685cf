"""Faults planted in the pose-transfer trainer's timed path, as
``faults.py`` plants the other cells' ones: the state left unchanged, and
the DualUnet's feature warps skipped. Their readings bound the
``pose_transfer_train`` limits from above. Run as ``calibrate.py``, with
these faults among ``--fault``'s choices:

    python3 portbench/pose_faults.py --workload pose.step --seconds 5 \\
        --seeds 11 12 13 --fault no_feature_warp"""
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _unchanged():
    """A train step that leaves G's and D's parameters as they were: the
    losses, gradients and BatchNorm statistics are computed, no update
    lands."""
    from animateportrait_tpu_torch.train import pose_transfer as pt

    step = pt.PoseTransferTrainer.step

    def keep(self, batch):
        params = list(self.g.parameters()) + list(self.d.parameters())
        start = [p.detach().clone() for p in params]
        metrics = step(self, batch)
        with torch.no_grad():
            for p, s in zip(params, start):
                p.copy_(s)
        return metrics

    return pt.PoseTransferTrainer, "step", keep


def _no_feature_warp():
    """The DualUnet's appearance skips left where they are: its
    ``warp_acc_flow`` returns the features unwarped (the source image's
    warp, elsewhere, is kept)."""
    from animateportrait_tpu_torch.models import flowunet_extra

    def unwarped(x, flow, mask=None, mask_value=-1.0):
        return x

    return flowunet_extra, "warp_acc_flow", unwarped


FAULTS = {"unchanged_pose": _unchanged, "no_feature_warp": _no_feature_warp}


def main(argv=None) -> int:
    sys.path[0] = ROOT
    from portbench import calibrate, faults

    faults.FAULTS.update(FAULTS)
    return calibrate.main(argv)


if __name__ == "__main__":
    sys.exit(main())
