"""Module1's image-translation (MakeItTalk texture renderer) trainer. Port
of ``animateportrait_tpu/train/image_translation.py``
(Module1/src/approaches/train_image_translation.py): the ResUnet over a
6-channel input (reference frame + landmark sketch) in training mode,
L1 + VGG perceptual + Gram style losses (:205-210), Adam. NCHW.
"""
from __future__ import annotations

import dataclasses

import torch

from animateportrait_tpu_torch.models.image_translation import (
    ResUnetGenerator, Vgg19Features, vgg_loss)
from animateportrait_tpu_torch.train.optim import AdamTrainer
from animateportrait_tpu_torch.utils.device import (
    DEFAULT_DEVICE, resolve_device)


@dataclasses.dataclass(frozen=True)
class ImageTranslationConfig:
    lr: float = 1e-4
    num_downs: int = 6
    ngf: int = 64
    use_vgg: bool = True


def build_generator(cfg: ImageTranslationConfig) -> ResUnetGenerator:
    return ResUnetGenerator(input_nc=6, output_nc=3,
                            num_downs=cfg.num_downs, ngf=cfg.ngf)


class ImageTranslationTrainer(AdamTrainer):
    """step(image_in (N,6,H,W), image_out (N,3,H,W)) -> {"loss", "l1",
    "vgg", "style"}; the VGG (frozen, eval) only with ``cfg.use_vgg``."""

    span_prefix = "imtrans"

    def __init__(self, cfg: ImageTranslationConfig, model: ResUnetGenerator,
                 vgg: Vgg19Features | None = None,
                 device: torch.device | str = DEFAULT_DEVICE):
        dev = resolve_device(device)
        super().__init__(model, dev, cfg.lr)
        self.cfg = cfg
        self.vgg = vgg.to(dev).eval().requires_grad_(False) \
            if vgg is not None else None

    def losses(self, image_in, image_out) -> dict[str, torch.Tensor]:
        g_out = self.model(image_in)
        l1 = torch.mean(torch.abs(g_out - image_out))
        if self.cfg.use_vgg and self.vgg is not None:
            lv, ls = vgg_loss(self.vgg, g_out, image_out, style=True)
        else:
            lv = ls = torch.zeros((), device=l1.device)
        return {"loss": l1 + lv + ls, "l1": l1, "vgg": lv, "style": ls}
