"""The training tree's static stylizations, ``<root>/fakeB_static/``: the
job of the JAX package's ``tools/make_fakeb_static.py``, on the card.

The UMLVD-IFW trainer (``data/umlvd_ifw.py``) reads, for each photo
``<root>/Photo/<name>``, its static stylization
``<root>/fakeB_static/<name>``. This module runs the static net over every
``*.png`` and ``*.jpg`` of ``Photo/``:

- drawing: the static drawing net (``models/gan.py:ResnetStyle2Generator``)
  on the photo at 512^2, with the fixed style map [0, 1, 0] at 128^2;
- cartoon: Photo2Cartoon (``models/photo2cartoon.py``, ``genA2B`` of its
  checkpoint) at 256^2.

A photo is read as ``cv2.imread`` reads it (``utils/image.py:read_image``),
resized with ``resize_bicubic`` (``cv2.INTER_CUBIC``; OpenCV runs that
through Intel IPP, whose float sums ``resize_bicubic`` matches to within one
level on a few bytes of a resize, not byte for byte:
``tests/test_torch_layers.py:IPP_CUBIC_GAP``), taken to RGB / 127.5 - 1,
and stylized; the output is truncated to uint8, repeated to 3 channels,
resized back to the photo's size with ``resize_linear`` (cv2's default
``INTER_LINEAR``) and written under the photo's name: a PNG with
``write_png``, a JPEG with ``utils/jpeg.py:encode_jpeg`` at OpenCV's
quality 95 (what ``cv2.imwrite`` writes for that name). Without
``--static_ckpt`` the net takes seeded random weights, with the JAX
tool's warning.

    python -m animateportrait_tpu_torch.data.fakeb_static --root R \\
        [--static_ckpt P] [--style drawing|cartoon] [--device cuda]
"""
from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np
import torch

from animateportrait_tpu_torch.utils.device import (
    DEFAULT_DEVICE, resolve_device)

IN_SIZE = {"drawing": 512, "cartoon": 256}


def build_static_net(style: str, static_ckpt: str | None,
                     device: torch.device | str = DEFAULT_DEVICE
                     ) -> torch.nn.Module:
    """The static net of ``style`` from ``static_ckpt`` (the reference's
    state dict, loaded strictly as the port's CLI loads it), or with seeded
    random weights when there is none; in eval mode on ``device``."""
    from animateportrait_tpu_torch.io.reference import (
        load_into, load_state_dict)
    from animateportrait_tpu_torch.utils.smoke import init_random_

    if style == "drawing":
        from animateportrait_tpu_torch.models.gan import ResnetStyle2Generator
        net, unwrap, drop = ResnetStyle2Generator(), None, None
    elif style == "cartoon":
        from animateportrait_tpu_torch.models import photo2cartoon
        net = photo2cartoon.Photo2CartoonGenerator()
        unwrap, drop = "genA2B", photo2cartoon.UNUSED_KEY
    else:
        raise ValueError(f"style {style!r} is not drawing or cartoon")
    if static_ckpt:
        load_into(net, load_state_dict(static_ckpt, unwrap), drop)
    else:
        print("WARNING: no --static_ckpt; random init", file=sys.stderr)
        init_random_(net, torch.Generator().manual_seed(0))
    return net.to(resolve_device(device)).eval().requires_grad_(False)


@torch.inference_mode()
def stylize(net: torch.nn.Module, style: str, img_bgr: np.ndarray
            ) -> np.ndarray:
    """One photo (H, W, 3) BGR uint8 -> its static stylization (H, W, 3)
    RGB uint8."""
    from animateportrait_tpu_torch.utils.image import (
        resize_bicubic, resize_linear)

    dev = next(net.parameters()).device
    size = IN_SIZE[style]
    rgb = resize_bicubic(img_bgr, (size, size))[:, :, ::-1]
    x = (torch.as_tensor(np.ascontiguousarray(rgb), device=dev)
         .to(torch.float32)[None] / 127.5 - 1.0).permute(0, 3, 1, 2)
    if style == "drawing":
        style_map = torch.tensor([0.0, 1.0, 0.0], device=dev)[
            None, :, None, None].expand(1, 3, 128, 128)
        out = net(x, style_map)
    else:
        out = net(x)[0]
    out = out[0].permute(1, 2, 0).cpu().numpy()
    out8 = np.clip((out + 1) * 127.5, 0, 255).astype(np.uint8)
    if out8.shape[-1] == 1:
        out8 = np.repeat(out8, 3, axis=-1)
    # match the source photo resolution for the dataset loader
    return resize_linear(out8, img_bgr.shape[:2])


def write_image(path: str, rgb: np.ndarray) -> str:
    """(H, W, 3) RGB uint8 -> ``path``, as ``cv2.imwrite(path, bgr)``
    writes it: a JPEG for a .jpg name, else a PNG."""
    from animateportrait_tpu_torch.utils.image import write_png
    from animateportrait_tpu_torch.utils.jpeg import encode_jpeg

    if path.lower().endswith((".jpg", ".jpeg")):
        with open(path, "wb") as f:
            f.write(encode_jpeg(np.ascontiguousarray(rgb[:, :, ::-1])))
        return path
    return write_png(path, rgb)


def photos_of(root: str) -> list[str]:
    return sorted(glob.glob(os.path.join(root, "Photo", "*.png"))
                  + glob.glob(os.path.join(root, "Photo", "*.jpg")))


def make_fakeb_static(root: str, static_ckpt: str | None = None,
                      style: str = "drawing",
                      device: torch.device | str = DEFAULT_DEVICE,
                      net: torch.nn.Module | None = None) -> list[str]:
    """Write ``<root>/fakeB_static/<name>`` for every photo of
    ``<root>/Photo``; returns the paths written. ``net`` replaces the one
    ``static_ckpt`` names."""
    from animateportrait_tpu_torch.utils.image import read_image

    photos = photos_of(root)
    if not photos:
        raise SystemExit(f"no photos under {root}/Photo")
    out_dir = os.path.join(root, "fakeB_static")
    os.makedirs(out_dir, exist_ok=True)
    if net is None:
        net = build_static_net(style, static_ckpt, device)
    written = []
    for path in photos:
        dst = os.path.join(out_dir, os.path.basename(path))
        written.append(write_image(dst, stylize(net, style,
                                                read_image(path))))
        print(f"wrote {dst}")
    return written


def main(argv=None) -> list[str]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", required=True)
    p.add_argument("--static_ckpt", default=None)
    p.add_argument("--style", default="drawing",
                   choices=["drawing", "cartoon"])
    p.add_argument("--device", default=DEFAULT_DEVICE)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return make_fakeb_static(args.root, args.static_ckpt, args.style, dev)


if __name__ == "__main__":
    main()
