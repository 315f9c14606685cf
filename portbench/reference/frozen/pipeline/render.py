"""Landmark dot images + the Module2 inference renderer, drawing style, on
one card. Port of ``animateportrait_tpu/pipeline/render.py:
Module2Renderer`` (reference: Module2/models/geomcgt_ifw_test_model.py:
276-302).

Once per photo: the MODNet matte, the static drawing net at 512 px, and
the generator's frame-invariant ``encode_static``. Per frame batch, on the
device: the motion grid, the landmark dot images, FlowUnet's intrinsic
flow, the generator's ``decode``, the warped-matte blend and the uint8
conversion; each batch's frames then go to the host.

``motion_mode`` picks the motion grid: "linear" (the default) is the
reference's griddata-linear grid, exact, from a host Delaunay of each
frame's control points and a dense barycentric evaluation on the device
(``ops/tps.py:linear_motion_grid``); "tps" (the CLI's ``--warp_mode
tps``) fits a polyharmonic spline to each frame's landmark correspondence
on the device (``ops/tps.py:motion_grid_from_landmarks``). The landmark
dots keep radius 3 at every ``crop_size``.

The port's cartoon style, bf16 nets, frame sharding over cards and
``test_cli``'s visuals are left out: no configuration of the benchmark
runs them.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.frozen.models.flowunet import (
    FlowUnet, kp_to_map_binary)
from portbench.reference.frozen.models.gan import (
    ResnetStyle2Generator, TridentGeneratorFullIFW)
from portbench.reference.frozen.models.modnet import MODNet
from portbench.reference.frozen.ops.tps import (
    linear_motion_grid, motion_grid_from_landmarks, triangulate_frames)
from portbench.reference.frozen.utils.device import (
    DEFAULT_DEVICE, resolve_device)

CROP_SIZE = 256   # the renderer's frame size (the reference's load_size)
# Per-row half-widths of cv2.circle(radius=3, filled) for row offsets
# dy = -3..3: the rows cv2 rasterizes for a radius-3 dot (checked against
# cv2 in the tests).
DISC_HALFWIDTHS_R3 = (0, 2, 2, 3, 2, 2, 0)


def landmark_dot_images(lm68: torch.Tensor, size: int) -> torch.Tensor:
    """The reference ``draw2`` op=0 dot images (umlvdfw_test_dataset.py:
    34-48), cv2-exact: pixel (y, x) is lit iff some landmark k has
    y == round(y_k) + dy and |x - round(x_k)| <= halfwidth(dy).

    lm68: (B, 68, 2) (x, y) -> (B, 1, size, size) in {-1, 1}.
    """
    lm = torch.round(lm68).to(torch.int64)
    xs = torch.arange(size, device=lm68.device)
    hit = torch.zeros((lm.shape[0], size, size), dtype=torch.bool,
                      device=lm68.device)
    for dy, hw in zip(range(-3, 4), DISC_HALFWIDTHS_R3):
        rows = (xs[None, :, None] == lm[:, None, :, 1] + dy).float()
        cols = (torch.abs(xs[None, :, None] - lm[:, None, :, 0]) <= hw).float()
        hit |= torch.bmm(rows, cols.transpose(1, 2)) > 0   # (B, H, W)
    return hit[:, None].float() * 2.0 - 1.0


def test_window(load_size: int = 256, rx: float = 0.15, ry: float = 0.2,
                rs: float = 0.7) -> np.ndarray:
    """Face window [x1, x2, y1, y2] of the no-crop test transform
    (umlvdfw_test_dataset.py:12-31 with crop_pos=(0,0), flip=False)."""
    x1 = int(round(rx * load_size))
    y1 = int(round(ry * load_size))
    s = int(round(rs * load_size))
    return np.array([x1, x1 + s, y1, y1 + s], np.int32)


class Module2Renderer:
    """Photo + per-frame target landmarks -> drawing frames.

    Takes the static drawing net ``static_g`` and a 1-channel generator,
    as modules of this package; they are moved to ``device`` and put in
    eval mode. Only the uint8 output of the CLI (and fp32 in [-1, 1] for
    tests) is offered.
    """

    def __init__(self, generator: TridentGeneratorFullIFW, flowunet: FlowUnet,
                 modnet: MODNet, static_g: ResnetStyle2Generator,
                 frame_batch: int = 8, output_uint8: bool = False,
                 device: torch.device | str = DEFAULT_DEVICE,
                 motion_mode: str = "linear", crop_size: int = CROP_SIZE):
        if motion_mode not in ("linear", "tps"):
            raise ValueError(f"Module2Renderer: unknown motion_mode "
                             f"{motion_mode!r}")
        self.motion_mode = motion_mode
        self.crop_size = crop_size
        self.device = resolve_device(device)
        self.g = generator.to(self.device).eval()
        self.flowunet = flowunet.to(self.device).eval()
        self.modnet = modnet.to(self.device).eval()
        self.static_net = static_g.to(self.device).eval()
        self.frame_batch = frame_batch
        self.output_uint8 = output_uint8

    def prepare(self, photo: torch.Tensor):
        """photo (1, 3, cs, cs) in [-1, 1] -> (matted photo, mask,
        static stylization at cs)."""
        cs = self.crop_size
        mask = (self.modnet(photo) > 0.5).float()
        photo_512 = F.interpolate(photo, size=(512, 512), mode="bilinear",
                                  align_corners=False)
        style = torch.tensor([0.0, 1.0, 0.0], device=photo.device)
        style = style[None, :, None, None].expand(1, 3, 128, 128)
        fake_static = F.interpolate(self.static_net(photo_512, style),
                                    size=(cs, cs), mode="bilinear",
                                    align_corners=False)
        photo_fore = ((photo / 2 + 0.5) * mask + 1 - mask) * 2 - 1
        return photo_fore, mask, fake_static

    def encode(self, photo_fore: torch.Tensor, a_lm68: torch.Tensor
               ) -> dict[str, torch.Tensor]:
        """The generator's once-per-photo ``encode_static`` of the matted
        photo (1, 3, cs, cs) and the source landmarks (1, 68, 2)."""
        dots = landmark_dot_images(a_lm68, self.crop_size)
        return self.g.encode_static(photo_fore, dots)

    def frames(self, g_cache, mask, fake_static, a_lm68, tb_lm68s,
               motions=None, simplices=None):
        """One frame batch. a_lm68 (1, 68, 2); tb_lm68s (B, 68, 2); the
        ``motions`` (B, cs, cs, 2), or the ``simplices`` of each frame for
        the linear grid, or neither for the TPS grid."""
        B = tb_lm68s.shape[0]
        cs = self.crop_size
        if motions is None and simplices is None:
            motions = motion_grid_from_landmarks(a_lm68.expand(B, 68, 2),
                                                 tb_lm68s, cs)
        elif motions is None:
            motions = linear_motion_grid(a_lm68.expand(B, 68, 2), tb_lm68s,
                                         simplices, cs)
        tb_lm_imgs = landmark_dot_images(tb_lm68s, cs)
        j1 = kp_to_map_binary((224, 224), a_lm68 * (7.0 / 8.0))
        j2 = kp_to_map_binary((224, 224), tb_lm68s * (7.0 / 8.0))
        flow_out, vis_out, _, _ = self.flowunet(
            torch.cat([j1.expand(B, -1, -1, -1), j2], dim=1))
        m = (torch.argmax(vis_out, dim=1, keepdim=True) < 2).float()
        flows = F.interpolate(flow_out * 20.0 * m * (8.0 / 7.0), size=(cs, cs),
                              mode="bilinear", align_corners=True)
        fmasks = F.interpolate(m, size=(cs, cs), mode="bilinear",
                               align_corners=True)
        fake_b = self.g.decode(g_cache, tb_lm_imgs, motions, flows,
                               fmasks).float()
        mask1 = F.grid_sample(mask.expand(B, -1, -1, -1), motions,
                              align_corners=True)
        out = ((fake_b / 2 + 0.5) * mask1
               + (fake_static / 2 + 0.5) * (1 - mask1)) * 2 - 1
        if self.output_uint8:
            # utils/video.py:frames_to_uint8: same fp32 math, truncating cast
            out = torch.clamp((out + 1.0) * 127.5, 0, 255).to(torch.uint8)
        return out

    def __call__(self, photo: np.ndarray, a_lm68: np.ndarray,
                 tb_lm68s: np.ndarray,
                 motions: np.ndarray | None = None) -> np.ndarray:
        """photo (cs, cs, 3) in [-1, 1]; a_lm68 (68, 2); tb_lm68s
        (T, 68, 2) -> frames (T, cs, cs, 1), fp32 in [-1, 1] or uint8.
        The per-photo work once, then ``frames`` per ``frame_batch`` of
        the frames, padded to whole batches by repeating the last.

        motions: optional (T, cs, cs, 2) grids that replace the
        renderer's own (the reference's griddata grids)."""
        dev, cs, fb = self.device, self.crop_size, self.frame_batch
        photo_t = torch.as_tensor(photo, dtype=torch.float32,
                                  device=dev).permute(2, 0, 1)[None]
        a68 = torch.as_tensor(a_lm68, dtype=torch.float32, device=dev)[None]
        photo_fore, mask, fake_static = self.prepare(photo_t)
        g_cache = self.encode(photo_fore, a68)
        pad = (-tb_lm68s.shape[0]) % fb
        tb68_p = np.concatenate([tb_lm68s, np.repeat(tb_lm68s[-1:], pad, 0)])
        mo_p = tris_p = None
        if motions is not None:
            mo_p = np.concatenate([motions, np.repeat(motions[-1:], pad, 0)])
        elif self.motion_mode == "linear":
            tris_p = triangulate_frames(tb68_p, cs)
        outs = []
        for j in range(0, tb68_p.shape[0], fb):
            lm = torch.as_tensor(tb68_p[j:j + fb], dtype=torch.float32,
                                 device=dev)
            mo = None if mo_p is None else torch.as_tensor(
                mo_p[j:j + fb], dtype=torch.float32, device=dev)
            tri = None if tris_p is None else torch.as_tensor(
                tris_p[j:j + fb], device=dev)
            out = self.frames(g_cache, mask, fake_static, a68, lm, mo, tri)
            outs.append(out.permute(0, 2, 3, 1).cpu().numpy())
        return np.concatenate(outs, axis=0)[:tb_lm68s.shape[0]]
