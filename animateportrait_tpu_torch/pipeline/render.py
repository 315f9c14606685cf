"""Landmark dot images + the Module2 inference renderer, drawing and cartoon
styles. Port of ``animateportrait_tpu/pipeline/render.py:Module2Renderer``
(reference: Module2/models/geomcgt_ifw_test_model.py:276-302).

Once per photo: the MODNet matte, the static stylization (the drawing net
at 512 px, or Photo2Cartoon at 256 px), and the generator's
frame-invariant ``encode_static``. Per frame batch, on the device: the
motion grid, the landmark dot images, FlowUnet's intrinsic flow, the
generator's ``decode``, the warped-matte blend and the uint8 conversion;
each batch's frames then go to the host.

``motion_mode`` picks the motion grid, as in the JAX renderer: "linear"
(the default) is the reference's griddata-linear grid, exact, from a host
Delaunay of each frame's control points and a dense barycentric
evaluation on the device (``ops/tps.py:linear_motion_grid``); "tps" (the
CLI's ``--warp_mode tps``) fits a polyharmonic spline to each frame's
landmark correspondence on the device (``ops/tps.py:
motion_grid_from_landmarks``, a ``linalg.solve`` per frame), with no host
step, for both styles and under ``use_bf16``.

``render_visuals`` is ``test_cli``'s path: a photo's frames with every
intermediate of the reference's test model (the blend, the generator's
pre-blend output, the matte and the warped matte, the static
stylization, the matted photo, the target dots, the motion grid and the
intrinsic flow and its mask), as [-1, 1] float arrays; ``__call__``
stays the throughput path. ``crop_size`` is the frame size, 256 (the
CLI's) or ``test_cli``'s ``--crop_size``; the landmark dots keep radius
3 at every size, as the JAX renderer's.

``use_bf16`` (the CLI's ``--render_bf16``) runs the per-frame nets in bf16
as the JAX renderer does: bf16 copies of the trident generator and of
FlowUnet's parameters (FlowUnet's BatchNorm statistics stay fp32), bf16
inputs to ``encode_static`` (the matted photo and the source dots), to
``decode`` (the target dots) and to FlowUnet; the motion grids, the flows
and their masks stay fp32, and the generator's output is taken back to
fp32 before the blend. MODNet and the static nets stay fp32.
"""
from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn.functional as F

from animateportrait_tpu_torch.models.flowunet import (
    FlowUnet, kp_to_map_binary)
from animateportrait_tpu_torch.models.gan import (
    ResnetStyle2Generator, TridentGeneratorFullIFW)
from animateportrait_tpu_torch.models.modnet import MODNet
from animateportrait_tpu_torch.models.photo2cartoon import (
    Photo2CartoonGenerator)
from animateportrait_tpu_torch.nn import cast_parameters
from animateportrait_tpu_torch.ops.tps import (
    linear_motion_grid, motion_grid_from_landmarks, triangulate_frames)
from animateportrait_tpu_torch.utils.device import (
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


class Module2Renderer:
    """Photo + per-frame target landmarks -> stylized frames.

    ``style`` "drawing" takes the static drawing net ``static_g`` and a
    1-channel generator; "cartoon" takes ``cartoon_g`` and a 3-channel
    generator. The nets come in as modules of this package; they are moved
    to ``device`` and put in eval mode. Only the uint8 output of the
    CLI (and fp32 in [-1, 1] for tests) is offered.
    """

    def __init__(self, generator: TridentGeneratorFullIFW, flowunet: FlowUnet,
                 modnet: MODNet,
                 static_g: ResnetStyle2Generator | None = None,
                 frame_batch: int = 8,
                 output_uint8: bool = False,
                 device: torch.device | str = DEFAULT_DEVICE,
                 style: str = "drawing",
                 cartoon_g: Photo2CartoonGenerator | None = None,
                 use_bf16: bool = False, motion_mode: str = "linear",
                 crop_size: int = CROP_SIZE):
        static = {"drawing": ("static_g", static_g),
                  "cartoon": ("cartoon_g", cartoon_g)}
        if style not in static:
            raise ValueError(f"Module2Renderer: unknown style {style!r}")
        if static[style][1] is None:
            raise ValueError(f"Module2Renderer: style {style!r} needs "
                             f"{static[style][0]}")
        if motion_mode not in ("linear", "tps"):
            raise ValueError(f"Module2Renderer: unknown motion_mode "
                             f"{motion_mode!r}")
        self.motion_mode = motion_mode
        self.crop_size = crop_size
        self.device = resolve_device(device)
        self.style = style
        self.g = generator.to(self.device).eval()
        self.flowunet = flowunet.to(self.device).eval()
        self.modnet = modnet.to(self.device).eval()
        self.static_net = static[style][1].to(self.device).eval()
        self.frame_batch = frame_batch
        self.output_uint8 = output_uint8
        self.dtype = torch.bfloat16 if use_bf16 else torch.float32
        if use_bf16:
            # copies: the caller's nets stay fp32
            self.g = cast_parameters(copy.deepcopy(self.g), self.dtype)
            self.flowunet = cast_parameters(copy.deepcopy(self.flowunet),
                                            self.dtype)

    def prepare(self, photo: torch.Tensor):
        """photo (1, 3, cs, cs) in [-1, 1] -> (matted photo, mask,
        static stylization at cs)."""
        cs = self.crop_size
        mask = (self.modnet(photo) > 0.5).float()
        if self.style == "drawing":
            photo_512 = F.interpolate(photo, size=(512, 512), mode="bilinear",
                                      align_corners=False)
            style = torch.tensor([0.0, 1.0, 0.0], device=photo.device)
            style = style[None, :, None, None].expand(1, 3, 128, 128)
            fake_static = F.interpolate(self.static_net(photo_512, style),
                                        size=(cs, cs), mode="bilinear",
                                        align_corners=False)
        else:
            # Photo2Cartoon.inference2 takes the photo through a truncating
            # uint8 round trip first (photo2cartoon.py:585-589)
            q = torch.floor(torch.clamp((photo + 1.0) * 127.5, 0, 255))
            fake_static, _, _ = self.static_net(q / 127.5 - 1.0)
        photo_fore = ((photo / 2 + 0.5) * mask + 1 - mask) * 2 - 1
        return photo_fore, mask, fake_static

    def encode(self, photo_fore: torch.Tensor, a_lm68: torch.Tensor
               ) -> dict[str, torch.Tensor]:
        """The generator's once-per-photo ``encode_static`` of the matted
        photo (1, 3, cs, cs) and the source landmarks (1, 68, 2), in the
        renderer's dtype."""
        dots = landmark_dot_images(a_lm68, self.crop_size)
        return self.g.encode_static(photo_fore.to(self.dtype),
                                    dots.to(self.dtype))

    def frames(self, g_cache, mask, fake_static, a_lm68, tb_lm68s,
               motions=None, simplices=None, return_all: bool = False):
        """One frame batch. a_lm68 (1, 68, 2); tb_lm68s (B, 68, 2); the
        ``motions`` (B, cs, cs, 2), or the ``simplices`` of each frame
        for the linear grid, or neither for the TPS grid. ``return_all``:
        a dict of the batch's intermediates (NCHW, fp32) in place of the
        frames."""
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
            torch.cat([j1.expand(B, -1, -1, -1), j2], dim=1).to(self.dtype))
        m = (torch.argmax(vis_out, dim=1, keepdim=True) < 2).float()
        # in bf16, flow_out * 20.0 is rounded to bf16 and the mask makes it
        # fp32, as JAX promotes it
        flows = F.interpolate(flow_out * 20.0 * m * (8.0 / 7.0), size=(cs, cs),
                              mode="bilinear", align_corners=True)
        fmasks = F.interpolate(m, size=(cs, cs), mode="bilinear",
                               align_corners=True)
        fake_b = self.g.decode(g_cache, tb_lm_imgs.to(self.dtype), motions,
                               flows, fmasks).float()
        mask1 = F.grid_sample(mask.expand(B, -1, -1, -1), motions,
                              align_corners=True)
        out = ((fake_b / 2 + 0.5) * mask1
               + (fake_static / 2 + 0.5) * (1 - mask1)) * 2 - 1
        if return_all:
            # the reference test model's attributes
            # (geomcgt_ifw_test_model.py:276-302)
            return {"fake_B": out, "fake_B_fore": fake_b,
                    "fg_mask1": mask1 * 2 - 1,
                    "fakeB_static": fake_static.expand(B, -1, -1, -1),
                    "warp_motion": motions.permute(0, 3, 1, 2),
                    "iw_flow": flows, "if_mask": fmasks,
                    "target_B_lm": tb_lm_imgs}
        if self.output_uint8:
            # utils/video.py:frames_to_uint8: same fp32 math, truncating cast
            out = torch.clamp((out + 1.0) * 127.5, 0, 255).to(torch.uint8)
        return out

    def _photo_batches(self, photo: np.ndarray, a_lm68: np.ndarray,
                       tb_lm68s: np.ndarray, motions: np.ndarray | None,
                       return_all: bool = False):
        """The per-photo work, once (the matte, the static stylization,
        ``encode``), then ``frames`` per ``frame_batch`` of the frames,
        padded to whole batches by repeating the last: -> (photo_fore,
        mask, a generator of each batch's ``frames`` output)."""
        dev = self.device
        cs = self.crop_size
        photo_t = torch.as_tensor(photo, dtype=torch.float32,
                                  device=dev).permute(2, 0, 1)[None]
        a68 = torch.as_tensor(a_lm68, dtype=torch.float32, device=dev)[None]
        photo_fore, mask, fake_static = self.prepare(photo_t)
        g_cache = self.encode(photo_fore, a68)
        fb = self.frame_batch
        pad = (-tb_lm68s.shape[0]) % fb
        tb68_p = np.concatenate([tb_lm68s, np.repeat(tb_lm68s[-1:], pad, 0)])
        mo_p = tris_p = None
        if motions is not None:
            mo_p = np.concatenate([motions, np.repeat(motions[-1:], pad, 0)])
        elif self.motion_mode == "linear":
            tris_p = triangulate_frames(tb68_p, cs)

        def batches():
            for j in range(0, tb68_p.shape[0], fb):
                lm = torch.as_tensor(tb68_p[j: j + fb], dtype=torch.float32,
                                     device=dev)
                mo = None if mo_p is None else torch.as_tensor(
                    mo_p[j: j + fb], dtype=torch.float32, device=dev)
                tri = None if tris_p is None else torch.as_tensor(
                    tris_p[j: j + fb], device=dev)
                yield self.frames(g_cache, mask, fake_static, a68, lm, mo,
                                  tri, return_all=return_all)

        return photo_fore, mask, batches()

    def __call__(self, photo: np.ndarray, a_lm68: np.ndarray,
                 tb_lm68s: np.ndarray,
                 motions: np.ndarray | None = None) -> np.ndarray:
        """photo (cs, cs, 3) in [-1, 1]; a_lm68 (68, 2); tb_lm68s
        (T, 68, 2) -> frames (T, cs, cs, nc), fp32 in [-1, 1] or uint8;
        nc is 1 for drawing, 3 for cartoon.

        motions: optional (T, cs, cs, 2) grids that replace the
        renderer's own (the reference's griddata grids)."""
        _, _, batches = self._photo_batches(photo, a_lm68, tb_lm68s, motions)
        outs = [out.permute(0, 2, 3, 1).cpu().numpy() for out in batches]
        return np.concatenate(outs, axis=0)[:tb_lm68s.shape[0]]

    def render_visuals(self, photo: np.ndarray, a_lm68: np.ndarray,
                       tb_lm68s: np.ndarray,
                       motions: np.ndarray | None = None
                       ) -> dict[str, np.ndarray]:
        """Every intermediate of the reference's test model
        (``GeomCGTIFWTestModel.forward``, geomcgt_ifw_test_model.py:
        276-302) for all of a photo's frames: ``fake_B`` (the blend),
        ``fake_B_fore`` (the generator's output), ``fg_mask`` and
        ``fg_mask1`` (the matte and the warped matte), ``fakeB_static``,
        ``real_A`` (the matted photo), ``target_B_lm``, ``warp_motion``,
        ``iw_flow`` and ``if_mask``; each (T, cs, cs, C) float32 numpy in
        [-1, 1] (the grids and flows in their own units). Arguments as
        ``__call__``'s; the per-photo nets run once and the frames go in
        batches of ``frame_batch``, as in ``__call__``."""
        T = tb_lm68s.shape[0]
        photo_fore, mask, batches = self._photo_batches(
            photo, a_lm68, np.asarray(tb_lm68s, np.float32), motions,
            return_all=True)
        parts = [{k: v.float().permute(0, 2, 3, 1).cpu().numpy()
                  for k, v in vis.items()} for vis in batches]
        vis = {k: np.concatenate([p[k] for p in parts])[:T] for k in parts[0]}
        for k, v in (("real_A", photo_fore), ("fg_mask", mask * 2 - 1)):
            vis[k] = np.repeat(v.float().permute(0, 2, 3, 1).cpu().numpy(),
                               T, axis=0)
        return vis
