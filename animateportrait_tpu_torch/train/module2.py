"""The Module2 GAN training step, NCHW. Port of
``animateportrait_tpu/train/module2.py`` (reference:
Module2/models/geomgm_ifw_fore_model.py).

One step: the frozen MODNet matte and FlowUnet flows, the TPS warps of the
mask and of the static drawing (``forward_shared``, no gradients); two
trident-generator forwards and the generator's losses against five 70x70
PatchGAN discriminators, the frozen MobileFaceNet geometry loss and the
Sphere20a (or SENet50) identity loss; the coherence image pool; the
discriminators' losses on the detached fakes; then both Adam updates, from
the same old state. Every InstanceNorm runs kernel K2 forward and K2b
backward on the card (``ops/instnorm.py``).

``build_train_step(cfg)`` returns a ``Module2TrainStep`` with
``grads(state, batch, frozen, gen)`` (the JAX ``train_step.grads_fn``),
``step(state, batch, frozen, gen)``, which applies the updates in place,
and ``visuals(state, batch, frozen)`` (the JAX ``visuals_fn``).
``cfg.remat`` recomputes each generator forward in the backward
(``torch.utils.checkpoint``, as ``jax.checkpoint`` in JAX); K2 runs again
in the recompute and K2b takes the statistics of that run. The JAX
package's bf16 ``compute_dtype`` and its FSDP sharding are not ported.

Layouts: images (N, C, H, W) in [-1, 1]; landmarks (N, 68, 2) (x, y) in
crop-size pixels; motion grids (N, H, W, 2) normalized (x, y); face
windows (N, 4) [x1, x2, y1, y2]; FlowUnet flows (N, 2, H, W).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from animateportrait_tpu_torch.models.flowunet import (
    FlowUnet, kp_to_map_binary)
from animateportrait_tpu_torch.models.gan import (
    NLayerDiscriminator, TridentGeneratorFullIFW, gan_loss, init_weights)
from animateportrait_tpu_torch.models.modnet import MODNet
from animateportrait_tpu_torch.models.perception import (
    MobileFaceNet, SENet50, Sphere20a, crop_head_bbox, face_loss)
from animateportrait_tpu_torch.ops.tps import (
    linear_motion_grid, motion_grid_from_landmarks, sparse_image_warp)
from animateportrait_tpu_torch.ops.warp import sample_bicubic
from animateportrait_tpu_torch.utils.assets import face_lmark_lookup
from animateportrait_tpu_torch.utils.device import (
    DEFAULT_DEVICE, resolve_device)


@dataclasses.dataclass(frozen=True)
class Module2Config:
    """Training flags of the reference CLI (readme.md:65-67); the defaults
    are the shipped drawing configuration."""

    crop_size: int = 256
    output_nc: int = 1           # 1 = drawing, 3 = cartoon
    ngf: int = 64
    ndf: int = 64
    n_layers_d: int = 3
    netg_resb_div: int = 3
    netg_resb_disp: int = 3
    lr: float = 5e-5
    beta1: float = 0.5
    niter: int = 70
    niter_decay: int = 0
    lr_policy: str = "linear"    # linear | step | plateau | cosine
    lr_decay_iters: int = 50     # StepLR step_size for lr_policy='step'
    init_type: str = "normal"    # normal | xavier | kaiming | orthogonal
    init_gain: float = 0.02
    # one discriminator pass over each discriminator's inputs stacked along
    # the batch, instead of one pass each (convs and InstanceNorm are
    # per-sample, so the losses are the same)
    batch_d_passes: bool = False
    steps_per_epoch: int = 1000
    pool_size: int = 50
    gan_mode: str = "lsgan"
    lambda_geom: float = 50.0
    lambda_geom_lipline: float = 50.0
    lambda_g_a_l: float = 0.5
    lambda_g_a_coh: float = 0.5
    lambda_face: float = 3.0
    lambda_warp: float = 5.0
    lambda_warp_inter: float = 10.0
    use_mask: bool = True
    use_eye_mask: bool = True
    use_lip_mask: bool = True
    mask_type: int = 3
    blendbg: int = 1
    coherent: int = 1            # 0 for the cartoon twin
    coh_use_more: int = 2
    check_fakeb2_in_backward_d: bool = True
    identity_loss: int = 2
    warp_loss: int = 2
    more_weight_for_lip: int = 2
    # recompute the two generator forwards in the backward instead of
    # keeping their activations: memory for time, the same gradients
    remat: bool = False
    # the FaceLoss net, chosen as the reference does by a 'senet' in the
    # checkpoint path (geomgm_ifw_fore_model.py:185, networks.py:2862-2876):
    # SENet50 on 224 x 224 head crops, else Sphere20a on 112 x 96
    face_recog_model: str = "sphere20a"

    @property
    def use_senet(self) -> bool:
        return "senet" in self.face_recog_model

    @property
    def face_crop_hw(self) -> tuple[int, int]:
        return (224, 224) if self.use_senet else (112, 96)


@dataclasses.dataclass
class FrozenNets:
    """The frozen helper nets, in eval mode, with no parameter that
    requires grad."""

    modnet: MODNet
    mobilefacenet: MobileFaceNet
    sphere: Sphere20a | SENet50    # the FaceLoss net
    flowunet: FlowUnet


@dataclasses.dataclass
class TrainState:
    """Generator and discriminators, their Adam states, the coherence pool
    ``(pool_size, output_nc, H, W)`` and how many of its slots are filled,
    and the number of updates taken."""

    step: int
    g: TridentGeneratorFullIFW
    d: nn.ModuleDict            # d_a, d_a_l, d_a_le, d_a_ll, d_a_coh
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    pool: torch.Tensor
    pool_count: int


@dataclasses.dataclass
class Grads:
    """One step's gradients, by parameter name (``g.named_parameters()``
    and ``d.named_parameters()``), the pool after the step's two queries,
    and the losses."""

    g: dict[str, torch.Tensor]
    d: dict[str, torch.Tensor]
    pool: torch.Tensor
    pool_count: int
    metrics: dict[str, torch.Tensor]


# the batch's (N, H, W, 2) motion grids; every other 4-D entry is NCHW
GRID_KEYS = ("warp_motion", "warp_motion2")
# the reference's 8 fixed border anchors at 256 px (x, y)
EDGE_ANCHORS_256 = np.array(
    [[0, 0], [255, 255], [0, 255], [255, 0],
     [0, 127], [127, 0], [127, 255], [255, 127]], np.float32)


# --- geometry helpers -------------------------------------------------------


def masked(a: torch.Tensor, mask: torch.Tensor,
           mask_type: int = 3) -> torch.Tensor:
    """base_model.masked (base_model.py:238-247)."""
    if mask_type == 0:
        return (a / 2 + 0.5) * mask * 2 - 1
    if mask_type == 1:
        return ((a / 2 + 0.5) * mask + 1 - mask) * 2 - 1
    if mask_type == 2:
        return torch.cat([a, mask], dim=1)
    m = ((a / 2 + 0.5) * mask + 1 - mask) * 2 - 1
    return torch.cat([m, mask], dim=1)


def extract_landmarks(mfn: MobileFaceNet, imgs: torch.Tensor,
                      wins: torch.Tensor, out_size: int = 112
                      ) -> torch.Tensor:
    """get_lm (geomgm_ifw_fore_model.py:391-415), batched: crop each window
    [x1, x2, y1, y2] of ``imgs`` (N, 1 or 3, H, W) in [-1, 1] (ones outside
    the image), bicubic-resize it to ``out_size`` (torch's half-pixel
    convention), swap RGB to BGR, run MobileFaceNet on [0, 1] and map its
    [0, 1] landmarks back to window pixels -> (N, 68, 2) (x, y)."""
    n = imgs.shape[0]
    imgs = imgs.repeat(1, 3, 1, 1) if imgs.shape[1] == 1 else imgs.flip(1)
    w = wins.to(torch.float32)
    x1, x2, y1, y2 = (w[:, i] for i in range(4))
    t = (torch.arange(out_size, dtype=torch.float32, device=imgs.device)
         + 0.5) / out_size
    iy = (y1[:, None, None] + t[None, :, None] * (y2 - y1)[:, None, None]
          - 0.5).expand(n, out_size, out_size)
    ix = (x1[:, None, None] + t[None, None, :] * (x2 - x1)[:, None, None]
          - 0.5).expand(n, out_size, out_size)
    crop = sample_bicubic(imgs, iy, ix)
    h, w_ = imgs.shape[2:]
    inb = (iy >= 0) & (iy <= h - 1) & (ix >= 0) & (ix <= w_ - 1)
    crop = torch.where(inb[:, None], crop, torch.ones_like(crop))
    lm, _ = mfn((crop + 1.0) * 0.5)
    lm = lm.reshape(n, 68, 2)
    lx = lm[..., 0] * (x2 - x1)[:, None] + x1[:, None]
    ly = lm[..., 1] * (y2 - y1)[:, None] + y1[:, None]
    return torch.stack([lx, ly], dim=-1)


def lipline_mask(lm68: torch.Tensor, edges: np.ndarray, size: int = 256,
                 thickness: float = 2.0) -> torch.Tensor:
    """getlipline (geomgm_ifw_fore_model.py:507-515) without cv2: the
    pixels within thickness/2 of one of the lip edges, (N, 1, size, size)
    in {0, 1}; lm68 (N, 68, 2) (x, y)."""
    n = lm68.shape[0]
    e = torch.as_tensor(edges, device=lm68.device)
    p0 = lm68[:, e[:, 0], :]                         # (N, E, 2)
    p1 = lm68[:, e[:, 1], :]
    ar = torch.arange(size, dtype=torch.float32, device=lm68.device)
    gy, gx = torch.meshgrid(ar, ar, indexing="ij")
    g = torch.stack([gx, gy], dim=-1).reshape(1, size * size, 1, 2)
    a = p0[:, None]
    d = p1[:, None] - a
    t = torch.clamp(torch.sum((g - a) * d, -1)
                    / torch.clamp(torch.sum(d * d, -1), min=1e-6), 0.0, 1.0)
    dist2 = torch.sum(torch.square(g - (a + t[..., None] * d)), -1)
    hit = torch.any(dist2 <= (thickness / 2.0) ** 2, dim=-1)
    return hit.reshape(n, 1, size, size).to(torch.float32)


def _with_edges(lm68: torch.Tensor) -> torch.Tensor:
    """Append the 8 fixed border anchors (geomgm_ifw_fore_model.py:379-381)."""
    e = torch.as_tensor(EDGE_ANCHORS_256, device=lm68.device)
    return torch.cat([lm68, e.expand(lm68.shape[0], 8, 2)], dim=1)


def flow_warp_fields(flowunet: FlowUnet, lm1: torch.Tensor,
                     lm2: torch.Tensor, size: int = 256
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """flow_network_warp (geomgm_ifw_fore_model.py:69-83): 68-point
    landmarks (N, 68, 2) in crop-size pixels -> (flow (N, 2, size, size),
    mask (N, 1, size, size))."""
    j1 = kp_to_map_binary((224, 224), lm1[:, :68] * (7.0 / 8.0))
    j2 = kp_to_map_binary((224, 224), lm2[:, :68] * (7.0 / 8.0))
    flow_out, vis_out, _, _ = flowunet(torch.cat([j1, j2], dim=1))
    mask = (torch.argmax(vis_out, dim=1, keepdim=True) < 2).float()
    flow = flow_out * 20.0 * mask
    warp_flow = F.interpolate(flow * (8.0 / 7.0), size=(size, size),
                              mode="bilinear", align_corners=True)
    res_mask = F.interpolate(mask, size=(size, size), mode="bilinear",
                             align_corners=True)
    return warp_flow, res_mask


# --- the coherence image pool -----------------------------------------------


def pool_draw(batch: int, pool_size: int, gen: torch.Generator
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The pool query's random draws: a uniform in [0, 1) and a slot in
    [0, pool_size) for each image, on ``gen``'s device."""
    u = torch.rand((batch,), generator=gen, device=gen.device)
    slots = torch.randint(0, pool_size, (batch,), generator=gen,
                          device=gen.device)
    return u, slots


def pool_swap(pool: torch.Tensor, count: int, imgs: torch.Tensor,
              u: torch.Tensor, slots: torch.Tensor
              ) -> tuple[torch.Tensor, int, torch.Tensor]:
    """The image pool (util/image_pool.py:23-54) given the draws: returns
    (new pool, new count, images out). Slots fill in order until the pool
    is full; after that, with probability 0.5 (u > 0.5), an image swaps
    with the one in its drawn slot, and the query returns the old one.
    History is only returned once the pool was full before the query. The
    images of a batch are written in order, so a later one wins a slot
    that two share, as in the JAX package. ``pool`` is not modified."""
    b, psize = imgs.shape[0], pool.shape[0]
    u, slots = u.cpu(), slots.cpu()
    new_pool = pool.clone()
    out = []
    for i in range(b):
        if count + i < psize:                     # filling
            new_pool[count + i] = imgs[i]
            out.append(imgs[i])
        elif count >= psize and float(u[i]) > 0.5:
            s = int(slots[i])
            out.append(pool[s])
            new_pool[s] = imgs[i]
        else:
            out.append(imgs[i])
    return new_pool, min(count + b, psize), torch.stack(out)


def pool_query(pool: torch.Tensor, count: int, imgs: torch.Tensor,
               gen: torch.Generator) -> tuple[torch.Tensor, int,
                                              torch.Tensor]:
    """One pool query: ``pool_draw`` on ``gen``, then ``pool_swap``."""
    return pool_swap(pool, count, imgs,
                     *pool_draw(imgs.shape[0], pool.shape[0], gen))


# --- state, optimizer, example inputs ----------------------------------------


def lr_at(cfg: Module2Config, step: int) -> float:
    """The learning rate of update ``step`` (0-based), by the reference's
    lr policies (get_scheduler, networks.py:42-68): 'linear' (constant for
    niter epochs, then a linear decay over niter_decay), 'step' (x0.1 every
    lr_decay_iters epochs), 'plateau' (Module2 steps ReduceLROnPlateau with
    metric 0, so x0.2 every 6 epochs after the first) and 'cosine'
    (T_max niter, eta_min 0)."""
    epoch = step // cfg.steps_per_epoch
    if cfg.lr_policy == "step":
        return cfg.lr * 0.1 ** (epoch // cfg.lr_decay_iters)
    if cfg.lr_policy == "plateau":
        return cfg.lr * 0.2 ** (max(0, epoch - 1) // 6)
    if cfg.lr_policy == "cosine":
        return cfg.lr * 0.5 * (1.0 + math.cos(math.pi * epoch
                                              / max(cfg.niter, 1)))
    if cfg.lr_policy != "linear":
        raise ValueError(f"unknown lr_policy {cfg.lr_policy!r}")
    decay = max(0, epoch + 1 - cfg.niter) / max(cfg.niter_decay + 1, 1)
    return cfg.lr * min(max(1.0 - decay, 0.0), 1.0)


def make_optimizer(cfg: Module2Config, params) -> torch.optim.Adam:
    """Adam(b1 = beta1, b2 = 0.999, eps = 1e-8), which takes optax's
    ``scale_by_adam`` step; ``Module2TrainStep.step`` sets its learning
    rate to ``lr_at`` the state's step before each update."""
    return torch.optim.Adam(params, lr=cfg.lr, betas=(cfg.beta1, 0.999),
                            eps=1e-8)


def d_input_channels(cfg: Module2Config) -> dict[str, int]:
    """Each discriminator's input channels: the image, the masked image
    with its mask, or the coherence pair."""
    nc = cfg.output_nc
    local_nc = nc + 1 if cfg.mask_type in (2, 3) else nc
    specs = {"d_a": nc, "d_a_l": local_nc, "d_a_le": local_nc,
             "d_a_ll": local_nc, "d_a_coh": 2 * nc}
    if not cfg.coherent:
        del specs["d_a_coh"]
    return specs


def init_state(cfg: Module2Config, gen: torch.Generator,
               device: torch.device | str = DEFAULT_DEVICE) -> TrainState:
    """Generator and discriminators with the reference's from-scratch init
    (``cfg.init_type``, gain ``cfg.init_gain``, drawn from ``gen``), their
    Adam states, and an empty pool, on ``device``."""
    dev = resolve_device(device)
    g = TridentGeneratorFullIFW(output_nc=cfg.output_nc, ngf=cfg.ngf,
                                div=cfg.netg_resb_div,
                                disp=cfg.netg_resb_disp)
    init_weights(g, cfg.init_type, cfg.init_gain, gen)
    d = nn.ModuleDict()
    for name, in_nc in d_input_channels(cfg).items():
        d[name] = init_weights(
            NLayerDiscriminator(in_nc, cfg.ndf, cfg.n_layers_d),
            cfg.init_type, cfg.init_gain, gen)
    g, d = g.to(dev).train(), d.to(dev).train()
    h = cfg.crop_size
    return TrainState(
        step=0, g=g, d=d, g_opt=make_optimizer(cfg, g.parameters()),
        d_opt=make_optimizer(cfg, d.parameters()),
        pool=torch.zeros((cfg.pool_size, cfg.output_nc, h, h), device=dev),
        pool_count=0)


def make_example_batch(cfg: Module2Config, batch_size: int = 1,
                       size: int | None = None,
                       device: torch.device | str = DEFAULT_DEVICE) -> dict:
    """A zeros batch with the right shapes, and non-degenerate landmark
    geometry (a circle around the image center: collinear points would
    make the TPS solves singular)."""
    dev = resolve_device(device)
    h = size or cfg.crop_size
    nc = cfg.output_nc

    def z(c):
        return torch.zeros((batch_size, c, h, h), device=dev)

    theta = np.linspace(0.0, 2 * np.pi, 68, endpoint=False)
    lm = torch.as_tensor(np.stack([h / 2 + h / 4 * np.cos(theta),
                                   h / 2 + h / 4 * np.sin(theta)], -1),
                         dtype=torch.float32, device=dev)
    lm = lm[None].repeat(batch_size, 1, 1)
    win = torch.tensor([[40, h - 40, 40, h - 40]], dtype=torch.int32,
                       device=dev).repeat(batch_size, 1)
    batch = {"real_A": z(3), "real_B": z(nc), "A_lm": z(1), "tB_lm": z(1),
             "tB2_lm": z(1), "A_lm_68": lm, "tB_lm_68": lm + 1.0,
             "tB2_lm_68": lm + 2.0, "fakeB_static": z(nc), "winA": win,
             "winB": win.clone(), "winB2": win.clone()}
    for key in GRID_KEYS:
        batch[key] = torch.zeros((batch_size, h, h, 2), device=dev)
    for kind in ("", "e", "l"):
        for who in ("B", "B2", "Br"):
            batch[f"{who}_mask{kind}"] = z(1)
    for key in ("B1_img", "B2_img", "B3", "B4"):
        batch[key] = z(nc)
    return batch


@torch.no_grad()
def _lecun_init_(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Random frozen-net weights drawn from ``gen`` in the manner of flax's
    defaults, which the JAX package's random frozen nets take: conv and
    linear weights N(0, 1/fan_in) (LeCun), biases 0, BatchNorm weights 1,
    biases and running means 0, running variances 1; PReLU slopes keep
    their 0.25."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            fan_in = nn.init._calculate_fan_in_and_fan_out(m.weight)[0]
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen,
                                       device=gen.device) / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
            m.reset_parameters()
    return module


def make_random_batch(cfg: Module2Config, batch_size: int,
                      gen: torch.Generator,
                      device: torch.device | str = DEFAULT_DEVICE) -> dict:
    """``make_example_batch`` with every image, mask and grid uniform in
    [-1, 1] from ``gen`` (drawn on its device), as the JAX package's tests
    fill it: a synthetic batch for smoke runs."""
    batch = make_example_batch(cfg, batch_size, device=device)
    for k, v in batch.items():
        if v.dim() == 4:
            batch[k] = (torch.rand(v.shape, generator=gen, device=gen.device)
                        * 2 - 1).to(v.device)
    return batch


def init_frozen_random(gen: torch.Generator,
                       device: torch.device | str = DEFAULT_DEVICE,
                       face_recog_model: str = "sphere20a") -> FrozenNets:
    """Seeded random frozen nets (tests and smoke runs; real use loads the
    reference checkpoints, ``io/reference.py``), in eval mode and frozen;
    the FaceLoss net is SENet50 when ``face_recog_model`` names a senet."""
    dev = resolve_device(device)
    face = SENet50() if "senet" in face_recog_model else Sphere20a()
    nets = [MODNet(), MobileFaceNet(), face, FlowUnet()]
    for net in nets:
        _lecun_init_(net, gen).to(dev).eval().requires_grad_(False)
    return FrozenNets(*nets)


# --- the step ---------------------------------------------------------------


class Module2TrainStep:
    """The train step of ``cfg`` (``build_train_step``)."""

    def __init__(self, cfg: Module2Config):
        self.cfg = cfg
        self.lip_edges = face_lmark_lookup()[:20]

    def crit(self, pred: torch.Tensor, real: bool) -> torch.Tensor:
        return gan_loss(pred, real, self.cfg.gan_mode)

    def d_apply_stacked(self, d: nn.Module, xs: list, reals: list) -> list:
        """The GAN loss of each input against ``d``: one pass over the
        inputs stacked along the batch (``batch_d_passes``), or one pass
        each."""
        if self.cfg.batch_d_passes and len(xs) > 1:
            n = xs[0].shape[0]
            p = d(torch.cat(xs, dim=0))
            return [self.crit(p[i * n:(i + 1) * n], r)
                    for i, r in enumerate(reals)]
        return [self.crit(d(x), r) for x, r in zip(xs, reals)]

    @torch.no_grad()
    def forward_shared(self, batch: dict, frozen: FrozenNets) -> dict:
        """Everything upstream of G, which carries no gradient."""
        cfg = self.cfg
        real_A = batch["real_A"]
        mask = (frozen.modnet(real_A) > 0.5).float()
        real_A_fore = ((real_A / 2 + 0.5) * mask + 1 - mask) * 2 - 1
        fakeB_static = batch["fakeB_static"]
        if not cfg.blendbg:
            fakeB_static = ((fakeB_static / 2 + 0.5) * mask + 1 - mask) * 2 - 1
        a68, tb68, tb2_68 = (batch[k] for k in ("A_lm_68", "tB_lm_68",
                                                "tB2_lm_68"))
        iw_flow, if_mask = flow_warp_fields(frozen.flowunet, a68, tb68,
                                            cfg.crop_size)
        iw_flow2, if_mask2 = flow_warp_fields(frozen.flowunet, a68, tb2_68,
                                              cfg.crop_size)
        # the TPS control points: with blendbg the reference warps with the
        # bare 68 landmarks, without it with the 8 border anchors appended
        if cfg.blendbg:
            a_681, tb_681, tb2_681 = a68, tb68, tb2_68
        else:
            a_681, tb_681, tb2_681 = (_with_edges(t) for t in (a68, tb68,
                                                               tb2_68))
        # the three grid sources: the batch's grids, exact griddata-linear
        # grids from the batch's Delaunay simplices, or TPS grids
        if "warp_motion" in batch:
            motion, motion2 = batch["warp_motion"], batch["warp_motion2"]
        elif "tri_motion" in batch:
            motion = linear_motion_grid(a68[:, :68], tb68[:, :68],
                                        batch["tri_motion"], cfg.crop_size)
            motion2 = linear_motion_grid(a68[:, :68], tb2_68[:, :68],
                                         batch["tri_motion2"], cfg.crop_size)
        else:
            motion = motion_grid_from_landmarks(a68[:, :68], tb68[:, :68],
                                                cfg.crop_size)
            motion2 = motion_grid_from_landmarks(a68[:, :68], tb2_68[:, :68],
                                                 cfg.crop_size)
        mask1 = mask2 = None
        if cfg.blendbg:
            mask1 = sparse_image_warp(mask, a_681.flip(-1),
                                      tb_681.flip(-1))[0]
            mask2 = sparse_image_warp(mask, a_681.flip(-1),
                                      tb2_681.flip(-1))[0]
        static_warp = None
        if cfg.warp_loss == 2:
            static_warp = sparse_image_warp(fakeB_static, a_681.flip(-1),
                                            tb_681.flip(-1))[0]
        elif cfg.warp_loss == 1:
            static_warp = batch["fakeB_static_warp"]
        return dict(real_A_fore=real_A_fore, fakeB_static=fakeB_static,
                    iw_flow=iw_flow, if_mask=if_mask, iw_flow2=iw_flow2,
                    if_mask2=if_mask2, mask1=mask1, mask2=mask2,
                    warp_motion=motion, warp_motion2=motion2,
                    fakeB_static_warp=static_warp)

    def g_forward(self, g: nn.Module, batch: dict, shared: dict
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """The two generator forwards (each recomputed in the backward under
        ``cfg.remat``), blended into the static drawing with blendbg."""
        fakes = []
        for suffix in ("", "2"):
            args = (shared["real_A_fore"], batch["A_lm"],
                    batch[f"tB{suffix}_lm"], shared[f"warp_motion{suffix}"],
                    shared[f"iw_flow{suffix}"], shared[f"if_mask{suffix}"])
            if self.cfg.remat and torch.is_grad_enabled():
                fake = torch.utils.checkpoint.checkpoint(
                    g, *args, use_reentrant=False)
            else:
                fake = g(*args)
            if self.cfg.blendbg:
                m = shared[f"mask{suffix or 1}"]
                fb = shared["fakeB_static"]
                fake = ((fake / 2 + 0.5) * m + (fb / 2 + 0.5) * (1 - m)) \
                    * 2 - 1
            fakes.append(fake)
        return fakes[0], fakes[1]

    def _local_ds(self, with_real: bool) -> list:
        cfg = self.cfg
        out = []
        for on, name, kind in ((cfg.use_mask, "d_a_l", ""),
                               (cfg.use_eye_mask, "d_a_le", "e"),
                               (cfg.use_lip_mask, "d_a_ll", "l")):
            if on:
                keys = (f"B_mask{kind}", f"B2_mask{kind}")
                out.append((name, (f"Br_mask{kind}",) + keys if with_real
                            else keys))
        return out

    def g_loss(self, g: nn.Module, d: nn.ModuleDict, batch: dict,
               shared: dict, frozen: FrozenNets):
        """(G's loss, fake_B, fake_B2, the named losses)."""
        cfg = self.cfg
        fake_B, fake_B2 = self.g_forward(g, batch, shared)
        cs = float(cfg.crop_size)
        losses = {}
        la, la2 = self.d_apply_stacked(d["d_a"], [fake_B, fake_B2],
                                       [True, True])
        losses["G_A"] = loss = la + la2
        for name, (m1, m2) in self._local_ds(with_real=False):
            l1, l2 = self.d_apply_stacked(
                d[name], [masked(fake_B, batch[m1], cfg.mask_type),
                          masked(fake_B2, batch[m2], cfg.mask_type)],
                [True, True])
            losses[f"G_{name}"] = l_local = (l1 + l2) * cfg.lambda_g_a_l
            loss = loss + l_local
        if cfg.coherent:
            losses["G_A_coh"] = l_coh = self.crit(
                d["d_a_coh"](torch.cat([fake_B, fake_B2], dim=1)), True
            ) * cfg.lambda_g_a_coh
            loss = loss + l_coh

        # the geometry loss through the frozen MobileFaceNet
        fb_lm = extract_landmarks(frozen.mobilefacenet, fake_B,
                                  batch["winB"])
        fb2_lm = extract_landmarks(frozen.mobilefacenet, fake_B2,
                                   batch["winB2"])
        tb = batch["tB_lm_68"][:, :68]
        tb2 = batch["tB2_lm_68"][:, :68]

        def mse(a, b):
            return torch.mean(torch.square(a / cs - b / cs))

        if cfg.more_weight_for_lip == 2:
            l_geom = (mse(fb_lm[:, :48], tb[:, :48]) * cfg.lambda_geom
                      + mse(fb_lm[:, 48:68], tb[:, 48:68])
                      * cfg.lambda_geom * 2
                      + mse(fb2_lm[:, :48], tb2[:, :48]) * cfg.lambda_geom
                      + mse(fb2_lm[:, 48:68], tb2[:, 48:68])
                      * cfg.lambda_geom * 2)
        else:
            l_geom = (mse(fb_lm, tb) + mse(fb2_lm, tb2)) * cfg.lambda_geom
        losses["geom_B"] = l_geom
        loss = loss + l_geom

        if cfg.lambda_geom_lipline > 0:
            m1 = lipline_mask(tb, self.lip_edges, cfg.crop_size)
            m2 = lipline_mask(tb2, self.lip_edges, cfg.crop_size)
            losses["geom_B_lipline"] = l_lip = (
                torch.mean((fake_B + 1.0) * m1)
                + torch.mean((fake_B2 + 1.0) * m2)) * cfg.lambda_geom_lipline
            loss = loss + l_lip
        if cfg.warp_loss:
            losses["warp_B"] = l_warp = torch.mean(torch.abs(
                fake_B - shared["fakeB_static_warp"])) * cfg.lambda_warp
            loss = loss + l_warp

        # inter-frame coherence: fake_B2 against the TPS-warped, detached
        # fake_B
        with torch.no_grad():
            fb_warp = sparse_image_warp(fake_B.detach(), tb.flip(-1),
                                        tb2.flip(-1))[0]
        losses["warp_inter1"] = l_inter = torch.mean(torch.abs(
            fake_B2 - fb_warp)) * cfg.lambda_warp_inter
        loss = loss + l_inter

        if cfg.identity_loss == 2:
            def rep3(x):
                return x.repeat(1, 3, 1, 1) if x.shape[1] == 1 else x

            f_crop = crop_head_bbox(rep3(fake_B), batch["winB"],
                                    cfg.face_crop_hw)
            s_crop = crop_head_bbox(rep3(shared["fakeB_static"]),
                                    batch["winA"], cfg.face_crop_hw)
            losses["iden_B"] = l_iden = face_loss(
                frozen.sphere, f_crop, s_crop) * cfg.lambda_face
            loss = loss + l_iden
        losses["G"] = loss
        return loss, fake_B, fake_B2, losses

    def d_loss(self, d: nn.ModuleDict, batch: dict, fake_B, fake_B2,
               pooled_B, pooled_B2):
        """(the discriminators' loss, the named losses) on detached fakes."""
        cfg = self.cfg
        losses = {}

        def basic3(name, real, f1, f2):
            if cfg.check_fakeb2_in_backward_d:
                lr_, lf1, lf2 = self.d_apply_stacked(
                    d[name], [real, f1, f2], [True, False, False])
                return (lr_ + (lf1 + lf2) / 2.0) / 2.0
            lr_, lf1 = self.d_apply_stacked(d[name], [real, f1],
                                            [True, False])
            return (lr_ + lf1) * 0.5

        losses["D_A"] = loss = basic3("d_a", batch["real_B"], fake_B,
                                      fake_B2)
        for name, (mr, m1, m2) in self._local_ds(with_real=True):
            losses[f"D_{name}"] = l = basic3(
                name, masked(batch["real_B"], batch[mr], cfg.mask_type),
                masked(fake_B, batch[m1], cfg.mask_type),
                masked(fake_B2, batch[m2], cfg.mask_type))
            loss = loss + l
        if cfg.coherent:
            real_pair = torch.cat([batch["B1_img"], batch["B2_img"]], dim=1)
            fake_pair = torch.cat([pooled_B, pooled_B2], dim=1)
            if cfg.coh_use_more:
                extra = torch.cat([batch["B3"], batch["B4"]], dim=1)
                lr_, lf, lf2 = self.d_apply_stacked(
                    d["d_a_coh"], [real_pair, fake_pair, extra],
                    [True, False, False])
                l = (lr_ + lf + lf2) / 3.0
            else:
                lr_, lf = self.d_apply_stacked(
                    d["d_a_coh"], [real_pair, fake_pair], [True, False])
                l = (lr_ + lf) * 0.5
            losses["D_A_coh"] = l
            loss = loss + l
        return loss, losses

    def grads(self, state: TrainState, batch: dict, frozen: FrozenNets,
              gen: torch.Generator) -> Grads:
        """The G-then-D gradient pass of one step; ``state`` is not
        modified. The G gradients are taken with respect to G's parameters
        only (the discriminators' weight gradients are never formed in the
        G pass); the D loss sees the fakes detached. ``gen`` draws the two
        pool queries."""
        shared = self.forward_shared(batch, frozen)
        g_names, g_params = zip(*state.g.named_parameters())
        g_loss, fake_B, fake_B2, g_losses = self.g_loss(
            state.g, state.d, batch, shared, frozen)
        g_grads = torch.autograd.grad(g_loss, g_params)
        fake_B, fake_B2 = fake_B.detach(), fake_B2.detach()
        pool, count, pooled_B = pool_query(state.pool, state.pool_count,
                                           fake_B, gen)
        pool, count, pooled_B2 = pool_query(pool, count, fake_B2, gen)
        d_loss, d_losses = self.d_loss(state.d, batch, fake_B, fake_B2,
                                       pooled_B, pooled_B2)
        d_names, d_params = zip(*state.d.named_parameters())
        d_grads = torch.autograd.grad(d_loss, d_params, allow_unused=True)
        d_grads = [torch.zeros_like(p) if gr is None else gr
                   for p, gr in zip(d_params, d_grads)]
        return Grads(g=dict(zip(g_names, g_grads)),
                     d=dict(zip(d_names, d_grads)), pool=pool,
                     pool_count=count,
                     metrics={k: v.detach() for k, v in
                              {**g_losses, **d_losses}.items()})

    @torch.no_grad()
    def visuals(self, state: TrainState, batch: dict, frozen: FrozenNets
                ) -> tuple[dict, dict]:
        """The dashboard snapshot of the current generator (the JAX
        ``visuals_fn``): the batch's images, the static drawing and both
        fakes, NCHW; and the MobileFaceNet landmarks of the fakes beside
        the targets and face windows, for the detected-vs-target overlays
        (``fake_B_lm_68_vis``/``_vist``, geomgm_ifw_fore_model.py:722-731)."""
        shared = self.forward_shared(batch, frozen)
        fake_B, fake_B2 = self.g_forward(state.g, batch, shared)
        mfn = frozen.mobilefacenet
        visuals = dict(real_A=batch["real_A"], real_B=batch["real_B"],
                       A_lm=batch["A_lm"], tB_lm=batch["tB_lm"],
                       fakeB_static=shared["fakeB_static"], fake_B=fake_B,
                       fake_B2=fake_B2)
        aux = dict(fb_lm=extract_landmarks(mfn, fake_B, batch["winB"]),
                   fb2_lm=extract_landmarks(mfn, fake_B2, batch["winB2"]),
                   tb_lm=batch["tB_lm_68"][:, :68],
                   tb2_lm=batch["tB2_lm_68"][:, :68],
                   winB=batch["winB"], winB2=batch["winB2"])
        return visuals, aux

    def step(self, state: TrainState, batch: dict, frozen: FrozenNets,
             gen: torch.Generator) -> dict[str, torch.Tensor]:
        """One training step, in place: both gradients from the old state,
        then both Adam updates at ``lr_at(cfg, state.step)``. Returns the
        losses."""
        grads = self.grads(state, batch, frozen, gen)
        lr = lr_at(self.cfg, state.step)
        for net, opt, gr in ((state.g, state.g_opt, grads.g),
                             (state.d, state.d_opt, grads.d)):
            for name, p in net.named_parameters():
                p.grad = gr[name]
            for group in opt.param_groups:
                group["lr"] = lr
            opt.step()
            opt.zero_grad(set_to_none=True)
        state.pool, state.pool_count = grads.pool, grads.pool_count
        state.step += 1
        return grads.metrics


def build_train_step(cfg: Module2Config) -> Module2TrainStep:
    """The Module2 train step of ``cfg``."""
    return Module2TrainStep(cfg)
