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
On one card ``step`` replays the whole step as one CUDA graph
(``_StepGraph``); everywhere else it runs eagerly.
``cfg.remat`` recomputes each generator forward in the backward
(``torch.utils.checkpoint``, as ``jax.checkpoint`` in JAX); K2 runs again
in the recompute and K2b takes the statistics of that run.

``cfg.compute_dtype="bfloat16"`` is the JAX package's mixed precision: every
network forward and backward in bf16, on bf16 casts of the fp32 master
parameters of G and the Ds (``torch.func.functional_call``; the casts are
differentiable, so the gradients reach the masters in fp32, as through
JAX's ``_cast``) and on bf16 copies of the frozen nets, every leaf cast
(BatchNorm statistics too), made once per ``FrozenNets``. The nets' outputs
come back to fp32; the losses, the TPS solves, the motion grids, the flows,
the pool and Adam stay fp32. InstanceNorm runs K2 and K2b in bf16 on the
card. ``torch.autocast`` is not used: it keeps some ops in fp32 and so
rounds elsewhere than JAX's all-bf16 activations.

A state sharded by ``train/fsdp.py:shard_state_fsdp`` (the JAX package's
FSDP) takes the same step over its group: G and the Ds gathered whole once
for the step, the gradients of the sharded leaves reduce-scattered into
each rank's slice, Adam on the slices.

Layouts: images (N, C, H, W) in [-1, 1]; landmarks (N, 68, 2) (x, y) in
crop-size pixels; motion grids (N, H, W, 2) normalized (x, y); face
windows (N, 4) [x1, x2, y1, y2]; FlowUnet flows (N, 2, H, W).
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
import warnings

import numpy as np
import torch
import torch.nn as nn
import torch.distributed as dist
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
from animateportrait_tpu_torch.utils import distributed as ddp
from animateportrait_tpu_torch.utils import observe
from animateportrait_tpu_torch.utils.assets import face_lmark_lookup
from animateportrait_tpu_torch.utils.device import (
    DEFAULT_DEVICE, device_constant, resolve_device)


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
    # "bfloat16": every network forward and backward in bf16, with fp32
    # master parameters, optimizer, losses and TPS solves
    compute_dtype: str = "float32"
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
    """Generator and discriminators (fp32 masters), their Adam states, the
    coherence pool ``(pool_size, output_nc, H, W)`` and how many of its
    slots are filled, the number of updates taken, and the compute dtype
    of the steps that trained them."""

    step: int
    g: TridentGeneratorFullIFW
    d: nn.ModuleDict            # d_a, d_a_l, d_a_le, d_a_ll, d_a_coh
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    pool: torch.Tensor
    pool_count: int
    compute_dtype: str = "float32"
    # train/fsdp.py:FSDPShards of a sharded state, else None
    fsdp: object = None


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
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
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
    [0, 1] landmarks back to window pixels -> (N, 68, 2) (x, y), fp32. A
    bf16 ``imgs`` is sampled in fp32 and the crop rounded to bf16 for a
    bf16 ``mfn``."""
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
    lm, _ = mfn((crop.to(imgs.dtype) + 1.0) * 0.5)
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
    e = device_constant("edge_anchors_256", lambda: EDGE_ANCHORS_256,
                        lm68.device)
    return torch.cat([lm68, e.expand(lm68.shape[0], 8, 2)], dim=1)


def flow_warp_fields(flowunet: FlowUnet, lm1: torch.Tensor,
                     lm2: torch.Tensor, size: int = 256
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """flow_network_warp (geomgm_ifw_fore_model.py:69-83): 68-point
    landmarks (N, 68, 2) in crop-size pixels -> (flow (N, 2, size, size),
    mask (N, 1, size, size)), fp32; FlowUnet runs in its parameters'
    dtype."""
    j1 = kp_to_map_binary((224, 224), lm1[:, :68] * (7.0 / 8.0))
    j2 = kp_to_map_binary((224, 224), lm2[:, :68] * (7.0 / 8.0))
    dtype = next(flowunet.parameters()).dtype
    flow_out, vis_out, _, _ = flowunet(torch.cat([j1, j2], dim=1).to(dtype))
    flow_out, vis_out = flow_out.float(), vis_out.float()
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


def pool_plan(count: int, pool_size: int, u: torch.Tensor,
              slots: torch.Tensor) -> tuple[list[int], int]:
    """One pool query planned on the host from its draws (``pool_draw``'s;
    draws on the card are read back, which waits on the card): returns
    (rows, new count). ``rows`` indexes the old pool with the
    query's ``b`` images after it (``pool_apply``): its first ``b``
    entries give the images out, the other ``pool_size`` the new pool.
    Slots fill in order until the pool is full; after that, with
    probability 0.5 (u > 0.5), an image swaps with the one in its drawn
    slot, and the query returns the old one. History is only returned once
    the pool was full before the query. A later image wins a slot that two
    share, as in the JAX package."""
    u, slots = u.tolist(), slots.tolist()
    b = len(u)
    rows = [pool_size + i for i in range(b)] + list(range(pool_size))
    for i in range(b):
        if count + i < pool_size:                 # filling
            rows[b + count + i] = pool_size + i
        elif count >= pool_size and u[i] > 0.5:
            rows[i] = slots[i]
            rows[b + slots[i]] = pool_size + i
    return rows, min(count + b, pool_size)


def pool_apply(pool: torch.Tensor, imgs: torch.Tensor, rows: torch.Tensor,
               out: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """A planned query on the device, branch-free: gathers the images out
    and the new pool from the old pool and the images by ``rows``
    (``pool_plan``'s, a long tensor on the pool's device), the images out
    first, then the pool. Returns (new pool, images out); with ``out``
    (the pool itself, say) the new pool is written there."""
    b = imgs.shape[0]
    both = torch.cat([pool, imgs.to(pool.dtype)])
    taken = both.index_select(0, rows[:b])
    return torch.index_select(both, 0, rows[b:], out=out), taken


def pool_swap(pool: torch.Tensor, count: int, imgs: torch.Tensor,
              u: torch.Tensor, slots: torch.Tensor
              ) -> tuple[torch.Tensor, int, torch.Tensor]:
    """The image pool (util/image_pool.py:23-54) given the draws: returns
    (new pool, new count, images out), ``pool_plan`` then ``pool_apply``
    (see there). ``pool`` is not modified."""
    with observe.span("m2.pool_fetch"):
        rows, new_count = pool_plan(count, pool.shape[0], u, slots)
    rows = torch.tensor(rows, dtype=torch.long).to(pool.device)
    new_pool, out = pool_apply(pool, imgs, rows)
    return new_pool, new_count, out


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
        pool_count=0, compute_dtype=cfg.compute_dtype)


def abs_l1(x: torch.Tensor) -> torch.Tensor:
    """|x| whose derivative at an exact tie (x == 0) is 1, as ``jnp.abs``'s
    is (torch's ``abs`` takes 0 there): an L1 loss's gradient then matches
    the JAX package's on pixels where the two images agree exactly."""
    return torch.where(x >= 0, x, -x)


def broadcast_state(state: TrainState, group=None) -> None:
    """Give every rank of ``group`` rank 0's state, in place: G and the
    Ds, their Adam moments, the pool, the step and the pool count. Every
    rank's state must have the same structure (Adam's moments exist on all
    ranks or on none). Adam's per-parameter step counts (host scalars,
    which NCCL does not carry) are left as they are: every rank has taken
    or restored the same number of updates."""
    ddp.broadcast_module(state.g, group)
    ddp.broadcast_module(state.d, group)
    for opt in (state.g_opt, state.d_opt):
        ddp.broadcast_tensors([v for st in opt.state.values()
                               for k, v in st.items() if k != "step"],
                              group)
    ddp.broadcast_tensors([state.pool], group)
    counts = [state.step, state.pool_count]
    dist.broadcast_object_list(counts, src=0, group=group)
    state.step, state.pool_count = counts


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
        if cfg.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: one of "
                             f"{sorted(COMPUTE_DTYPES)}")
        self.cfg = cfg
        self.cdt = COMPUTE_DTYPES[cfg.compute_dtype]
        self.lip_edges = face_lmark_lookup()[:20]
        self._frozen = None    # (FrozenNets, their compute-dtype copies)
        # (_StepGraph.owner(...), {batch layout: _StepGraph})
        self._graphs = None

    def crit(self, pred: torch.Tensor, real: bool) -> torch.Tensor:
        return gan_loss(pred, real, self.cfg.gan_mode)

    def apply(self, net: nn.Module, *args):
        """``net(*args)`` in the compute dtype, output fp32: in bf16 on
        differentiable bf16 casts of its parameters (JAX's ``_cast``). The
        caller casts the images it passes; G's grids stay fp32."""
        if self.cdt == torch.float32:
            return net(*args)
        params = {k: p.to(self.cdt) for k, p in net.named_parameters()}
        return torch.func.functional_call(net, params, args).float()

    def frozen_nets(self, frozen: FrozenNets) -> FrozenNets:
        """The frozen nets in the compute dtype: in bf16, copies with every
        leaf cast (JAX's ``_cast(frozen.*)``: BatchNorm statistics too),
        made on the first call with this ``frozen`` and kept."""
        if self.cdt == torch.float32:
            return frozen
        if self._frozen is None or self._frozen[0] is not frozen:
            self._frozen = (frozen, FrozenNets(*(
                copy.deepcopy(getattr(frozen, f.name)).to(self.cdt)
                for f in dataclasses.fields(FrozenNets))))
        return self._frozen[1]

    def d_apply_stacked(self, d: nn.Module, xs: list, reals: list) -> list:
        """The GAN loss of each input against ``d``: one pass over the
        inputs stacked along the batch (``batch_d_passes``), or one pass
        each."""
        if self.cfg.batch_d_passes and len(xs) > 1:
            n = xs[0].shape[0]
            p = self.apply(d, torch.cat(xs, dim=0).to(self.cdt))
            return [self.crit(p[i * n:(i + 1) * n], r)
                    for i, r in enumerate(reals)]
        return [self.crit(self.apply(d, x.to(self.cdt)), r)
                for x, r in zip(xs, reals)]

    @torch.no_grad()
    def forward_shared(self, batch: dict, frozen: FrozenNets) -> dict:
        """Everything upstream of G, which carries no gradient."""
        cfg = self.cfg
        frozen = self.frozen_nets(frozen)
        real_A = batch["real_A"]
        mask = (frozen.modnet(real_A.to(self.cdt)).float() > 0.5).float()
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
        ``cfg.remat``), fp32, blended into the static drawing with
        blendbg. The images go in in the compute dtype, the motion grids,
        flows and masks in fp32."""
        fakes = []
        for suffix in ("", "2"):
            images = (shared["real_A_fore"], batch["A_lm"],
                      batch[f"tB{suffix}_lm"])
            args = (*(t.to(self.cdt) for t in images),
                    shared[f"warp_motion{suffix}"],
                    shared[f"iw_flow{suffix}"], shared[f"if_mask{suffix}"])
            if self.cfg.remat and torch.is_grad_enabled():
                fake = torch.utils.checkpoint.checkpoint(
                    self.apply, g, *args, use_reentrant=False)
            else:
                fake = self.apply(g, *args)
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
        frozen = self.frozen_nets(frozen)
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
            pair = torch.cat([fake_B, fake_B2], dim=1).to(self.cdt)
            losses["G_A_coh"] = l_coh = self.crit(
                self.apply(d["d_a_coh"], pair), True) * cfg.lambda_g_a_coh
            loss = loss + l_coh

        # the geometry loss through the frozen MobileFaceNet
        fb_lm = extract_landmarks(frozen.mobilefacenet, fake_B.to(self.cdt),
                                  batch["winB"])
        fb2_lm = extract_landmarks(frozen.mobilefacenet, fake_B2.to(self.cdt),
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
            edges = device_constant("lip_edges", lambda: self.lip_edges,
                                    tb.device)
            m1 = lipline_mask(tb, edges, cfg.crop_size)
            m2 = lipline_mask(tb2, edges, cfg.crop_size)
            losses["geom_B_lipline"] = l_lip = (
                torch.mean((fake_B + 1.0) * m1)
                + torch.mean((fake_B2 + 1.0) * m2)) * cfg.lambda_geom_lipline
            loss = loss + l_lip
        if cfg.warp_loss:
            losses["warp_B"] = l_warp = torch.mean(abs_l1(
                fake_B - shared["fakeB_static_warp"])) * cfg.lambda_warp
            loss = loss + l_warp

        # inter-frame coherence: fake_B2 against the TPS-warped, detached
        # fake_B
        with torch.no_grad():
            fb_warp = sparse_image_warp(fake_B.detach(), tb.flip(-1),
                                        tb2.flip(-1))[0]
        losses["warp_inter1"] = l_inter = torch.mean(abs_l1(
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
                frozen.sphere, f_crop.to(self.cdt), s_crop.to(self.cdt)
            ).float() * cfg.lambda_face
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
              gen: torch.Generator, group=None) -> Grads:
        """The G-then-D gradient pass of one step; ``state`` is not
        modified. The G gradients are taken with respect to G's parameters
        only (the discriminators' weight gradients are never formed in the
        G pass); the D loss sees the fakes detached. ``gen`` draws the two
        pool queries.

        With a process ``group``, ``batch`` is this rank's contiguous slice
        of the global batch (equal slices, in rank order) and the step is
        the JAX package's data-parallel one: the detached fakes of every
        rank are gathered, the pool is queried with the global batch (every
        rank draws the same, from the same step-seeded ``gen``, so the pool
        stays replicated), each rank's D loss takes its slice of the pooled
        images, and the gradients and losses are averaged over the ranks
        (the mean of equal slices' means is the global mean).

        A sharded state (``train/fsdp.py``) takes this step over its own
        group: its nets are gathered for the pass, and ``Grads`` holds
        this rank's slice of the mean of each sharded leaf's gradient."""
        fsdp = state.fsdp
        if fsdp is not None:
            if group is not None and group is not fsdp.group:
                raise ValueError("a sharded state steps over its own group")
            group = fsdp.group
        ranks = 1 if group is None else ddp.world(group)[1]
        rows, count = self._plan_pool(state, batch["real_A"].shape[0] * ranks,
                                      gen)
        rows = rows.to(state.pool.device, non_blocking=True)
        if fsdp is None:
            return self._grads(state, batch, frozen, rows, count, group)
        with fsdp.whole():
            return self._grads(state, batch, frozen, rows, count, group)

    def _plan_pool(self, state: TrainState, b: int, gen: torch.Generator
                   ) -> tuple[torch.Tensor, int]:
        """Both pool queries of a step, ``b`` images each, drawn on ``gen``
        and planned on the host (``pool_plan``; span ``m2.pool_fetch``):
        their rows, a (2, b + pool size) long tensor on the host, pinned
        where the pool is on a card so that its copy need not wait, and the
        pool's count after both. The draws depend on nothing the step
        computes, so a step plans them before its forward."""
        psize, count = state.pool.shape[0], state.pool_count
        with observe.span("m2.pool_fetch"):
            rows = []
            for _ in range(2):
                r, count = pool_plan(count, psize, *pool_draw(b, psize, gen))
                rows.append(r)
            rows = torch.tensor(rows, dtype=torch.long,
                                pin_memory=state.pool.device.type == "cuda")
        return rows, count

    def _grads(self, state: TrainState, batch: dict, frozen: FrozenNets,
               pool_rows: torch.Tensor, pool_count: int | None, group,
               pool_out: torch.Tensor | None = None) -> Grads:
        """``grads`` with the pool's two queries planned (``_plan_pool``'s
        rows on the pool's device and the count after them); with
        ``pool_out`` (the CUDA graph's step: the pool itself) the new pool
        is written there."""
        with observe.span("m2.forward_shared"):
            shared = self.forward_shared(batch, frozen)
        g_names, g_params = zip(*state.g.named_parameters())
        with observe.span("m2.g_loss"):
            g_loss, fake_B, fake_B2, g_losses = self.g_loss(
                state.g, state.d, batch, shared, frozen)
        with observe.span("m2.g_grad"):
            g_grads = torch.autograd.grad(g_loss, g_params)
        fake_B, fake_B2 = fake_B.detach(), fake_B2.detach()
        if group is None:
            queried = fake_B, fake_B2
        else:
            queried = (ddp.all_gather_batch(fake_B, group),
                       ddp.all_gather_batch(fake_B2, group))
        with observe.span("m2.pool"):
            pool, pooled_B = pool_apply(state.pool, queried[0], pool_rows[0],
                                        out=pool_out)
            pool, pooled_B2 = pool_apply(pool, queried[1], pool_rows[1],
                                         out=pool_out)
        if group is not None:
            rank, n = dist.get_rank(group), fake_B.shape[0]
            pooled_B = pooled_B[rank * n:(rank + 1) * n]
            pooled_B2 = pooled_B2[rank * n:(rank + 1) * n]
        with observe.span("m2.d_loss"):
            d_loss, d_losses = self.d_loss(state.d, batch, fake_B, fake_B2,
                                           pooled_B, pooled_B2)
        d_names, d_params = zip(*state.d.named_parameters())
        with observe.span("m2.d_grad"):
            d_grads = torch.autograd.grad(d_loss, d_params,
                                          allow_unused=True)
            d_grads = [torch.zeros_like(p) if gr is None else gr
                       for p, gr in zip(d_params, d_grads)]
        metrics = {k: v.detach() for k, v in {**g_losses, **d_losses}.items()}
        g_grads, d_grads = (dict(zip(g_names, g_grads)),
                            dict(zip(d_names, d_grads)))
        if state.fsdp is not None:
            reduced = state.fsdp.reduce_grads({"g": g_grads, "d": d_grads})
            g_grads, d_grads = reduced["g"], reduced["d"]
        elif group is not None:
            # one flattened buffer per net
            ddp.all_reduce_mean_(list(g_grads.values()), group)
            ddp.all_reduce_mean_(list(d_grads.values()), group)
        if group is not None:
            # and one for the losses
            names = list(metrics)
            stacked = [torch.stack([metrics[k].float() for k in names])]
            ddp.all_reduce_mean_(stacked, group)
            metrics = dict(zip(names, stacked[0].unbind()))
        return Grads(g=g_grads, d=d_grads, pool=pool, pool_count=pool_count,
                     metrics=metrics)

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
        mfn = self.frozen_nets(frozen).mobilefacenet
        visuals = dict(real_A=batch["real_A"], real_B=batch["real_B"],
                       A_lm=batch["A_lm"], tB_lm=batch["tB_lm"],
                       fakeB_static=shared["fakeB_static"], fake_B=fake_B,
                       fake_B2=fake_B2)
        aux = dict(fb_lm=extract_landmarks(mfn, fake_B.to(self.cdt),
                                           batch["winB"]),
                   fb2_lm=extract_landmarks(mfn, fake_B2.to(self.cdt),
                                            batch["winB2"]),
                   tb_lm=batch["tB_lm_68"][:, :68],
                   tb2_lm=batch["tB2_lm_68"][:, :68],
                   winB=batch["winB"], winB2=batch["winB2"])
        return visuals, aux

    def step(self, state: TrainState, batch: dict, frozen: FrozenNets,
             gen: torch.Generator, group=None) -> dict[str, torch.Tensor]:
        """One training step, in place: both gradients from the old state,
        then both Adam updates at ``lr_at(cfg, state.step)``. Returns the
        losses. With a process ``group``, the data-parallel step of
        ``grads``; every rank then takes the same Adam update. The span
        ``m2.step`` (``utils/observe.py``) carries ``state.step`` as its
        request id.

        On one card (no group, an unsharded fp32 state, no ``remat``) the
        step is replayed as a CUDA graph (``_StepGraph``), one for each
        layout of the batch up to ``MAX_GRAPHS``: the same kernels, issued
        by one launch. The pool is then updated in place, and Adam takes
        its ``capturable`` form.

        Its convolutions take the cuDNN algorithms measured fastest for
        their shapes (``measured_conv_choice``); a capture or a replay
        reuses what the eager step or warm-up before it measured. Counter
        ``m2.conv_autotune``: a step body so run (an eager step, a warm-up,
        a capture; a replay runs none)."""
        observe.request(state.step)
        with observe.span("m2.step"), measured_conv_choice():
            graph = self._graph_for(state, batch, frozen, group)
            if graph is not None:
                return graph.step(state, batch, gen)
            observe.count("m2.conv_autotune", 1)
            grads = self.grads(state, batch, frozen, gen, group)
            self.apply_grads(state, grads)
        return grads.metrics

    def apply_grads(self, state: TrainState, grads: Grads) -> None:
        """Both Adam updates of ``grads`` at ``lr_at(cfg, state.step)``, the
        pool after the step's queries and the step count, in place (on
        this rank's slices of a sharded state)."""
        self._adam(state, grads, lr_at(self.cfg, state.step))
        state.pool, state.pool_count = grads.pool, grads.pool_count
        state.step += 1

    def _adam(self, state: TrainState, grads: Grads, lr) -> None:
        """Both Adam updates at ``lr``, a float or a 0-d tensor on the
        card."""
        with observe.span("m2.adam"):
            for key, opt, gr in (("g", state.g_opt, grads.g),
                                 ("d", state.d_opt, grads.d)):
                params = (dict(getattr(state, key).named_parameters())
                          if state.fsdp is None else state.fsdp.masters[key])
                for name, p in params.items():
                    p.grad = gr[name]
                for group in opt.param_groups:
                    group["lr"] = lr
                opt.step()
                opt.zero_grad(set_to_none=True)

    def _graph_for(self, state: TrainState, batch: dict, frozen: FrozenNets,
                   group) -> _StepGraph | None:
        """The step's CUDA graph for this state, frozen nets and batch
        layout, made on the first call with them; None where the step runs
        eagerly: on the CPU, over a group, on a sharded, bf16 or ``remat``
        step, or past ``MAX_GRAPHS`` layouts. Graphs of another state or
        other frozen nets are dropped."""
        dev = state.pool.device
        if (dev.type != "cuda" or group is not None
                or state.fsdp is not None or self.cfg.remat
                or self.cdt != torch.float32
                or not all(isinstance(v, torch.Tensor) and v.device == dev
                           for v in batch.values())):
            return None
        owner = _StepGraph.owner(state, frozen)
        graphs = self._graphs
        if graphs is None or any(a is not b for a, b in zip(graphs[0],
                                                            owner)):
            graphs = self._graphs = (owner, {})
        key = tuple((k, v.shape, v.dtype) for k, v in batch.items())
        graph = graphs[1].get(key)
        if graph is None and len(graphs[1]) < MAX_GRAPHS:
            graph = graphs[1][key] = _StepGraph(self, state, frozen, batch)
        return graph


# batch layouts a train step captures, each its own CUDA graph; the step
# runs eagerly on others
MAX_GRAPHS = 2


# candidates of cuDNN's heuristic ranking that the measured choice times
# for each shape: at batch 1 the FFT input gradient of G's 3x3 convs ranks
# first and the direct kernel second; timing ten (torch's default) took
# ~2.5 s more of the first step on an H100 for ~2% of a step after
MEASURED_CANDIDATES = 2


@contextlib.contextmanager
def measured_conv_choice():
    """cuDNN picks each convolution's algorithm inside the block by timing
    the first ``MEASURED_CANDIDATES`` of its heuristics' ranking
    (``torch.backends.cudnn.benchmark`` and ``benchmark_limit``) in place
    of taking the first. At batch 1 the first is an FFT convolution, one
    complex matrix-vector product a frequency, for the input gradient of
    G's 3x3 residual-block convolutions (256 channels at 64x64), on an H100
    ~7x slower than the direct kernel that measures fastest. torch keeps
    one plan a shape for the process, however it was chosen: a shape is
    timed the first time the process meets it, a shape met first outside
    the block keeps the heuristics' plan, and calls outside after it reuse
    the measured one. The caller's settings are back after the block, an
    exception included. ``enabled``, ``deterministic`` and ``allow_tf32``
    stay as the caller set them: ``torch.backends.cudnn.flags`` would reset
    them to its defaults."""
    cudnn = torch.backends.cudnn
    was = cudnn.benchmark, cudnn.benchmark_limit
    cudnn.benchmark, cudnn.benchmark_limit = True, MEASURED_CANDIDATES
    try:
        yield
    finally:
        cudnn.benchmark, cudnn.benchmark_limit = was


class _StepGraph:
    """``Module2TrainStep.step`` as one CUDA graph, for one state, frozen
    nets and batch layout. Its first call is the warm-up: the step that is
    captured, run eagerly on a side stream, a real update. The second call
    captures it and replays it, and every later call replays it. Each call
    draws the pool's queries and plans them on the host (``pool_plan``,
    span ``m2.pool_fetch``), sends the plan through pinned memory, copies
    the batch and the learning rate into the graph's inputs and returns a
    copy of the losses. The warm-up measures the step's convolutions
    (``measured_conv_choice``), so the capture finds each shape chosen and
    times nothing. Counters ``m2.graph_capture``, ``m2.graph_replay`` and,
    for the warm-up and the capture, ``m2.conv_autotune``
    (``utils/observe.py``)."""

    @staticmethod
    def owner(state: TrainState, frozen: FrozenNets) -> tuple:
        """What a graph holds fixed: the state, its nets and optimizers
        and the optimizers' state and groups (``load_state_dict``
        replaces them), the frozen nets."""
        return (state, state.g, state.d, state.g_opt, state.d_opt,
                state.g_opt.state, state.d_opt.state,
                state.g_opt.param_groups, state.d_opt.param_groups, frozen)

    def __init__(self, owner: Module2TrainStep, state: TrainState,
                 frozen: FrozenNets, batch: dict):
        dev = state.pool.device
        self.train_step, self.frozen = owner, frozen
        self.batch = {k: v.clone() for k, v in batch.items()}
        self.pool = torch.empty_like(state.pool)
        self.rows = torch.zeros(
            (2, batch["real_A"].shape[0] + state.pool.shape[0]),
            dtype=torch.long, device=dev)
        self.lr = torch.zeros((), device=dev)
        self.graph = self.losses = self.names = None
        for opt in (state.g_opt, state.d_opt):
            for group in opt.param_groups:
                group["capturable"] = True
            for p, st in opt.state.items():
                if "step" in st:
                    st["step"] = st["step"].to(p.device)

    def _body(self, state: TrainState) -> torch.Tensor:
        """The step on the graph's inputs: both gradients, the pool in
        place and both Adam updates; the losses stacked."""
        step = self.train_step
        observe.count("m2.conv_autotune", 1)
        grads = step._grads(state, self.batch, self.frozen, self.rows, None,
                            None, pool_out=state.pool)
        step._adam(state, grads, self.lr)
        self.names = list(grads.metrics)
        return torch.stack([grads.metrics[k].float() for k in self.names])

    def step(self, state: TrainState, batch: dict,
             gen: torch.Generator) -> dict[str, torch.Tensor]:
        # a new pinned buffer each step: the host runs steps ahead of the
        # card, and the caching host allocator holds a buffer until its copy
        # has run
        rows, count = self.train_step._plan_pool(
            state, self.batch["real_A"].shape[0], gen)
        if state.pool is not self.pool:
            self.pool.copy_(state.pool)
            state.pool = self.pool
        lr = lr_at(self.train_step.cfg, state.step)
        self.rows.copy_(rows, non_blocking=True)
        self.lr.fill_(lr)
        torch._foreach_copy_(list(self.batch.values()),
                             [batch[k] for k in self.batch])
        if self.losses is None:
            side = torch.cuda.Stream(state.pool.device)
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side), warnings.catch_warnings():
                # Adam warns of a capturable step run outside a capture
                warnings.filterwarnings("ignore", ".*capturable=True")
                self.losses = self._body(state)
            torch.cuda.current_stream().wait_stream(side)
        elif self.graph is None:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self.losses = self._body(state)
            self.graph = graph
            observe.count("m2.graph_capture", 1)
        if self.graph is not None:
            self.graph.replay()
            observe.count("m2.graph_replay", 1)
        # the groups hold a float, as an eager step leaves them (a
        # checkpoint saves them), not the graph's input
        for opt in (state.g_opt, state.d_opt):
            for group in opt.param_groups:
                group["lr"] = lr
        state.pool_count = count
        state.step += 1
        return dict(zip(self.names, self.losses.clone().unbind()))


def build_train_step(cfg: Module2Config) -> Module2TrainStep:
    """The Module2 train step of ``cfg``."""
    return Module2TrainStep(cfg)
