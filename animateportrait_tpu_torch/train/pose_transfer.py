"""The pose-transfer GAN trainer (the intrinsic-flow training wrapper). Port
of ``animateportrait_tpu/train/pose_transfer.py``
(Module2/intrinsic_flow_models/pose_transfer_model.py): a frozen flow net
predicts the flow and visibility on the fly (no gradient), the flow is
masked and scaled x20 (:178-196), the source image and features are
warped to the target pose, the generator (DualUnet or Unet, or with
``G_pix_warp`` the pixel warper netPW over a frozen G, :112-116) renders
the target, and L1 + VGG content/style (+ LSGAN) losses drive
simultaneous Adam updates of G (or PW) and D from one forward (:307-321).

As in the JAX step, both gradients come from the state before either
update: G's loss sees D on its running statistics; D's loss sees the real
pair in training mode (its statistics update from it) and the detached
fake on the running statistics it had before. Adam is torch's with L2
weight decay in the gradient (the JAX ``_torch_adam``). NCHW; keypoints
(N, K, 2) in (x, y) pixels.

On one card with fp32 parameters the step replays one CUDA graph a batch
layout (``_StepGraph``, up to ``MAX_GRAPHS``): the first call of a layout
runs the step eagerly on a side stream, the second captures and replays
it, later ones replay it. BatchNorm in training mode binds its statistics
to new tensors on every call (``nn.py``), which a replay would not see:
the graph's step ends by copying each module's new statistics into the
tensors it held before and binding it to them again (``_StaticStats``).
Adam is then ``capturable``. Anything else (the host, another dtype, a
third layout, ``test``) runs the eager step.

Spans (``utils/observe.py``, recorded only under a profiler): ``pt.step``
(request id: the trainer's step count) holds ``pt.flow`` (keypoint maps,
the frozen flow net, visibility, the image warp), ``pt.g_forward``,
``pt.g_loss`` (L1, VGG, GAN), ``pt.g_grad``, ``pt.d_loss``, ``pt.d_grad``
and ``pt.adam``; the counter ``pt.feature_warps`` counts the
``warp_acc_flow`` calls (the image warp here, the skip warps in
``DualUnetGenerator``). A replay runs no Python: the inner spans and
``pt.feature_warps`` record the eager, warm-up and capture steps only,
``pt.step`` every step. Counters ``pt.graph_capture`` and
``pt.graph_replay`` count the graphs' captures and replays.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings

import torch
import torch.nn as nn

from animateportrait_tpu_torch.models.flowunet import (
    FlowUnet, kp_to_map_binary)
from animateportrait_tpu_torch.models.flowunet_extra import (
    DualUnetGenerator, IFUnetGenerator, IFUnetGeneratorMultiOutput)
from animateportrait_tpu_torch.models.image_translation import Vgg19Features
from animateportrait_tpu_torch.nn import BatchNorm2d
from animateportrait_tpu_torch.ops.warp import warp_acc_flow
from animateportrait_tpu_torch.train.optim import adam
from animateportrait_tpu_torch.utils import observe
from animateportrait_tpu_torch.utils.device import (
    DEFAULT_DEVICE, resolve_device)
from animateportrait_tpu_torch.utils.metrics import psnr_ref, ssim_ref


class BNPatchDiscriminator(nn.Module):
    """NLayerDiscriminator of intrinsic_flow_models/networks.py:750-798:
    the PatchGAN with its default BatchNorm2d, an output bias and a
    sigmoid head for dcgan; keys ``model.{i}``."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3,
                 use_sigmoid: bool = False):
        super().__init__()
        layers = [nn.Conv2d(input_nc, ndf, 4, 2, 1), nn.LeakyReLU(0.2)]
        mult = 1
        for n in range(1, n_layers + 1):
            prev, mult = mult, min(2 ** n, 8)
            layers += [nn.Conv2d(ndf * prev, ndf * mult, 4,
                                 2 if n < n_layers else 1, 1, bias=False),
                       BatchNorm2d(ndf * mult), nn.LeakyReLU(0.2)]
        layers.append(nn.Conv2d(ndf * mult, 1, 4, 1, 1))
        if use_sigmoid:
            layers.append(nn.Sigmoid())
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        return self.model(x)


def gan_loss(pred, target_is_real: bool, gan_type: str = "lsgan"):
    """modules.GANLoss (modules.py:222-241): MSE for lsgan, binary cross
    entropy of the (already sigmoided) output for dcgan."""
    t = 1.0 if target_is_real else 0.0
    if gan_type == "lsgan":
        return torch.mean(torch.square(pred - t))
    p = torch.clamp(pred, 1e-7, 1.0 - 1e-7)
    return -torch.mean(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))


# shifted-Gram offsets per VGG slice (modules.py:251), content weights
_SHIFT_DELTA = ((0, 2, 4, 8, 16), (0, 2, 4, 8), (0, 2, 4), (0, 2), (0,))
_CONTENT_W = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)


@functools.lru_cache(maxsize=None)
def _imagenet_stats(device: torch.device, dtype: torch.dtype):
    """ImageNet's mean and std as (1, 3, 1, 1) tensors, made once a device
    and dtype: a copy from host memory on every call would keep the step
    out of a CUDA graph."""
    return tuple(torch.tensor(v, dtype=dtype, device=device).reshape(
        1, 3, 1, 1) for v in ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)))


def _pt_normalize(x):
    """modules.VGGLoss.normalize (:339-347): [-1, 1] -> ImageNet stats."""
    mean, std = _imagenet_stats(x.device, x.dtype)
    return (x * 0.5 + 0.5 - mean) / std


def _gram(feat):
    """Per-sample Gram (modules.py:349-355)."""
    b, c, h, w = feat.shape
    f = feat.reshape(b, c, h * w)
    return f @ f.transpose(1, 2) / (c * h * w)


def _shifted_gram(feat, dx: int, dy: int):
    """modules.py:357-363: the Gram of a feature map and its (dx, dy)
    shifted self."""
    b, c, h, w = feat.shape
    f1 = feat[:, :, dy:, dx:].reshape(b, c, -1)
    f2 = feat[:, :, :h - dy, :w - dx].reshape(b, c, -1)
    return f1 @ f2.transpose(1, 2) / (c * h * w)


def pt_vgg_loss(vgg: Vgg19Features, x, y, loss_type: str = "content",
                shifted_style: bool = False, content_weights=_CONTENT_W):
    """modules.VGGLoss forward (:286-337) on [-1, 1] images. content: the
    weighted per-slice L1; style: per sample, each slice's squared Gram
    difference summed over its entries (and the shifted-Gram terms with
    ``shifted_style``), averaged over the batch. y carries no gradient."""
    fx = vgg(_pt_normalize(x))
    with torch.no_grad():
        fy = vgg(_pt_normalize(y))
    bsz = x.shape[0]
    loss = 0.0
    if loss_type == "content":
        for i, (a, b) in enumerate(zip(fx, fy)):
            loss = loss + content_weights[i] * torch.mean(torch.abs(a - b))
        return loss
    for i, (a, b) in enumerate(zip(fx, fy)):
        for d in (_SHIFT_DELTA[i] if shifted_style else (0,)):
            if d == 0:
                diff = torch.square(_gram(a) - _gram(b))
                loss = loss + diff.reshape(bsz, -1).sum(1).mean()
            else:
                dh = torch.square(_shifted_gram(a, d, 0)
                                  - _shifted_gram(b, d, 0))
                dv = torch.square(_shifted_gram(a, 0, d)
                                  - _shifted_gram(b, 0, d))
                loss = loss + 0.5 * (dh + dv).reshape(bsz, -1).sum(1).mean()
    return loss


@dataclasses.dataclass(frozen=True)
class PoseTransferConfig:
    """The PoseTransferModel options the step depends on
    (pose_transfer_model.py:21-152 and its train_opt defaults)."""

    which_model_G: str = "dual_unet"  # 'unet' | 'dual_unet'
    G_nf: int = 32
    G_max_nf: int = 128
    G_n_scale: int = 7
    G_n_warp_scale: int = 5
    G_norm: str = "batch"
    G_vis_mode: str = "residual"
    G_activation: str = "relu"  # 'relu' | 'leaky_relu' (slope 0.1)
    G_no_end_norm: bool = False
    G_feat_warp: bool = True
    G_pix_warp: bool = False       # train netPW only, G frozen (:112-116)
    G_pix_warp_detach: bool = True
    flow_on_the_fly: bool = True
    flow_scale: float = 20.0       # :178
    joint_nc: int = 68
    size: int = 224
    D_nf: int = 64
    D_n_layers: int = 3
    gan_type: str = "lsgan"        # 'lsgan' | 'dcgan'
    shifted_style_loss: bool = False
    loss_weight_l1: float = 1.0
    loss_weight_content: float = 1.0
    loss_weight_style: float = 0.0
    loss_weight_gan: float = 0.01
    lr: float = 2e-4
    lr_D: float = 2e-4
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 0.0
    weight_decay_D: float = 4e-4

    @property
    def slope(self) -> float:
        return 0.1 if self.G_activation == "leaky_relu" else 0.0

    @property
    def use_gan(self) -> bool:
        return self.loss_weight_gan > 0


def _check_size(cfg: PoseTransferConfig) -> None:
    """The generators halve the side ``G_n_scale`` times and double it
    back, so 2^G_n_scale must divide ``size`` (the options' 224 is not a
    multiple of 2^7; 256 is)."""
    if cfg.size % 2 ** cfg.G_n_scale:
        raise ValueError(
            f"size {cfg.size} is not a multiple of 2^G_n_scale = "
            f"{2 ** cfg.G_n_scale} (G_n_scale {cfg.G_n_scale})")


def build_g(cfg: PoseTransferConfig) -> nn.Module:
    """The generation module (:26-38): DualUnet over (pose, appearance),
    or the Unet over their channel concatenation."""
    _check_size(cfg)
    if cfg.which_model_G == "dual_unet":
        return DualUnetGenerator(
            pose_nc=cfg.joint_nc, appearance_nc=3, output_nc=3,
            nf=cfg.G_nf, max_nf=cfg.G_max_nf, num_scales=cfg.G_n_scale,
            num_warp_scales=cfg.G_n_warp_scale, vis_mode=cfg.G_vis_mode,
            no_end_norm=cfg.G_no_end_norm)
    return IFUnetGenerator(3 + cfg.joint_nc, output_nc=3, nf=cfg.G_nf,
                           max_nf=cfg.G_max_nf, num_scales=cfg.G_n_scale,
                           slope=cfg.slope)


def build_pw(cfg: PoseTransferConfig) -> nn.Module:
    """netPW over G's image (3), the warped image (3), the visibility (1)
    and the flow (2) (:62-79)."""
    return IFUnetGeneratorMultiOutput(9, output_nc=(1,), nf=32, max_nf=128,
                                      num_scales=cfg.G_n_scale)


def build_d(cfg: PoseTransferConfig) -> BNPatchDiscriminator:
    """D over img_1, img_2 or the output, and joint_2 (:86)."""
    return BNPatchDiscriminator(6 + cfg.joint_nc, ndf=cfg.D_nf,
                                n_layers=cfg.D_n_layers,
                                use_sigmoid=cfg.gan_type == "dcgan")


class PoseTransferTrainer:
    """step(batch) -> metrics; test(batch) -> (out, {"PSNR", "SSIM"}).
    batch: img_1, img_2 (N,3,H,W) in [-1, 1]; kp_1, kp_2 (N,K,2); without
    ``flow_on_the_fly`` also flow_2to1 (N,2,H,W) and vis_2 (N,1,H,W).
    ``netf`` (FlowUnet) and ``vgg`` are frozen; ``d`` is needed when
    ``cfg.use_gan``, ``pw`` when ``cfg.G_pix_warp``."""

    def __init__(self, cfg: PoseTransferConfig, g: nn.Module,
                 netf: FlowUnet, vgg: Vgg19Features,
                 d: nn.Module | None = None, pw: nn.Module | None = None,
                 device: torch.device | str = DEFAULT_DEVICE):
        _check_size(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.g = g.to(dev)
        self.pw = pw.to(dev) if pw is not None else None
        self.d = d.to(dev) if d is not None else None
        self.netf = netf.to(dev).eval().requires_grad_(False)
        self.vgg = vgg.to(dev).eval().requires_grad_(False)
        trained = self.pw if cfg.G_pix_warp else self.g
        self.opt_g = adam(trained.parameters(), cfg.lr, cfg.beta1,
                          cfg.beta2, cfg.weight_decay)
        self.opt_d = adam(self.d.parameters(), cfg.lr_D, cfg.beta1,
                          cfg.beta2, cfg.weight_decay_D) \
            if cfg.use_gan else None
        self.steps = 0
        self._graphs = None

    @property
    def trained(self) -> nn.Module:
        return self.pw if self.cfg.G_pix_warp else self.g

    def forward(self, batch: dict, train: bool) -> dict:
        """pose_transfer_model.forward (:176-237)."""
        cfg = self.cfg
        size = (cfg.size, cfg.size)
        with observe.span("pt.flow"):
            j1 = kp_to_map_binary(size, batch["kp_1"])
            j2 = kp_to_map_binary(size, batch["kp_2"])
            if cfg.flow_on_the_fly:
                with torch.no_grad():
                    flow_raw, vis_logits, _, _ = self.netf(
                        torch.cat([j1, j2], dim=1))
                    vis = torch.argmax(vis_logits, dim=1,
                                       keepdim=True).float()
                    mask = (vis < 2).float()
                    flow = flow_raw * cfg.flow_scale * mask
            else:
                flow, vis = batch["flow_2to1"], batch["vis_2"]
                mask = (vis < 2).float()
            # invalid regions take -1 (modules.warp_acc_flow mask_value)
            img_warp = warp_acc_flow(batch["img_1"], flow, mask=mask)
            observe.count("pt.feature_warps", 1)
        out = {"flow_out": flow, "vis_out": vis, "mask_out": mask, "j2": j2,
               "img_warp": img_warp}
        with observe.span("pt.g_forward"):
            self.g.train(train and not cfg.G_pix_warp)
            with torch.set_grad_enabled(torch.is_grad_enabled()
                                        and not cfg.G_pix_warp):
                if cfg.which_model_G == "dual_unet":
                    fw = (flow, vis) if cfg.G_feat_warp else (None, None)
                    raw = self.g(j2, batch["img_1"], *fw)
                else:
                    raw = self.g(torch.cat([batch["img_1"], j2], dim=1))
            if not cfg.G_pix_warp:
                out["img_out"] = torch.tanh(raw)
                return out
            # the pixel-warper stage over the frozen G (:220-229)
            out["img_out_G"] = torch.tanh(raw).detach()
            self.pw.train(train)
            heads = self.pw(torch.cat([out["img_out_G"], out["img_warp"],
                                       vis, flow], dim=1))
            pmask = torch.sigmoid(heads[0])
            out["pix_mask"] = pmask
            out["img_out"] = out["img_warp"] * pmask \
                + out["img_out_G"] * (1.0 - pmask)
            return out

    def g_losses(self, batch: dict) -> tuple[dict, dict]:
        cfg = self.cfg
        out = self.forward(batch, train=True)
        img_out, img_tar = out["img_out"], batch["img_2"]
        with observe.span("pt.g_loss"):
            m = {"loss_l1": torch.mean(torch.abs(img_out - img_tar)),
                 "loss_content": pt_vgg_loss(self.vgg, img_out, img_tar,
                                             "content")}
            loss = m["loss_l1"] * cfg.loss_weight_l1 \
                + m["loss_content"] * cfg.loss_weight_content
            if cfg.loss_weight_style > 0:
                m["loss_style"] = pt_vgg_loss(self.vgg, img_out, img_tar,
                                              "style", cfg.shifted_style_loss)
                loss = loss + m["loss_style"] * cfg.loss_weight_style
            if cfg.use_gan:
                self.d.eval()
                m["loss_G"] = gan_loss(self.d(torch.cat(
                    [batch["img_1"], img_out, out["j2"]], dim=1)), True,
                    cfg.gan_type)
                loss = loss + m["loss_G"] * cfg.loss_weight_gan
            m["loss"] = loss
        return out, m

    def d_loss(self, batch: dict, out: dict) -> torch.Tensor:
        """The fake pair on D's running statistics first, then the real
        pair in training mode, whose batch statistics update them."""
        cfg = self.cfg
        self.d.eval()
        fake = self.d(torch.cat([batch["img_1"], out["img_out"].detach(),
                                 out["j2"]], dim=1))
        self.d.train()
        real = self.d(torch.cat([batch["img_1"], batch["img_2"], out["j2"]],
                                dim=1))
        return 0.5 * (gan_loss(real, True, cfg.gan_type)
                      + gan_loss(fake, False, cfg.gan_type))

    def step(self, batch: dict) -> dict[str, torch.Tensor]:
        """One optimize_parameters cycle; the gradients stay in the
        parameters' ``.grad`` (a replayed step overwrites them in place).
        Span ``pt.step`` carries the step count as its request id."""
        observe.request(self.steps)
        with observe.span("pt.step"):
            graph = self._graph(batch)
            m = self._step(batch) if graph is None else graph.step(batch)
            self.steps += 1
        return m

    def _graph(self, batch: dict) -> "_StepGraph | None":
        """The step's CUDA graph for ``batch``'s layout, made on the
        layout's first call; None where the step runs eagerly: off the
        card, parameters other than fp32, a batch value that is not a
        tensor on the trainer's card, or past ``MAX_GRAPHS`` layouts.
        Graphs of other nets, optimizers or optimizer settings are
        dropped."""
        dev = next(self.g.parameters()).device
        if dev.type != "cuda" or not all(
                isinstance(v, torch.Tensor) and v.device == dev
                for v in batch.values()):
            return None
        graphs = self._graphs
        if graphs is None or not graphs.holds(self):
            self._graphs = None
            nets = [n for n in (self.g, self.d, self.pw) if n is not None]
            if not all(p.dtype == torch.float32 for n in nets
                       for p in n.parameters()):
                return None
            graphs = self._graphs = _StepGraphs(self)
        return graphs.get(batch)

    def _step(self, batch: dict) -> dict[str, torch.Tensor]:
        """The step's work, run eagerly: both forwards, both gradients
        and both Adam updates; the detached losses."""
        cfg = self.cfg
        out, m = self.g_losses(batch)
        trained = [p for p in self.trained.parameters()]
        with observe.span("pt.g_grad"):
            grads = torch.autograd.grad(m["loss"], trained)
        if cfg.use_gan:
            with observe.span("pt.d_loss"):
                loss_d = self.d_loss(batch, out)
            d_params = list(self.d.parameters())
            with observe.span("pt.d_grad"):
                d_grads = torch.autograd.grad(
                    loss_d * cfg.loss_weight_gan, d_params)
            for p, g in zip(d_params, d_grads):
                p.grad = g
            m["loss_D"] = loss_d
        for p, g in zip(trained, grads):
            p.grad = g
        with observe.span("pt.adam"):
            self.opt_g.step()
            if cfg.use_gan:
                self.opt_d.step()
        with torch.no_grad():
            m["PSNR"] = psnr_ref(out["img_out"], batch["img_2"])
        return {k: v.detach() for k, v in m.items()}

    @torch.no_grad()
    def test(self, batch: dict) -> tuple[dict, dict]:
        """test (:239-246): the eval forward, PSNR and SSIM."""
        out = self.forward(batch, train=False)
        return out, {"PSNR": psnr_ref(out["img_out"], batch["img_2"]),
                     "SSIM": ssim_ref(out["img_out"], batch["img_2"])}


# batch layouts the train step captures, each its own CUDA graph; the step
# runs eagerly on others
MAX_GRAPHS = 2

_STATS = ("running_mean", "running_var", "num_batches_tracked")


class _StaticStats:
    """The BatchNorm statistics of nets, kept in the tensors each module
    held when this was made. In training mode the port's BatchNorm binds
    its statistics to new tensors on every call (an eval-mode pass whose
    autograd graph holds the old ones may still be differentiated), which
    a replayed CUDA graph would not see: ``settle`` copies each module's
    statistics into its held tensors and binds it to them again."""

    def __init__(self, *nets: nn.Module | None):
        self.held = [(m, [getattr(m, k) for k in _STATS])
                     for net in nets if net is not None
                     for m in net.modules() if isinstance(m, BatchNorm2d)]

    def settle(self) -> None:
        for m, held in self.held:
            for k, t in zip(_STATS, held):
                new = getattr(m, k)
                if new is not t:
                    t.copy_(new)
                    setattr(m, k, t)


class _StepGraphs:
    """A trainer's step graphs, one a batch layout, for one set of nets,
    optimizers and optimizer settings. Making it sets both Adams
    ``capturable`` (their ``step`` counts move to the card) and records
    the BatchNorm statistics of G, D and netPW (``_StaticStats``), which
    every graph of the set reads and writes."""

    def __init__(self, trainer: PoseTransferTrainer):
        self.trainer = trainer
        self.owner = self._owner(trainer)
        for opt in self._opts(trainer):
            for group in opt.param_groups:
                group["capturable"] = True
            for p, st in opt.state.items():
                if "step" in st:
                    st["step"] = st["step"].to(p.device)
        self.settings = self._settings(trainer)
        self.stats = _StaticStats(trainer.g, trainer.d, trainer.pw)
        self.graphs: dict[tuple, _StepGraph] = {}

    @staticmethod
    def _opts(tr: PoseTransferTrainer) -> list:
        return [o for o in (tr.opt_g, tr.opt_d) if o is not None]

    @classmethod
    def _owner(cls, tr: PoseTransferTrainer) -> tuple:
        """What a graph holds fixed, by identity: the configuration, the
        nets, the optimizers and their state and groups
        (``load_state_dict`` replaces them)."""
        opts = cls._opts(tr)
        return (tr.cfg, tr.g, tr.d, tr.pw, tr.netf, tr.vgg, *opts,
                *(o.state for o in opts), *(o.param_groups for o in opts))

    @classmethod
    def _settings(cls, tr: PoseTransferTrainer) -> list:
        """What a capture takes in of the groups, by value: the learning
        rate, the betas, the decay."""
        return [{k: v for k, v in g.items() if k != "params"}
                for o in cls._opts(tr) for g in o.param_groups]

    def holds(self, tr: PoseTransferTrainer) -> bool:
        owner = self._owner(tr)
        return (len(owner) == len(self.owner)
                and all(a is b for a, b in zip(owner, self.owner))
                and self._settings(tr) == self.settings)

    def get(self, batch: dict) -> _StepGraph | None:
        key = tuple((k, v.shape, v.dtype) for k, v in batch.items())
        graph = self.graphs.get(key)
        if graph is None and len(self.graphs) < MAX_GRAPHS:
            graph = self.graphs[key] = _StepGraph(self, batch)
        return graph


class _StepGraph:
    """``PoseTransferTrainer.step`` as one CUDA graph, for one batch
    layout. Its first call is the warm-up: the step that is captured, run
    eagerly on a side stream, a real update. The second call captures it
    and replays it, and every later call replays it. The step's body ends
    by settling the BatchNorm statistics, so a replay reads and writes the
    same tensors. Each call first settles them too (an eager step in
    between binds new ones), copies the batch into the graph's inputs,
    points the parameters' ``.grad`` at the graph's gradients after a
    replay and returns a copy of the losses. Counters ``pt.graph_capture``
    and ``pt.graph_replay`` (``utils/observe.py``)."""

    def __init__(self, graphs: _StepGraphs, batch: dict):
        self.graphs = graphs
        self.batch = {k: v.clone() for k, v in batch.items()}
        self.graph = self.losses = self.names = None
        self.grads = []

    def _body(self) -> torch.Tensor:
        """The step on the graph's inputs, its statistics settled; the
        losses stacked."""
        tr = self.graphs.trainer
        m = tr._step(self.batch)
        self.graphs.stats.settle()
        nets = [tr.trained] + ([tr.d] if tr.cfg.use_gan else [])
        self.grads = [(p, p.grad) for n in nets for p in n.parameters()]
        self.names = list(m)
        return torch.stack(list(m.values()))

    def step(self, batch: dict) -> dict[str, torch.Tensor]:
        self.graphs.stats.settle()
        torch._foreach_copy_(list(self.batch.values()),
                             [batch[k] for k in self.batch])
        if self.losses is None:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side), warnings.catch_warnings():
                # Adam warns of a capturable step run outside a capture
                warnings.filterwarnings("ignore", ".*capturable=True")
                self.losses = self._body()
            torch.cuda.current_stream().wait_stream(side)
        elif self.graph is None:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self.losses = self._body()
            self.graph = graph
            observe.count("pt.graph_capture", 1)
        if self.graph is not None:
            self.graph.replay()
            observe.count("pt.graph_replay", 1)
            for p, g in self.grads:
                if p.grad is not g:
                    p.grad = g
        return dict(zip(self.names, self.losses.clone().unbind()))
