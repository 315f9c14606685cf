"""The ``pose_transfer_train`` configuration's weights, batches and plain
reference step, and the comparison that decides ``correct``.

The reference step (``PoseStep``) is the intrinsic-flow pose-transfer
model's optimize_parameters cycle in plain ``torch``, fp32, over the nets
of ``frozen/models/pose.py`` and the frozen copies of FlowUnet and the
flow warp: the frozen flow net predicts the flow and visibility from the
two keypoint maps, the visibility is arg-maxed into a mask, the flow is
scaled by ``flow_scale`` and masked; the DualUnet renders the target pose
from the pose map and the source image, its skips warped by the flow;
G's loss is L1 + VGG content + LSGAN on D with D's running statistics;
D's loss is LSGAN on the detached fake (running statistics, before they
move) and on the real pair (training mode, which moves them), scaled by
``loss_weight_gan``; both gradients come from the one forward, and both
Adams (torch.optim.Adam's update written out; L2 decay in D's gradient)
step after. It imports nothing of the port, and its comparison run sets
TF32 off for cuBLAS and cuDNN.

``compare`` holds what the port's first three steps left against the
reference's from the same weights and batches: each step's losses, the
first step's gradient norm per leaf (worst and median leaf), each leaf's
change over the three steps, and G's and D's BatchNorm running statistics
after them."""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench import inputs
from portbench.reference.train import NOUGHT_GRAD, _median, _median_gap, \
    _worst_gap

# the configuration's keys that ``PoseTransferConfig`` takes
TRAINER_KEYS = (
    "which_model_G", "G_nf", "G_max_nf", "G_n_scale", "G_n_warp_scale",
    "G_norm", "G_vis_mode", "G_activation", "G_feat_warp", "flow_on_the_fly",
    "flow_scale", "joint_nc", "size", "D_nf", "D_n_layers", "gan_type",
    "loss_weight_l1", "loss_weight_content", "loss_weight_style",
    "loss_weight_gan", "lr", "lr_D", "beta1", "beta2", "weight_decay",
    "weight_decay_D")
# what the reference implements, beyond the widths
SUPPORTED = {"which_model_G": "dual_unet", "G_norm": "batch",
             "G_vis_mode": "residual", "G_activation": "relu",
             "G_feat_warp": True, "flow_on_the_fly": True,
             "G_n_residual_blocks": 2, "gan_type": "lsgan",
             "loss_weight_style": 0.0}
# the losses compared (PSNR rounds to uint8 levels, so it is not)
LOSSES = ("loss_l1", "loss_content", "loss_G", "loss", "loss_D")
# the smooth source image: box-filter passes over seeded uniform noise
SMOOTH_PASSES = 2
# the rigid move between source and target, px on each axis
MAX_SHIFT = 12


def check_config(cfg: dict) -> None:
    """Refuse a configuration outside what the reference implements."""
    bad = {k: cfg.get(k) for k, v in SUPPORTED.items() if cfg.get(k) != v}
    if bad:
        raise ValueError(f"the pose reference implements {SUPPORTED}, "
                         f"not {bad}")


def make_nets(cfg: dict, device) -> dict:
    """The reference's G, D, flow net and VGG19 on ``device``, unfilled."""
    from portbench.reference.frozen.models import pose
    from portbench.reference.frozen.models.flowunet import FlowUnet

    check_config(cfg)
    with torch.device(device):
        return {
            "g": pose.DualUnetGenerator(
                cfg["joint_nc"], nf=cfg["G_nf"], max_nf=cfg["G_max_nf"],
                num_scales=cfg["G_n_scale"],
                num_warp_scales=cfg["G_n_warp_scale"],
                n_residual_blocks=cfg["G_n_residual_blocks"]),
            "d": pose.BNPatchDiscriminator(6 + cfg["joint_nc"], cfg["D_nf"],
                                           cfg["D_n_layers"]),
            "netf": FlowUnet(input_nc=2 * cfg["joint_nc"],
                             nf=cfg["flow_nf"]),
            "vgg": pose.Vgg19Features()}


@torch.no_grad()
def fill_vgg_(vgg, seed: int):
    """torchvision's VGG init: each conv N(0, 2 / (out_channels k^2))
    (``kaiming_normal_``, fan_out, relu), biases 0; one draw of a
    generator on the net's device."""
    convs = [m for m in vgg.modules() if isinstance(m, torch.nn.Conv2d)]
    dev = convs[0].weight.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for c in convs:
        fan_out = c.out_channels * c.kernel_size[0] * c.kernel_size[1]
        c.weight.copy_(torch.randn(c.weight.shape, generator=gen,
                                   device=dev) * math.sqrt(2.0 / fan_out))
        c.bias.zero_()
    return vgg


@torch.no_grad()
def fit_flow_statistics_(netf, cfg: dict, seed: int):
    """Set the flow net's BatchNorm running statistics to those of one
    training-mode pass over a batch of the seed's keypoint-map pairs, as
    training leaves them matched to the net's activations. Seeded convs
    over the identity statistics give flows of a tenth of a pixel and
    visibility logits within 1e-4 of each other on half the pixels."""
    from portbench.reference.frozen.models.flowunet import kp_to_map_binary

    dev = next(netf.parameters()).device
    batch = make_batches(cfg, inputs.sub_seed(seed, "pose_netf_fit"), 1,
                         dev)[0]
    size = (cfg["size"], cfg["size"])
    maps = torch.cat([kp_to_map_binary(size, batch["kp_1"]),
                      kp_to_map_binary(size, batch["kp_2"])], 1)
    norms = [m for m in netf.modules()
             if isinstance(m, torch.nn.BatchNorm2d)]
    kept = [m.momentum for m in norms]
    for m in norms:
        m.momentum = 1.0
    netf.train()(maps)
    for m, k in zip(norms, kept):
        m.momentum = k
    return netf.eval()


def make_weights(cfg: dict, seed: int, device) -> dict:
    """State dicts of G, D, the flow net and VGG19 on ``device``, each net
    drawn from its own seed: G and D as the GAN code's
    ``init_weights("normal", 0.02)`` fills them, VGG19 as torchvision's
    constructor, the flow net LeCun normal (as the benchmark's other
    frozen nets) with its BatchNorm statistics fitted."""
    nets = make_nets(cfg, device)

    def seed_of(k):
        return inputs.sub_seed(seed, f"pose_{k}")

    for k in ("g", "d"):
        inputs.fill_(nets[k], seed_of(k), "gan_normal")
    fill_vgg_(nets["vgg"], seed_of("vgg"))
    fit_flow_statistics_(inputs.fill_(nets["netf"], seed_of("netf"),
                                      "lecun"), cfg, seed)
    return {k: net.state_dict() for k, net in nets.items()}


def make_batches(cfg: dict, seed: int, n: int, device) -> list[dict]:
    """``n`` resident batches of ``batch_size`` pairs at ``size``^2, each
    from its own seed: a smooth image in [-1, 1] (``img_1``), the same
    image moved rigidly by a whole number of pixels (``img_2``, rolled),
    the 68-point standard face jittered (``kp_1``, (x, y) px) and the same
    points moved alike (``kp_2``); as ``train/convergence.py:pose_batch``
    makes them at small size."""
    s, k = cfg["size"], cfg["batch_size"]
    out = []
    for i in range(n):
        rng = np.random.default_rng(inputs.sub_seed(seed, f"pose_batch{i}"))
        img1 = rng.uniform(-1, 1, (k, 3, s, s)).astype(np.float32)
        for _ in range(SMOOTH_PASSES):
            img1 = (img1 + np.roll(img1, 1, 2) + np.roll(img1, 1, 3)) / 3
        shift = rng.integers(-MAX_SHIFT, MAX_SHIFT + 1, (k, 2))
        img2 = np.stack([np.roll(img1[j], (shift[j, 1], shift[j, 0]),
                                 (1, 2)) for j in range(k)])
        kp1 = np.stack([inputs.face_landmarks(rng, s)[:cfg["joint_nc"]]
                        for _ in range(k)])
        kp2 = kp1 + shift[:, None, :]
        out.append({name: torch.as_tensor(
            np.ascontiguousarray(a, dtype=np.float32), device=device)
            for name, a in (("img_1", img1), ("img_2", img2),
                            ("kp_1", kp1), ("kp_2", kp2))})
    return out


class Adam:
    """torch.optim.Adam's update written out (eps outside the square
    root); ``weight_decay`` joins the gradient before the moments."""

    def __init__(self, params, lr: float, b1: float, b2: float,
                 weight_decay: float, eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.wd = weight_decay
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads) -> None:
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            if self.wd:
                g = g + self.wd * p
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (v.sqrt() / math.sqrt(bc2)).add_(self.eps)
            p.addcdiv_(m, denom, value=-self.lr / bc1)


class PoseStep:
    """The reference step over ``nets`` (``make_nets``' keys, weights
    loaded): ``grads(batch)`` -> (losses, G's gradients, D's gradients);
    ``step(batch)`` also leaves them in ``.grad`` and applies both Adams,
    as the port's ``PoseTransferTrainer.step``."""

    def __init__(self, cfg: dict, nets: dict):
        check_config(cfg)
        self.cfg = cfg
        self.g, self.d = nets["g"].train(), nets["d"]
        self.netf = nets["netf"].eval().requires_grad_(False)
        self.vgg = nets["vgg"].eval().requires_grad_(False)
        self.adam_g = Adam(self.g.parameters(), cfg["lr"], cfg["beta1"],
                           cfg["beta2"], cfg["weight_decay"])
        self.adam_d = Adam(self.d.parameters(), cfg["lr_D"], cfg["beta1"],
                           cfg["beta2"], cfg["weight_decay_D"])

    def grads(self, batch: dict):
        from portbench.reference.frozen.models import pose
        from portbench.reference.frozen.models.flowunet import (
            kp_to_map_binary)
        from portbench.reference.frozen.ops.warp import warp_acc_flow

        cfg = self.cfg
        size = (cfg["size"], cfg["size"])
        img_1, img_2 = batch["img_1"], batch["img_2"]
        j1 = kp_to_map_binary(size, batch["kp_1"])
        j2 = kp_to_map_binary(size, batch["kp_2"])
        with torch.no_grad():
            flow, vis_logits, _, _ = self.netf(torch.cat([j1, j2], 1))
            vis = torch.argmax(vis_logits, 1, keepdim=True).float()
            mask = (vis < 2).float()
            flow = flow * cfg["flow_scale"] * mask
            # the published forward's warped source (a visual; no loss
            # reads it)
            warp_acc_flow(img_1, flow, mask=mask)
        fake = torch.tanh(self.g(j2, img_1, flow, vis))
        m = {"loss_l1": torch.mean(torch.abs(fake - img_2)),
             "loss_content": pose.content_loss(self.vgg, fake, img_2)}
        self.d.eval()
        m["loss_G"] = pose.lsgan_loss(self.d(torch.cat([img_1, fake, j2],
                                                       1)), 1.0)
        m["loss"] = cfg["loss_weight_l1"] * m["loss_l1"] \
            + cfg["loss_weight_content"] * m["loss_content"] \
            + cfg["loss_weight_gan"] * m["loss_G"]
        g_grads = torch.autograd.grad(m["loss"], list(self.g.parameters()))
        d_fake = self.d(torch.cat([img_1, fake.detach(), j2], 1))
        self.d.train()
        d_real = self.d(torch.cat([img_1, img_2, j2], 1))
        m["loss_D"] = 0.5 * (pose.lsgan_loss(d_real, 1.0)
                             + pose.lsgan_loss(d_fake, 0.0))
        d_grads = torch.autograd.grad(m["loss_D"] * cfg["loss_weight_gan"],
                                      list(self.d.parameters()))
        return {k: v.detach() for k, v in m.items()}, g_grads, d_grads

    def step(self, batch: dict) -> dict:
        m, g_grads, d_grads = self.grads(batch)
        for net, grads in ((self.g, g_grads), (self.d, d_grads)):
            for p, g in zip(net.parameters(), grads):
                p.grad = g
        self.adam_g.step(g_grads)
        self.adam_d.step(d_grads)
        return m


def load(nets: dict, weights: dict) -> dict:
    for k, net in nets.items():
        net.load_state_dict(weights[k])
    return nets


def named_leaves(g, d) -> dict:
    return {**{f"g.{k}": p for k, p in g.named_parameters()},
            **{f"d.{k}": p for k, p in d.named_parameters()}}


def running_stats(g, d) -> dict:
    """Every BatchNorm statistic of G and D, by name, on the host."""
    return {f"{n}.{k}": b.detach().double().cpu()
            for n, net in (("g", g), ("d", d))
            for k, b in net.named_buffers()}


def run_steps(step, g, d, batches: list, n: int) -> dict:
    """``n`` steps of ``step`` (the port's trainer or ``PoseStep``) over
    ``batches``: each step's losses, the first step's gradient norm per
    leaf (from ``.grad``), each leaf's change, the running statistics."""
    start = {k: p.detach().clone() for k, p in named_leaves(g, d).items()}
    losses, grad1 = [], None
    for i in range(n):
        m = step.step(batches[i])
        losses.append({k: float(m[k]) for k in LOSSES})
        if i == 0:
            grad1 = {k: float(p.grad.norm())
                     for k, p in named_leaves(g, d).items()}
    change = {k: float((p.detach() - start[k]).norm())
              for k, p in named_leaves(g, d).items()}
    return {"losses": losses, "grad1": grad1, "change": change,
            "stats": running_stats(g, d)}


def reference_steps(cfg: dict, seed: int, batches: list, device,
                    n: int = 3) -> dict:
    """The reference's first ``n`` steps from the seed's weights, in fp32
    with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nets = load(make_nets(cfg, device), make_weights(cfg, seed, device))
    return run_steps(PoseStep(cfg, nets), nets["g"], nets["d"], batches, n)


def _stats_gaps(got: dict, ref: dict) -> list:
    """Each BatchNorm statistic's gap: the norm of the difference over
    max(its norm, the median statistic's norm); [inf] where the statistics
    or their update counts differ."""
    if set(got) != set(ref):
        return [float("inf")]
    floats = [k for k, v in ref.items() if v.is_floating_point()]
    if any(not torch.equal(got[k], ref[k]) for k in ref if k not in floats):
        return [float("inf")]
    scale = _median(float(ref[k].norm()) for k in floats)
    return [float((got[k] - ref[k]).norm())
            / max(float(ref[k].norm()), scale, 1e-30) for k in floats]


def compare(got: dict, ref: dict) -> dict:
    """The numbers: the worst step's worst loss gap (each loss over
    max(its value, the median loss)); the worst and the median leaf's
    first-gradient gap (each over max(its norm, the median leaf's)); the
    worst and the median leaf's change gap, leaves whose reference
    gradient is nought to rounding left out; the worst and the median
    BatchNorm statistic's gap after the steps."""
    if len(got["losses"]) != len(ref["losses"]):
        loss_gap = float("inf")
    else:
        loss_gap = max((_worst_gap(a, b, b) for a, b in
                        zip(got["losses"], ref["losses"])),
                       default=float("inf"))
    med = _median(ref["grad1"].values())
    stats = _stats_gaps(got["stats"], ref["stats"])
    moving = [k for k, v in ref["grad1"].items() if v >= NOUGHT_GRAD * med]
    return {"loss_gap": loss_gap,
            "grad1_gap": _worst_gap(got["grad1"], ref["grad1"],
                                    ref["grad1"]),
            "grad1_median_gap": _median_gap(got["grad1"], ref["grad1"],
                                            ref["grad1"]),
            "change3_gap": _worst_gap(got["change"], ref["change"], moving),
            "change3_median_gap": _median_gap(got["change"], ref["change"],
                                              moving),
            "stats_gap": max(stats, default=0.0),
            "stats_median_gap": _median(stats)}
