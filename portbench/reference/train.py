"""The ``module2_train`` configuration's weights, batches and plain
reference step, and the comparison that decides ``correct``.

The reference takes the first three steps of the frozen copy of the
Module2 step (``frozen/train/module2.py``: ``F.instance_norm`` and
autograd in place of the port's K2 and K2b) from the same weights, on the
same batches and pool draws, and is compared with what the port's own
first three steps left: each step's losses, the first gradient (as
Adam's first moment holds it after one step), each leaf's change over
the three steps, and the pool."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench import inputs

CONFIG_KEYS = ("crop_size", "output_nc", "ngf", "ndf", "n_layers_d",
               "netg_resb_div", "netg_resb_disp", "lr", "beta1", "pool_size",
               "gan_mode", "batch_d_passes", "face_recog_model")
# a leaf whose reference gradient is under this share of the median
# leaf's moves under Adam by rounding alone (a bias under InstanceNorm):
# it is left out of the change's comparison
NOUGHT_GRAD = 1e-3


def module2_config(m2, cfg: dict):
    """``Module2Config`` of the module ``m2`` (the port's or the frozen
    copy) for the configuration file ``cfg``."""
    return m2.Module2Config(**{k: cfg[k] for k in CONFIG_KEYS})


def make_weights(cfg: dict, seed: int, device) -> dict:
    """State dicts of G, the Ds and the four frozen nets, on ``device``:
    G and the Ds as ``init_weights("normal", 0.02)`` fills them, the
    frozen nets as ``init_frozen_random`` does (LeCun normal)."""
    from portbench.reference.frozen.train import module2 as m2

    c = module2_config(m2, cfg)
    ctors = {
        "g": (lambda: m2.TridentGeneratorFullIFW(
            output_nc=c.output_nc, ngf=c.ngf, div=c.netg_resb_div,
            disp=c.netg_resb_disp), "gan_normal"),
        "d": (lambda: torch.nn.ModuleDict({
            k: m2.NLayerDiscriminator(n, c.ndf, c.n_layers_d)
            for k, n in m2.d_input_channels(c).items()}), "gan_normal"),
        "modnet": (m2.MODNet, "lecun"),
        "mobilefacenet": (m2.MobileFaceNet, "lecun"),
        "sphere": (m2.Sphere20a, "lecun"),
        "flowunet": (m2.FlowUnet, "lecun"),
    }
    return {k: inputs.build(ctor, inputs.sub_seed(seed, k), rule,
                            device).state_dict()
            for k, (ctor, rule) in ctors.items()}


def make_batches(cfg: dict, seed: int, n: int, device) -> list[dict]:
    """``n`` resident batches, every image, mask and grid uniform in
    [-1, 1] (``make_random_batch`` of the frozen copy), each from its own
    seed."""
    from portbench.reference.frozen.train import module2 as m2

    c = module2_config(m2, cfg)
    return [m2.make_random_batch(
        c, cfg["batch_size"], torch.Generator(device=device).manual_seed(
            inputs.sub_seed(seed, f"batch{i}")), device) for i in range(n)]


def pool_generator(seed: int) -> torch.Generator:
    """The pool queries' draws (a host generator, as ``train_cli``'s)."""
    return torch.Generator().manual_seed(inputs.sub_seed(seed, "pool"))


def build(m2, cfg: dict, weights: dict, device):
    """(step, TrainState, FrozenNets) of the module ``m2`` on the weights,
    as ``init_state`` and ``init_frozen_random`` assemble them."""
    c = module2_config(m2, cfg)
    with torch.device(device):
        g = m2.TridentGeneratorFullIFW(output_nc=c.output_nc, ngf=c.ngf,
                                       div=c.netg_resb_div,
                                       disp=c.netg_resb_disp)
        d = torch.nn.ModuleDict({
            k: m2.NLayerDiscriminator(n, c.ndf, c.n_layers_d)
            for k, n in m2.d_input_channels(c).items()})
        frozen = m2.FrozenNets(m2.MODNet(), m2.MobileFaceNet(),
                               m2.Sphere20a(), m2.FlowUnet())
    g.load_state_dict(weights["g"])
    d.load_state_dict(weights["d"])
    for f in dataclasses.fields(m2.FrozenNets):
        net = getattr(frozen, f.name)
        net.load_state_dict(weights[f.name])
        net.eval().requires_grad_(False)
    g, d = g.train(), d.train()
    h = c.crop_size
    state = m2.TrainState(
        step=0, g=g, d=d, g_opt=m2.make_optimizer(c, g.parameters()),
        d_opt=m2.make_optimizer(c, d.parameters()),
        pool=torch.zeros((c.pool_size, c.output_nc, h, h), device=device),
        pool_count=0, compute_dtype=c.compute_dtype)
    return m2.build_train_step(c), state, frozen


def named_leaves(state) -> dict:
    return {**{f"g.{k}": p for k, p in state.g.named_parameters()},
            **{f"d.{k}": p for k, p in state.d.named_parameters()}}


def first_grad_norms(state, beta1: float) -> dict:
    """Each leaf's first gradient, as Adam's first moment holds it after
    one step (m = (1 - beta1) g): its norm; 0 where Adam holds no
    moment (it has not stepped)."""
    out = {}
    for key, opt, net in (("g", state.g_opt, state.g),
                          ("d", state.d_opt, state.d)):
        for name, p in net.named_parameters():
            m = opt.state.get(p, {}).get("exp_avg")
            out[f"{key}.{name}"] = (0.0 if m is None else
                                    float(m.norm()) / (1.0 - beta1))
    return out


def _median(values) -> float:
    return float(np.median(np.asarray(list(values), np.float64)))


def _worst_gap(got: dict, ref: dict, keys) -> float:
    """The largest |got - ref| over max(|ref|, the median |ref|)."""
    keys = list(keys)
    if set(got) != set(ref):
        return float("inf")
    scale = _median(abs(ref[k]) for k in keys)
    return max((abs(got[k] - ref[k]) / max(abs(ref[k]), scale, 1e-30)
                for k in keys), default=0.0)


def _median_gap(got: dict, ref: dict, keys) -> float:
    """The median over ``keys`` of |got - ref| over max(|ref|, the median
    |ref|): the typical leaf, which a few flipped pixels upstream move
    less than the worst one."""
    keys = list(keys)
    if set(got) != set(ref) or not keys:
        return float("inf")
    scale = _median(abs(ref[k]) for k in keys)
    return _median(abs(got[k] - ref[k]) / max(abs(ref[k]), scale, 1e-30)
                   for k in keys)


def reference_steps(cfg: dict, seed: int, batches: list, device,
                    n: int = 3) -> dict:
    """The frozen step's first ``n`` steps: losses, first gradient norms,
    the change of each leaf, the pool."""
    from portbench.reference.frozen.train import module2 as m2

    weights = make_weights(cfg, seed, device)
    step, state, frozen = build(m2, cfg, weights, device)
    gen = pool_generator(seed)
    start = {k: p.detach().clone() for k, p in named_leaves(state).items()}
    losses, grad1, pool1 = [], None, None
    for i in range(n):
        grads = step.grads(state, batches[i], frozen, gen)
        if i == 0:
            grad1 = {**{f"g.{k}": float(v.norm()) for k, v in
                        grads.g.items()},
                     **{f"d.{k}": float(v.norm()) for k, v in
                        grads.d.items()}}
        losses.append({k: float(v) for k, v in grads.metrics.items()})
        step.apply_grads(state, grads)
        if i == 0:
            pool1 = state.pool[:state.pool_count].clone()
    change = {k: float((p.detach() - start[k]).norm())
              for k, p in named_leaves(state).items()}
    return {"losses": losses, "grad1": grad1, "change": change,
            "pool1": pool1, "pool": state.pool.clone(),
            "pool_count": state.pool_count}


def _pool_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest gap over the largest value; inf where the pools hold
    different counts."""
    if a.shape != b.shape:
        return float("inf")
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def compare(got: dict, ref: dict) -> dict:
    """The numbers: the worst step's worst loss gap, the worst leaf's
    first-gradient gap, the worst leaf's change gap (leaves whose
    reference gradient is nought to rounding left out), and the pool's
    largest gap over its largest value, after the first step
    (``pool1_gap``) and after the three (``pool_gap``, which the noise
    of Adam's first updates reaches)."""
    loss_gap = max((_worst_gap(a, b, b) for a, b in
                    zip(got["losses"], ref["losses"])), default=float("inf"))
    if len(got["losses"]) != len(ref["losses"]):
        loss_gap = float("inf")
    med = _median(ref["grad1"].values())
    moving = [k for k, v in ref["grad1"].items() if v >= NOUGHT_GRAD * med]
    grad_gap = _worst_gap(got["grad1"], ref["grad1"], ref["grad1"])
    change_gap = _worst_gap(got["change"], ref["change"], moving)
    n = ref["pool_count"]
    pool_gap = (_pool_gap(got["pool"][:n], ref["pool"][:n])
                if got["pool_count"] == n else float("inf"))
    return {"loss_gap": loss_gap, "grad1_gap": grad_gap,
            "change3_gap": change_gap,
            "loss1_gap": _worst_gap(got["losses"][0], ref["losses"][0],
                                    ref["losses"][0]),
            "grad1_median_gap": _median_gap(got["grad1"], ref["grad1"],
                                            ref["grad1"]),
            "change3_median_gap": _median_gap(got["change"], ref["change"],
                                              moving),
            "pool1_gap": _pool_gap(got["pool1"], ref["pool1"]),
            "pool_gap": pool_gap}
