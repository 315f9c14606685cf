"""The flow-regression trainer of the PyTorch port against the JAX
package: its losses (the JAX package's torch-oracle bars, rtol 1e-4),
FlowUnet and FlowUnet_v2 in training and eval mode (flax's BatchNorm
statistics), one trainer step (loss terms, gradients, parameters and
BatchNorm statistics after it) and FlowUnet_v2's weights' round trip.
Bounds are stated per test."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from animateportrait_tpu_torch.io import from_jax
from animateportrait_tpu_torch.models.flowunet import FlowUnet
from animateportrait_tpu_torch.models.flowunet_extra import FlowUnetV2
from animateportrait_tpu_torch.train import flow_regression as tfr
from test_torch_module1 import _check_step, f64_grads
from torch_port_helpers import (
    adam_grads, maxdiff, nchw, port_stats_match, random_jax_variables)

K = jax.random.key(0)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_flow_losses_match_jax():
    """multi_scale_flow_loss (L1 and L2), EPE, ss_flow_loss and the
    visibility cross-entropy inputs: rtol 1e-4 (tests/test_flow_regression
    .py's bar)."""
    from animateportrait_tpu.train import flow_regression as jfr
    rng = np.random.default_rng(0)
    n, h = 2, 32
    target = rng.standard_normal((n, h, h, 2)).astype(np.float32)
    mask = (rng.random((n, h, h, 1)) > 0.3).astype(np.float32)
    pyr = [rng.standard_normal((n, h // (2 * 2 ** s), h // (2 * 2 ** s), 2))
           .astype(np.float32) for s in range(3)]
    for lt in ("l1", "l2"):
        ref = jfr.multi_scale_flow_loss([jnp.asarray(p) for p in pyr],
                                        jnp.asarray(target),
                                        jnp.asarray(mask), loss_type=lt)
        got = tfr.multi_scale_flow_loss([nchw(p) for p in pyr], nchw(target),
                                        nchw(mask), loss_type=lt)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(float(g), float(r), rtol=1e-4)
    flow = rng.uniform(-6, 6, (n, h, h, 2)).astype(np.float32)
    seg1 = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (n, h, h))]
    seg2 = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (n, h, h))]
    vis = rng.integers(0, 3, (n, h, h)).astype(np.int32)
    for lt in ("l1", "l2"):
        ref = jfr.ss_flow_loss(jnp.asarray(flow), jnp.asarray(target),
                               jnp.asarray(seg1), jnp.asarray(seg2),
                               jnp.asarray(vis), loss_type=lt)
        got = tfr.ss_flow_loss(nchw(flow), nchw(target), nchw(seg1),
                               nchw(seg2), _t(vis), loss_type=lt)
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-4)


def _flowunet_vars(num_scale, input_nc, size):
    from animateportrait_tpu.models.flowunet import FlowUnet as J
    return random_jax_variables(lambda: J(num_scale=num_scale).init(
        K, jnp.zeros((1, size, size, input_nc))), seed=2)


@pytest.mark.parametrize("train", [False, True])
def test_flowunet_matches_jax_in_both_modes(train):
    """FlowUnet (3 scales, 8 input channels, 32^2, batch 2): every output
    within 1e-4; in training mode the statistics it leaves within 1e-4 of
    their scale."""
    from animateportrait_tpu.models.flowunet import FlowUnet as J
    v = _flowunet_vars(3, 8, 32)
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 8)).astype(
        np.float32)
    net = FlowUnet(input_nc=8, num_scale=3)
    net.load_state_dict(from_jax.flowunet_state_dict(v, num_scale=3))
    if train:
        ref, upd = J(num_scale=3).apply(v, jnp.asarray(x), train=True,
                                        mutable=["batch_stats"])
        net.train()
    else:
        ref = J(num_scale=3).apply(v, jnp.asarray(x))
    got = net(nchw(x))
    for g, r in zip(got[:2] + (got[3],), ref[:2] + (ref[3],)):
        assert maxdiff(g.detach().permute(0, 2, 3, 1), r) <= 1e-4
    for g, r in zip(got[2], ref[2]):
        assert maxdiff(g.detach().permute(0, 2, 3, 1), r) <= 1e-4
    if train:
        port_stats_match(net, from_jax.flowunet_state_dict(
            {"params": v["params"], "batch_stats": upd["batch_stats"]},
            num_scale=3))


def _flow_batch():
    rng = np.random.default_rng(3)
    theta = np.linspace(0, 2 * np.pi, 68, endpoint=False)
    kp = np.stack([112 + 50 * np.cos(theta), 112 + 50 * np.sin(theta)],
                  -1).astype(np.float32)[None]
    kp1 = np.concatenate([kp, kp + 3.0])
    kp2 = kp1 + rng.uniform(-4, 4, (2, 68, 2)).astype(np.float32)
    flow_gt = rng.standard_normal((2, 224, 224, 2)).astype(np.float32)
    vis_gt = rng.integers(0, 3, (2, 224, 224)).astype(np.int32)
    return kp1, kp2, flow_gt, vis_gt


def test_flow_step_matches_jax():
    """One step at num_scale 3 on 224^2 keypoint maps, batch 2: the loss
    terms within rtol 1e-4 and _check_step's bars. XLA's CPU conv
    gradients here (sums over 224^2 pixels of a BatchNorm-centred
    gradient) are up to ~7e-3 of their scale from float64, the port's
    ~4e-6, so those leaves are held to the float64 run."""
    from animateportrait_tpu.train.flow_regression import (
        FlowRegConfig, FlowRegTrainState, build_flow_train_step)
    cfg = FlowRegConfig(num_scale=3, lr=2e-4)
    v = _flowunet_vars(3, 136, 224)
    state = FlowRegTrainState(
        step=jnp.zeros((), jnp.int32), variables=v,
        opt=optax.adam(cfg.lr, b1=cfg.beta1).init(v["params"]))
    kp1, kp2, flow_gt, vis_gt = _flow_batch()
    s1, m = jax.jit(build_flow_train_step(cfg))(
        state, *(jnp.asarray(a) for a in (kp1, kp2, flow_gt, vis_gt)))
    net = FlowUnet(num_scale=3)
    net.load_state_dict(from_jax.flowunet_state_dict(v, num_scale=3))
    tcfg = tfr.FlowRegConfig(num_scale=3, lr=2e-4)
    batch = (_t(kp1), _t(kp2), nchw(flow_gt), _t(vis_gt).long())
    g64 = f64_grads(tfr.FlowRegTrainer, tcfg, net, *batch)
    tr = tfr.FlowRegTrainer(tcfg, net, device="cpu")
    got = tr.step(*batch)
    for k in ("flow", "vis", "epe"):
        np.testing.assert_allclose(float(got[k]), float(m[k]), rtol=1e-4)

    def sd_of(tree):
        return from_jax.flowunet_state_dict(tree, num_scale=3)
    _check_step(net, sd_of, s1.variables["params"],
                s1.variables["batch_stats"], adam_grads(s1.opt), m["loss"],
                got["loss"], cfg.lr, grads_f64=g64)


@pytest.mark.parametrize("train", [False, True])
def test_flowunet_v2_matches_jax_and_round_trips(train):
    """FlowUnet_v2 (nf 8, max 16, 3 scales, 6 input channels, 32^2, batch
    2): outputs within 1e-4; the state dict fills every key of the port's
    module; the statistics within 1e-4 of their scale in training mode."""
    from animateportrait_tpu.models.flowunet_extra import FlowUnetV2 as J
    kw = dict(nf=8, max_nf=16, num_scales=3)
    v = random_jax_variables(lambda: J(**kw).init(
        K, jnp.zeros((1, 32, 32, 6))), seed=4)
    sd = from_jax.flowunet_v2_state_dict(v, num_scales=3)
    net = FlowUnetV2(6, **kw)
    assert set(sd) == set(net.state_dict())
    net.load_state_dict(sd)
    x = np.random.default_rng(5).standard_normal((2, 32, 32, 6)).astype(
        np.float32)
    if train:
        ref, upd = J(**kw).apply(v, jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
    else:
        ref = J(**kw).apply(v, jnp.asarray(x))
    got = net.train(train)(nchw(x))
    for g, r in zip(got[:2] + (got[3],), ref[:2] + (ref[3],)):
        assert maxdiff(g.detach().permute(0, 2, 3, 1), r) <= 1e-4
    for g, r in zip(got[2], ref[2]):
        assert maxdiff(g.detach().permute(0, 2, 3, 1), r) <= 1e-4
    if train:
        port_stats_match(net, from_jax.flowunet_v2_state_dict(
            {"params": v["params"], "batch_stats": upd["batch_stats"]},
            num_scales=3))


def test_convergence_runner_matches_the_jax_tool(monkeypatch):
    """train/convergence.py's flow run at 3 steps from the JAX tool's
    initial weights: the first EPE within rtol 1e-4, the last within
    rtol 1e-2 (as the content run's test states)."""
    from animateportrait_tpu_torch.train import convergence
    from torch_port_helpers import jax_tool_run
    (f, l), weights, _ = jax_tool_run("flow", 3, monkeypatch)
    got = convergence.run_flow(3, "cpu", weights)
    np.testing.assert_allclose(got[0], f, rtol=1e-4)
    np.testing.assert_allclose(got[1], l, rtol=1e-2)
