"""The port's AdaptiveWingLoss FAN and its trainer (``models/fan.py``,
``train/fan.py``) against the JAX package on the same weights (JAX random
variables carried over by ``io/from_jax.py``) and inputs, at the JAX width
(256 channels) narrowed by depth (1-2 stacks) and size (64^2):

- the forward in eval mode within 1e-4 of each output's scale; in
  training mode (batch statistics) within 1e-4, or no farther from a
  float64 run than 3x JAX;
- one ``FANTrainer`` step against ``build_fan_train_step``: the loss within
  rtol 1e-4, every gradient leaf by ``grad_parity`` with the port's
  float64 step, the running statistics within 1e-4 of their scale;
- the coordinate channels, heatmap decoding, gaussian targets, the
  boundary and weight maps (exact, or float32 rounding where both compute
  in fp32), the Adaptive Wing loss and its gradient at delta 0 and at
  theta against ``jax.grad``, ``fan_nme`` for 68/98/29/19 points,
  ``evaluate_fan``, and the convergence runner's ``fan`` row at 3 steps
  against the JAX tool's (rtol 1e-2)."""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from animateportrait_tpu.models import fan as jfan
from animateportrait_tpu.train import fan as jtrain
from animateportrait_tpu_torch.io import from_jax
from animateportrait_tpu_torch.models import fan as tfan
from animateportrait_tpu_torch.train import fan as ttrain
from animateportrait_tpu_torch.utils.smoke import cancelled_biases, grad_parity
from torch_port_helpers import (
    adam_grads, assert_as_exact_as_jax, maxdiff, nchw, nhwc,
    port_stats_match, random_jax_variables)

K = jax.random.key(0)


def _nets(num_modules=2, num_landmarks=68, size=64, seed=0):
    jm = jfan.FAN(num_modules=num_modules, num_landmarks=num_landmarks)
    v = random_jax_variables(lambda: jm.init(K, jnp.zeros((1, size, size,
                                                            3))), seed=seed)
    tm = tfan.FAN(num_modules, num_landmarks)
    tm.load_state_dict(from_jax.fan_state_dict(v, num_modules), strict=True)
    return jm, v, tm


def _images(n=2, size=64, seed=1):
    return np.random.default_rng(seed).uniform(0, 1, (n, size, size, 3)) \
        .astype(np.float32)


def test_fan_forward_matches_jax_eval_and_train():
    """At 128^2 (the innermost hourglass level 2x2: 8 values a channel for
    BatchNorm at batch 2; at 64^2 it is 1x1, where fp32 rounding alone
    moves either package's outputs by up to 1e-3 of their scale)."""
    jm, v, tm = _nets(size=128)
    x = _images(size=128)
    outs, bounds = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got, got_b = tm.eval()(nchw(x))
    for g, r in zip(got, outs):
        assert maxdiff(nhwc(g), r) <= 1e-4 * float(np.abs(r).max())
    for g, r in zip(got_b, bounds):      # coordinates in [-1, 1]
        assert maxdiff(nhwc(g), r) <= 1e-6
    (outs, _), mut = jm.apply(v, jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
    tm64 = copy.deepcopy(tm).double().train()
    with torch.no_grad():
        got, _ = tm.train()(nchw(x))
        f64, _ = tm64(nchw(x).double())
    for g, r, d in zip(got, outs, f64):
        assert_as_exact_as_jax(nhwc(g), r, nhwc(d),
                               1e-4 * float(np.abs(r).max()))
    port_stats_match(tm, from_jax.fan_state_dict(
        {"params": v["params"], **mut}, 2))


def test_add_coords_and_boundary_channels():
    """xx varies along H, yy along W, rr over its maximum; the boundary
    channels where the clipped last heatmap channel exceeds 0.05."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 6, 3)).astype(np.float32)
    hm = rng.uniform(-0.5, 1.5, (2, 8, 6, 5)).astype(np.float32)
    ref = jfan._add_coords(jnp.asarray(x), True, jnp.asarray(hm), True)
    got = tfan.add_coords(nchw(x), True, nchw(hm), True)
    assert maxdiff(nhwc(got), ref) <= 1e-6
    assert got.shape[1] == 3 + 5


def test_fan_train_step_matches_jax():
    """One step at 1 stack, 68 points, 256^2 and batch 4 (the net's input
    size and the trainer's batch), on targets from ``make_fan_targets``.
    The innermost hourglass level is then 4x4, 64 values a channel for
    its BatchNorms: at 128^2 and batch 2 (8 values) the gradients of both
    packages scatter by up to 7% of a leaf's scale around the float64
    step's, seed by seed, and the per-leaf rule is a coin flip."""
    cfg = ttrain.FANTrainConfig(num_modules=1, num_landmarks=68, lr=1e-4)
    jcfg = jtrain.FANTrainConfig(num_modules=1, num_landmarks=68, lr=1e-4)
    jm, v, tm = _nets(num_modules=1, size=256, seed=3)
    x = _images(n=4, size=256, seed=4)
    lms = np.random.default_rng(5).uniform(40, 216, (4, 68, 2))
    tg = [ttrain.make_fan_targets(lm, hm_size=64) for lm in lms]
    gt, w = (np.stack([t[j] for t in tg]) for j in (0, 1))
    tx = optax.adam(jcfg.lr)
    state = jtrain.FANTrainState(step=jnp.zeros((), jnp.int32), variables=v,
                                 opt=tx.init(v["params"]))
    step = jtrain.build_fan_train_step(jcfg, tx)
    nhwc_t = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))  # noqa: E731
    state, jloss = step(state, jnp.asarray(x), nhwc_t(gt), nhwc_t(w))
    tr = ttrain.FANTrainer(cfg, tm, device="cpu")
    m = tr.step(nchw(x), torch.from_numpy(gt), torch.from_numpy(w))
    assert abs(float(m["loss"]) - float(jloss)) <= 1e-4 * abs(float(jloss))
    tr64 = ttrain.FANTrainer(cfg, _nets(1, size=256, seed=3)[2].double(),
                             device="cpu")
    tr64.step(nchw(x).double(), torch.from_numpy(gt).double(),
              torch.from_numpy(w).double())
    jg = adam_grads(state.opt)
    ref = from_jax.fan_state_dict({"params": jg,
                                   "batch_stats": v["batch_stats"]}, 1)
    got = {k: p.grad for k, p in tr.model.named_parameters()}
    ref64 = {k: p.grad for k, p in tr64.model.named_parameters()}
    errs = grad_parity(got, ref, ref64, cancelled_biases(tr.model))
    assert max(errs.values()) <= 1e-3, max(errs, key=errs.get)
    port_stats_match(tr.model, from_jax.fan_state_dict(
        jax.tree_util.tree_map(np.asarray, state.variables), 1))


def test_heatmap_decoding_and_nme_match_jax():
    rng = np.random.default_rng(6)
    for c, n_lm in ((68, 68), (98, 98), (29, 29), (21, 19)):
        hm = rng.standard_normal((3, 16, 16, c)).astype(np.float32)
        # peaks on the border too
        hm[0, 0, 3, :] += 10.0
        ref = np.asarray(jfan.heatmaps_to_landmarks(jnp.asarray(hm)))
        got = tfan.heatmaps_to_landmarks(nchw(hm)).numpy()
        assert np.array_equal(got, ref)
        gt = rng.uniform(0, 64, (3, c, 2)).astype(np.float32)
        want = float(jfan.fan_nme(jnp.asarray(hm), jnp.asarray(gt), n_lm))
        have = float(tfan.fan_nme(nchw(hm), torch.from_numpy(gt), n_lm))
        assert abs(have - want) <= 1e-5 * abs(want)
    with pytest.raises(ValueError):
        tfan.fan_nme(nchw(hm), torch.from_numpy(gt), 5)


def test_gaussian_targets_boundary_and_weight_maps_match_jax():
    """draw_gaussian at interior and edge points, the stack with its
    boundary channel (fp32 in both: within 1e-6), the AddBoundary map and
    the weight maps (host numpy: exact)."""
    pts = np.array([[10.3, 20.7], [0.2, 5.0], [63.9, 62.1], [-2.0, 3.0],
                    [70.0, 10.0]], np.float32)
    ref = np.asarray(jfan.gaussian_heatmaps(jnp.asarray(pts), (64, 64), 1,
                                            boundary=True))
    got = tfan.gaussian_heatmaps(torch.from_numpy(pts), (64, 64), 1,
                                 boundary=True).numpy()
    assert maxdiff(got.transpose(1, 2, 0), ref) <= 1e-6
    for n in (68, 98):
        lm = np.random.default_rng(n).uniform(30, 226, (n, 2))
        assert np.array_equal(ttrain.boundary_heatmap(lm),
                              jtrain.boundary_heatmap(lm))
        ref_hm, ref_w = jtrain.make_fan_targets(lm)
        hm, w = ttrain.make_fan_targets(lm)
        assert maxdiff(hm.transpose(1, 2, 0), ref_hm) <= 1e-6
        assert np.array_equal(w, ttrain.weight_map(hm))
        assert maxdiff(w.transpose(1, 2, 0), ref_w) == 0.0


def test_adaptive_wing_value_and_gradient_at_its_edges():
    """The map and its gradient against ``jax.grad``, with predictions at
    delta == 0 (the pow's base 0: gradient 0, not NaN) and delta ==
    theta (the branch switch), rtol 1e-5."""
    rng = np.random.default_rng(7)
    target = rng.uniform(0, 1, (4, 6)).astype(np.float32)
    pred = target + rng.uniform(-1, 1, target.shape).astype(np.float32)
    pred[0] = target[0]                    # delta 0
    pred[1] = target[1] + np.float32(0.5)  # delta theta (up to rounding)
    pred[2] = target[2] - np.float32(0.5)
    d = np.abs(target - pred)
    pred[1:3] = np.where(d[1:3] == 0.5, pred[1:3], target[1:3] + 0.5)

    def jmap(p):
        return jnp.sum(jfan.adaptive_wing_map(p, jnp.asarray(target)))

    ref = np.asarray(jfan.adaptive_wing_map(jnp.asarray(pred),
                                            jnp.asarray(target)))
    jg = np.asarray(jax.grad(jmap)(jnp.asarray(pred)))
    p = torch.from_numpy(pred).requires_grad_()
    out = tfan.adaptive_wing_map(p, torch.from_numpy(target))
    out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5,
                               atol=1e-6)
    assert torch.isfinite(p.grad).all()
    assert (p.grad[0] == 0).all()
    np.testing.assert_allclose(p.grad.numpy(), jg, rtol=1e-5, atol=1e-6)
    assert abs(float(tfan.adaptive_wing_loss(p, torch.from_numpy(target)))
               - float(jfan.adaptive_wing_loss(jnp.asarray(pred),
                                               jnp.asarray(target)))) \
        <= 1e-5 * float(np.abs(ref).mean())


def test_evaluate_fan_matches_jax():
    jm, v, tm = _nets(num_modules=1, seed=8)
    x = _images(n=3, seed=9)
    gt = np.random.default_rng(10).uniform(10, 54, (3, 68, 2))
    cfg = ttrain.FANTrainConfig(num_modules=1, num_landmarks=68)
    want = jtrain.evaluate_fan(v, x, gt, jtrain.FANTrainConfig(
        num_modules=1, num_landmarks=68), batch_size=2)
    tm.train()
    have = ttrain.evaluate_fan(tm, x, gt, cfg, batch_size=2)
    assert tm.training
    assert abs(have - want) <= 1e-5 * abs(want)


def test_convergence_runner_fan_matches_the_jax_tool(monkeypatch):
    """train/convergence.py's FAN run at 3 steps from the JAX tool's
    initial weights: the first NME within rtol 1e-4; the last, of the
    float64 run, within rtol 1e-2 (the tool's 64^2 puts BatchNorm on 1x1
    maps of 4 samples: the fp32 runs of both packages scatter by percent
    around the exact one, and the port's is measured here and printed)."""
    from animateportrait_tpu_torch.train import convergence
    from torch_port_helpers import jax_tool_run
    (f, l), weights, _ = jax_tool_run("fan", 3, monkeypatch)
    got = convergence.run_fan(3, "cpu", weights)
    np.testing.assert_allclose(got[0], f, rtol=1e-4)
    exact = convergence.run_fan(3, "cpu", weights, dtype=torch.float64)
    np.testing.assert_allclose(exact[0], f, rtol=1e-4)
    np.testing.assert_allclose(exact[1], l, rtol=1e-2)
    print(f"fan row: JAX {f:.6f} -> {l:.6f}; port fp32 {got[0]:.6f} -> "
          f"{got[1]:.6f}; port float64 -> {exact[1]:.6f}")
