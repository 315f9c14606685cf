"""The port's Module2 training step against the JAX package's, on the CPU at
the JAX tests' small configuration (crop 64, ngf = ndf = 8, pool 4,
batch 1): the same weights (the port's seeded init, carried into the JAX
package by its own checkpoint loaders), the same batch and the same pool
draws; one JAX ``grads_fn`` call and one jitted Adam update, shared by the
tests through a module fixture.

- every loss of the metrics dict within rtol 1e-4 / atol 1e-5;
- every gradient leaf within 1e-3 of that leaf's largest |g|, except up
  to two leaves upstream of a fused ReLU whose input sits on its kink
  (within 5e-2; see ``KINK_LEAVES``);
- the pool after step 1: it only fills, so it holds exactly the step's
  two fakes in slots 0 and 1 (the JAX pool's at the fakes' tolerance) and
  zeros in the rest, and both counts are 2;
- the Adam-updated parameters: every update within 1.5 lr, and equal to
  the JAX update on the decisive elements (|g| > 5e-2 of the largest |g|
  of the tree), as ``tests/test_train_module2.py`` holds two device
  layouts.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from animateportrait_tpu_torch.io import from_jax
from animateportrait_tpu_torch.train import module2 as m2
from torch_port_helpers import in_cancelled_biases, nchw, nhwc

LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
LEAF_RTOL = 1e-3        # of each gradient leaf's largest |g|
# a conv bias under an InstanceNorm has a zero gradient (the norm removes
# any constant), so both sides hold rounding noise there: held to this
# fraction of the tree's largest |g| instead
ZERO_LEAF_ATOL = 1e-5
# An element within ~1e-6 of a fused ReLU's kink may sit on either side in
# the two forwards: its gradient then passes in one and not in the other,
# and the leaves upstream of it move. In this batch one element of the
# generator's tri02 InstanceNorm+ReLU has |xhat| = 9e-7 (the forwards
# agree to ~1e-6 there): tri01's and tri00's convs move by 1.8% and 0.7%.
# Up to this many leaves of a tree may exceed LEAF_RTOL, within KINK_RTOL.
KINK_LEAVES = 2
KINK_RTOL = 5e-2


def _small_cfg():
    return m2.Module2Config(crop_size=64, output_nc=1, ngf=8, ndf=8,
                            steps_per_epoch=2, pool_size=4,
                            lambda_geom_lipline=50.0)


def _jax_cfg(cfg):
    from animateportrait_tpu.train import module2 as j2

    return j2.Module2Config(**dataclasses.asdict(cfg))


def _numpy_sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _jax_side(cfg, state, frozen):
    """The port's weights as the JAX package's TrainState and FrozenNets,
    through its own loaders."""
    from animateportrait_tpu.models.flowunet import load_flowunet_params
    from animateportrait_tpu.models.gan import (
        load_nlayer_d_params, load_trident_full_ifw_params)
    from animateportrait_tpu.models.modnet import load_modnet_params
    from animateportrait_tpu.models.perception import (
        load_mobilefacenet_params, load_sphere20a_params)
    from animateportrait_tpu.train import module2 as j2

    g_params = load_trident_full_ifw_params(
        _numpy_sd(state.g), div=cfg.netg_resb_div,
        disp=cfg.netg_resb_disp)["params"]
    d_params = {name: load_nlayer_d_params(_numpy_sd(d),
                                           cfg.n_layers_d)["params"]
                for name, d in state.d.items()}
    g_tx, d_tx = j2.make_optimizer(_jax_cfg(cfg)), j2.make_optimizer(
        _jax_cfg(cfg))
    h = cfg.crop_size
    jstate = j2.TrainState(
        step=jnp.zeros((), jnp.int32), g_params=g_params, d_params=d_params,
        g_opt=g_tx.init(g_params), d_opt=d_tx.init(d_params),
        pool=jnp.zeros((cfg.pool_size, h, h, cfg.output_nc), jnp.float32),
        pool_count=jnp.zeros((), jnp.int32))
    jfrozen = j2.FrozenNets(
        modnet=load_modnet_params(_numpy_sd(frozen.modnet)),
        mobilefacenet=load_mobilefacenet_params(
            _numpy_sd(frozen.mobilefacenet)),
        sphere=load_sphere20a_params(_numpy_sd(frozen.sphere)),
        flowunet=load_flowunet_params(_numpy_sd(frozen.flowunet)))
    return jstate, jfrozen, g_tx


def _batches(cfg, batch_size=1):
    """The JAX tests' batch (zeros, then every 4-D float entry uniform in
    [-1, 1] from a seeded numpy generator), NHWC for JAX and NCHW for the
    port."""
    from animateportrait_tpu.train import module2 as j2

    jb = j2.make_example_batch(_jax_cfg(cfg), batch_size=batch_size)
    rng = np.random.default_rng(0)
    for k, v in jb.items():
        if v.dtype == jnp.float32 and v.ndim == 4:
            jb[k] = jnp.asarray(rng.uniform(-1, 1, v.shape).astype(
                np.float32))
    tb = m2.make_example_batch(cfg, batch_size=batch_size, device="cpu")
    assert set(tb) == set(jb)
    for k, v in jb.items():
        a = np.asarray(v)
        if a.ndim == 4 and k not in m2.GRID_KEYS:
            tb[k] = nchw(a)
        else:
            assert tuple(tb[k].shape) == a.shape, k
            tb[k] = torch.as_tensor(a).to(tb[k].dtype)
    return jb, tb


@pytest.fixture(scope="module")
def step_pair():
    cfg = _small_cfg()
    gen = torch.Generator().manual_seed(0)
    state = m2.init_state(cfg, gen, "cpu")
    frozen = m2.init_frozen_random(gen, "cpu")
    jstate, jfrozen, g_tx = _jax_side(cfg, state, frozen)
    jb, tb = _batches(cfg)

    from animateportrait_tpu.train import module2 as j2
    import optax

    # the JAX package's InstanceNorm statistics by default are the
    # unshifted E[x^2] - E[x]^2, which cancels on the stems' mostly white
    # (masked) planes, |mean|/std ~7 here: the JAX gradients then move by
    # up to ~5% of a leaf's scale. Its two-pass statistics, read when the
    # step is traced, are what the port's shifted sums compute.
    os.environ["AP_IN_STATS"] = "twopass"
    try:
        jstep = j2.build_train_step(_jax_cfg(cfg))
        gg, dg, pool, count, metrics = jax.jit(jstep.grads_fn)(
            jstate, jb, jfrozen, jax.random.key(1))
    finally:
        del os.environ["AP_IN_STATS"]

    @jax.jit
    def adam(grads, opt, params):
        upd, _ = g_tx.update(grads, opt, params)
        return optax.apply_updates(params, upd)

    jnew_g = adam(gg, jstate.g_opt, jstate.g_params)
    jnew_d = adam(dg, jstate.d_opt, jstate.d_params)

    tstep = m2.build_train_step(cfg)
    grads = tstep.grads(state, tb, frozen, torch.Generator().manual_seed(1))
    with torch.no_grad():
        fakes = tstep.g_forward(state.g, tb, tstep.forward_shared(tb, frozen))
    old = {k: v.detach().clone() for k, v in
           list(state.g.state_dict().items())
           + [(f"d.{k}", v) for k, v in state.d.state_dict().items()]}
    tmetrics = tstep.step(state, tb, frozen, torch.Generator().manual_seed(1))
    return dict(cfg=cfg, grads=grads, fakes=fakes, tmetrics=tmetrics,
                state=state,
                old=old, jgrads=(gg, dg), jpool=np.asarray(pool),
                jcount=int(count),
                jmetrics={k: float(v) for k, v in metrics.items()},
                jnew=(jnew_g, jnew_d))


def _port_named(cfg, gg, dg):
    """JAX gradient trees (or parameter trees) under the port's parameter
    names, OIHW."""
    g = from_jax.trident_state_dict({"params": gg}, div=cfg.netg_resb_div,
                                    disp=cfg.netg_resb_disp)
    d = {f"{name}.{k}": v for name, tree in dg.items()
         for k, v in from_jax.nlayer_d_state_dict(
             {"params": tree}, cfg.n_layers_d).items()}
    return g, d


def test_every_loss_matches_jax(step_pair):
    got = {k: float(v) for k, v in step_pair["grads"].metrics.items()}
    want = step_pair["jmetrics"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **LOSS_TOL)
    # step() returns the losses of the same pass
    for k, v in step_pair["tmetrics"].items():
        np.testing.assert_allclose(float(v), got[k], rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("net", ["g", "d"])
def test_every_gradient_leaf_matches_jax(step_pair, net):
    cfg = step_pair["cfg"]
    want = _port_named(cfg, *step_pair["jgrads"])[0 if net == "g" else 1]
    got = getattr(step_pair["grads"], net)
    assert set(got) == set(want)
    zero = in_cancelled_biases(getattr(step_pair["state"], net))
    assert zero and zero < set(want)
    gscale = max(float(w.abs().max()) for w in want.values())
    errs = {}
    for k, w in want.items():
        w = w.numpy().astype(np.float64)
        g = got[k].numpy().astype(np.float64)
        assert g.shape == w.shape, k
        if k in zero:
            assert max(np.abs(w).max(), np.abs(g).max()) <= \
                ZERO_LEAF_ATOL * gscale, k
            continue
        errs[k] = np.abs(g - w).max() / np.abs(w).max()
    over = {k: e for k, e in errs.items() if e > LEAF_RTOL}
    assert len(over) <= KINK_LEAVES and all(
        e <= KINK_RTOL for e in over.values()), over
    assert max(errs.values()) > 0.0      # two implementations, not one


def test_pool_after_the_first_step(step_pair):
    grads = step_pair["grads"]
    assert grads.pool_count == step_pair["jcount"] == 2
    pool = grads.pool.numpy()
    assert not pool[2:].any() and not step_pair["jpool"][2:].any()
    # the two fakes of the step, exactly, in the order of the queries
    fake_B, fake_B2 = step_pair["fakes"]
    assert torch.equal(grads.pool[0], fake_B[0])
    assert torch.equal(grads.pool[1], fake_B2[0])
    np.testing.assert_allclose(nhwc(grads.pool[:2]), step_pair["jpool"][:2],
                               atol=1e-4)
    assert step_pair["state"].pool_count == 2
    assert torch.equal(step_pair["state"].pool, grads.pool)


@pytest.mark.parametrize("net", ["g", "d"])
def test_adam_update_matches_jax_on_decisive_elements(step_pair, net):
    cfg = step_pair["cfg"]
    state, old = step_pair["state"], step_pair["old"]
    assert state.step == 1
    i = 0 if net == "g" else 1
    new_j = _port_named(cfg, *step_pair["jnew"])[i]
    grads_j = _port_named(cfg, *step_pair["jgrads"])[i]
    if net == "g":
        new_t = state.g.state_dict()
        old_t = old
    else:
        new_t = {f"{k}": v for k, v in state.d.state_dict().items()}
        old_t = {k[2:]: v for k, v in old.items() if k.startswith("d.")}
    gscale = max(float(np.abs(g.numpy()).max()) for g in grads_j.values())
    n_checked = 0
    for k, g in grads_j.items():
        d_t = new_t[k].numpy().astype(np.float64) - old_t[k].numpy()
        d_j = new_j[k].numpy().astype(np.float64) - old_t[k].numpy()
        assert np.abs(d_t).max() <= 1.5 * cfg.lr, k
        decisive = np.abs(g.numpy()) > 5e-2 * gscale
        if decisive.any():
            np.testing.assert_allclose(d_t[decisive], d_j[decisive],
                                       rtol=2e-2, atol=2e-2 * cfg.lr,
                                       err_msg=k)
            n_checked += int(decisive.sum())
    assert n_checked > 0


def test_batch_d_passes_is_a_scheduling_change(step_pair):
    """One stacked pass per discriminator (the bench configuration) gives
    the losses and gradients of separate passes."""
    cfg = dataclasses.replace(step_pair["cfg"], batch_d_passes=True)
    gen = torch.Generator().manual_seed(0)
    state = m2.init_state(cfg, gen, "cpu")
    frozen = m2.init_frozen_random(gen, "cpu")
    _, tb = _batches(cfg)
    ref = step_pair["grads"]
    got = m2.build_train_step(cfg).grads(state, tb, frozen,
                                         torch.Generator().manual_seed(1))
    for k, v in ref.metrics.items():
        np.testing.assert_allclose(float(got.metrics[k]), float(v),
                                   rtol=1e-5, err_msg=k)
    for net in ("g", "d"):
        zero = in_cancelled_biases(getattr(state, net))
        for k, v in getattr(ref, net).items():
            if k in zero:
                continue
            w = getattr(got, net)[k]
            assert float((w - v).abs().max()) <= 1e-4 * float(
                v.abs().max()), k


def _cudnn_flags():
    c = torch.backends.cudnn
    return dict(enabled=c.enabled, benchmark=c.benchmark,
                benchmark_limit=c.benchmark_limit,
                deterministic=c.deterministic, allow_tf32=c.allow_tf32)


@pytest.mark.parametrize("deterministic", [False, True])
@pytest.mark.parametrize("allow_tf32", [False, True])
def test_step_measures_its_conv_algorithms_and_restores_the_flags(
        tmp_path, allow_tf32, deterministic):
    """Inside ``step`` cuDNN chooses by measurement (``benchmark`` on, its
    first ``MEASURED_CANDIDATES`` timed) while ``enabled``,
    ``deterministic`` and ``allow_tf32`` stay as the caller set them;
    after a step, and after a step that raises, every flag is the
    caller's again; ``m2.conv_autotune`` counts each eager step."""
    from animateportrait_tpu_torch.utils import observe

    c = torch.backends.cudnn
    saved = _cudnn_flags()
    try:
        c.benchmark, c.allow_tf32, c.deterministic = (False, allow_tf32,
                                                       deterministic)
        caller = _cudnn_flags()
        cfg = _small_cfg()
        state = m2.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
        frozen = m2.init_frozen_random(torch.Generator().manual_seed(1),
                                       "cpu")
        batch = m2.make_random_batch(cfg, 1, torch.Generator().manual_seed(2),
                                     "cpu")
        conv = next(m for m in state.g.modules()
                    if isinstance(m, torch.nn.Conv2d))
        seen, fail = [], [False]

        def hook(module, args, out):
            seen.append(_cudnn_flags())
            if fail[0]:
                raise RuntimeError("planted")

        conv.register_forward_hook(hook)
        step = m2.build_train_step(cfg)
        gen = torch.Generator().manual_seed(3)
        with observe.profile_trace(str(tmp_path)):
            for _ in range(2):
                step.step(state, batch, frozen, gen)
            counts = observe.counters()
        assert counts["m2.conv_autotune"] == 2 and state.step == 2
        assert _cudnn_flags() == caller
        inside = dict(caller, benchmark=True,
                      benchmark_limit=m2.MEASURED_CANDIDATES)
        assert seen and all(f == inside for f in seen)
        fail[0] = True
        with pytest.raises(RuntimeError, match="planted"):
            step.step(state, batch, frozen, gen)
        assert _cudnn_flags() == caller and state.step == 2
    finally:
        for k, v in saved.items():
            setattr(c, k, v)
