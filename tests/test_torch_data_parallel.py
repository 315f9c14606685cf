"""The port's data-parallel training against the JAX package's, on the CPU
at the small configuration of ``tests/test_torch_train.py`` (crop 64,
ngf = ndf = 8) with a pool of 8, over gloo ranks spawned on the CPU:

- the 2-rank step (``Module2TrainStep.grads`` with a process group) on a
  global batch of 4 against the JAX step jitted with that batch on a
  2-device ``NamedSharding`` (what ``train_cli --data_parallel 2`` runs):
  losses within rtol 1e-4 / atol 1e-5, every gradient leaf by
  ``utils/smoke.py:grad_parity`` against JAX's and a float64 run of the
  port's step, at ``tests/test_torch_train.py``'s bars (1e-3 of a leaf's
  scale, up to two kink leaves within 5e-2), and the pool after the
  first step (it only fills: the 4 fakes of each query, in order);
- the same 2-rank run for 2 steps against the single-process port on the
  global batch: losses, the first step's gradients, both pools (the
  second step's draws swap history) and the parameters after both steps;
  the two ranks end with the same parameters.

The trainer's ``--data_parallel`` and ``--multihost`` runs are in
``tests/test_torch_data_parallel_cli.py``.
"""
import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from animateportrait_tpu_torch.train import module2 as m2
from animateportrait_tpu_torch.utils import distributed as ddp
from animateportrait_tpu_torch.utils.smoke import (
    adam_update_parity, dp_step_rank, dp_step_run, grad_parity)
from test_torch_train import (KINK_LEAVES, KINK_RTOL, LEAF_RTOL, LOSS_TOL,
                              _batches, _jax_cfg, _jax_side, _port_named)
from torch_port_helpers import in_cancelled_biases, nhwc

GLOBAL_BATCH, RANKS, STEPS = 4, 2, 2
LEAF_BAR = 1e-3               # grad_parity's bar, of each leaf's scale
POOL2_ATOL = 1e-3             # the fakes of a G after one Adam update
SPAWN_TIMEOUT = 180           # s, for the ranks of one spawn


def _cfg():
    return m2.Module2Config(crop_size=64, output_nc=1, ngf=8, ndf=8,
                            steps_per_epoch=2, pool_size=8,
                            lambda_geom_lipline=50.0)


class _Step64(m2.Module2TrainStep):
    """The port's step in float64 throughout (nets, frozen nets, batch and
    pool cast by the caller): an exact-arithmetic stand-in for both
    packages' fp32 steps, as ``tests/test_torch_module1.py`` runs one."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.cdt = torch.float64

    def apply(self, net, *args):
        return net(*args)

    def frozen_nets(self, frozen):
        return frozen


def _grads_f64(cfg, state, frozen, batch):
    state, frozen = copy.deepcopy(state), copy.deepcopy(frozen)
    for net in (state.g, state.d, *(getattr(frozen, f.name) for f in
                                    dataclasses.fields(frozen))):
        net.double()
    state.pool = state.pool.double()
    batch = {k: v.double() if v.is_floating_point() else v
             for k, v in batch.items()}
    return _Step64(cfg).grads(state, batch, frozen,
                              torch.Generator().manual_seed(1))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX step on the sharded global batch, the 2-rank port run and
    the single-process port run, from the same weights and batch."""
    cfg = _cfg()
    jb, tb = _batches(cfg, GLOBAL_BATCH)
    batch = {k: v.numpy() for k, v in tb.items()}

    # the port's seeded weights (dp_step_run's seeds) into the JAX package
    state = m2.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    frozen = m2.init_frozen_random(torch.Generator().manual_seed(1), "cpu")
    jstate, jfrozen, _ = _jax_side(cfg, state, frozen)
    from animateportrait_tpu.train import module2 as j2

    mesh = Mesh(np.array(jax.devices()[:RANKS]), ("data",))
    shard = NamedSharding(mesh, PartitionSpec("data"))
    repl = NamedSharding(mesh, PartitionSpec())
    jb = {k: jax.device_put(v, shard) for k, v in jb.items()}
    jstate = jax.device_put(jstate, repl)
    jfrozen = jax.device_put(jfrozen, repl)
    # two-pass InstanceNorm statistics, as tests/test_torch_train.py traces
    os.environ["AP_IN_STATS"] = "twopass"
    try:
        jstep = j2.build_train_step(_jax_cfg(cfg))
        gg, dg, pool, count, metrics = jax.jit(jstep.grads_fn)(
            jstate, jb, jfrozen, jax.random.key(1))
    finally:
        del os.environ["AP_IN_STATS"]
    assert len(jax.tree_util.tree_leaves(gg)[0].sharding.device_set) == RANKS

    d = tmp_path_factory.mktemp("dp")
    ddp.spawn(dp_step_rank, ["cpu"] * RANKS, cfg, batch, STEPS, str(d),
              timeout=SPAWN_TIMEOUT)
    ranks = [torch.load(d / f"rank{r}.pt") for r in range(RANKS)]
    single = dp_step_run(cfg, batch, STEPS, torch.device("cpu"))
    grads64 = _grads_f64(cfg, state, frozen, tb)
    return dict(cfg=cfg, state=state, ranks=ranks, single=single,
                grads64=grads64,
                jgrads=(gg, dg), jpool=np.asarray(pool), jcount=int(count),
                jmetrics={k: float(v) for k, v in metrics.items()})


def test_dp_losses_match_jax(runs):
    got = runs["ranks"][0]["metrics"][0]
    want = runs["jmetrics"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **LOSS_TOL)


@pytest.mark.parametrize("net", ["g", "d"])
def test_dp_gradients_match_jax(runs, net):
    """Every leaf by ``grad_parity`` with a float64 run of the port's step
    as the exact reference, at ``tests/test_torch_train.py``'s bars. On
    this global batch of 4 the step is ill-conditioned in fp32: JAX's
    unsharded G is up to 3.0e-2 of a leaf's scale from float64 and its D
    6.1e-3, where the port's D is 2.3e-4; a leaf passes when it is no
    farther from float64 than 3x JAX's own distance."""
    cfg = runs["cfg"]
    want = _port_named(cfg, *runs["jgrads"])[0 if net == "g" else 1]
    ref64 = getattr(runs["grads64"], net)
    noise = in_cancelled_biases(getattr(runs["state"], net))
    for got in (runs["ranks"][0]["grads"][0][net],
                runs["single"]["grads"][0][net]):
        assert set(got) == set(want) == set(ref64)
        errs = grad_parity(got, want, ref64, noise)
        over = {k: e for k, e in errs.items() if e > LEAF_RTOL}
        assert len(over) <= KINK_LEAVES and all(
            e <= KINK_RTOL for e in over.values()), over
        assert max(errs.values()) > 0.0      # two implementations


def test_dp_pool_after_the_first_step_matches_jax(runs):
    """The pool of 8 only fills in the first step: the global batch's 4
    fakes of each query, in rank order, on every rank."""
    single = runs["single"]
    for rank in runs["ranks"]:
        assert rank["pool_counts"][0] == runs["jcount"] == 8
        np.testing.assert_allclose(nhwc(rank["pools"][0]), runs["jpool"],
                                   atol=1e-4)
        assert torch.equal(rank["pools"][0], runs["ranks"][0]["pools"][0])
    np.testing.assert_allclose(runs["ranks"][0]["pools"][0].numpy(),
                               single["pools"][0].numpy(), atol=1e-5)


def test_dp_matches_the_single_process_step(runs):
    dp, single = runs["ranks"][0], runs["single"]
    for step in range(STEPS):
        for k, v in single["metrics"][step].items():
            np.testing.assert_allclose(dp["metrics"][step][k], v,
                                       err_msg=f"step {step} {k}",
                                       **LOSS_TOL)
    # the second step queries a full pool: the same draws swap the same
    # slots with history; the fakes it stores come from G after an Adam
    # update, which moves every element whose gradient is rounding noise
    # (the biases an InstanceNorm cancels) by up to lr in either run
    assert dp["pool_counts"] == single["pool_counts"] == [8, 8]
    kept = [[torch.equal(run["pools"][1][i], run["pools"][0][i])
             for i in range(8)] for run in (dp, single)]
    assert kept[0] == kept[1] and 0 < sum(kept[0]) < 8
    np.testing.assert_allclose(dp["pools"][1].numpy(),
                               single["pools"][1].numpy(), atol=POOL2_ATOL)
    lr = runs["cfg"].lr
    for net in ("g", "d"):
        noise = in_cancelled_biases(getattr(runs["state"], net))
        errs = grad_parity(dp["grads"][0][net], single["grads"][0][net],
                           None, noise)
        assert max(errs.values()) <= LEAF_BAR, net
        # the first update where its gradient decides it (as
        # tests/test_torch_train.py holds one update); after the second,
        # whose gradients follow the first update's noise elements, the
        # bound on Adam's steps (its losses are held above)
        for steps in (1, STEPS):
            bound, decided = adam_update_parity(
                dp["params"][steps][net], single["params"][steps][net],
                single["params"][0][net], single["grads"][0][net], lr, steps)
            assert bound <= 1.0, (net, steps, bound)
            assert steps > 1 or decided <= 1.0, (net, decided)


def test_dp_ranks_end_equal(runs):
    """Every rank takes the same averaged gradients and Adam update."""
    a, b = runs["ranks"]
    assert a["backend"] == b["backend"] == "gloo"
    assert a["metrics"] == b["metrics"]
    for net in ("g", "d"):
        for k, v in a["params"][-1][net].items():
            assert torch.equal(v, b["params"][-1][net][k]), k
    assert a["allreduce_bytes"] == b["allreduce_bytes"] > 0
