"""The port's FSDP-sharded Module2 state (``train/fsdp.py``) against the JAX
package's (``animateportrait_tpu/train/module2.py:798-869``), on the CPU at
the small configuration of ``tests/test_torch_train.py`` (crop 64, ngf =
ndf = 8) over gloo ranks spawned on the CPU:

- the shard axis of every G and D leaf equals JAX's
  ``fsdp_param_shardings`` spec at world 2 and 4 and ``min_size`` 2**10,
  mapped from JAX's HWIO (HWOI) layout to torch's through
  ``io/from_jax.py``;
- each rank holds 1/n of every sharded leaf and of both its Adam moments;
- 2 sharded steps on a global batch of 4 over 2 ranks against JAX's
  ``shard_state_fsdp`` step jitted on a 2-device mesh: losses within rtol
  1e-4 / atol 1e-5 at both steps, the first step's gradients by
  ``utils/smoke.py:grad_parity`` with a float64 run of the port's step at
  ``tests/test_torch_train.py``'s bars, and both Adam updates by
  ``adam_update_parity``. The pool holds 16, so both steps only fill it
  and no random draw (JAX's or torch's) decides a loss;
- the same losses, gradients and parameters as the port's data-parallel
  step on the same batch (bit-equal under gloo: both sum two ranks);
- the gathered state written by ``io/checkpoint.py`` loads into an
  unsharded state equal to the data-parallel run's, Adam moments too.
"""
import os

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from animateportrait_tpu_torch.io.checkpoint import (
    CheckpointManager, train_state_dict)
from animateportrait_tpu_torch.train import fsdp
from animateportrait_tpu_torch.train import module2 as m2
from animateportrait_tpu_torch.utils import distributed as ddp
from animateportrait_tpu_torch.utils.smoke import (
    adam_update_parity, fsdp_steps, grad_parity, jobs_rank)
from test_torch_data_parallel import _grads_f64
from test_torch_train import (KINK_LEAVES, KINK_RTOL, LEAF_RTOL, LOSS_TOL,
                              _batches, _jax_cfg, _jax_side, _port_named)
from torch_port_helpers import adam_grads, in_cancelled_biases

GLOBAL_BATCH, RANKS, STEPS = 4, 2, 2
MIN_SIZE = 2 ** 10            # __graft_entry__.py:94
SPAWN_TIMEOUT = 240           # s, for the ranks of one spawn


def _cfg():
    return m2.Module2Config(crop_size=64, output_nc=1, ngf=8, ndf=8,
                            steps_per_epoch=2, pool_size=16,
                            lambda_geom_lipline=50.0)


def _seeded(cfg):
    """dp_step_run's seeded state and frozen nets."""
    return (m2.init_state(cfg, torch.Generator().manual_seed(0), "cpu"),
            m2.init_frozen_random(torch.Generator().manual_seed(1), "cpu"))


def _jax_axes(tree, mesh):
    """Each leaf of a JAX parameter tree marked by its FSDP shard axis:
    0 everywhere, or its index along the sharded axis plus 1, so that the
    axis survives any transpose of the layout conversion."""
    from animateportrait_tpu.train import module2 as j2

    specs = j2.fsdp_param_shardings(tree, mesh, min_size=MIN_SIZE)

    def mark(x, sh):
        axes = [i for i, a in enumerate(sh.spec) if a == "data"]
        out = np.zeros(np.shape(x), np.float32)
        if axes:
            shape = [1] * out.ndim
            shape[axes[0]] = out.shape[axes[0]]
            out += np.arange(1, out.shape[axes[0]] + 1).reshape(shape)
        return out

    return jax.tree_util.tree_map(mark, tree, specs)


def _varying_axis(t: torch.Tensor):
    axes = [a for a in range(t.dim()) if t.shape[a] > 1
            and bool((t.diff(dim=a) != 0).any())]
    assert len(axes) <= 1
    return axes[0] if axes else None


@pytest.mark.parametrize("world", [2, 4])
def test_shard_axes_match_jax(world):
    cfg = _cfg()
    state, frozen = _seeded(cfg)
    jstate, _, _ = _jax_side(cfg, state, frozen)
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
    marked = _port_named(cfg, _jax_axes(jstate.g_params, mesh),
                         _jax_axes(jstate.d_params, mesh))
    n_sharded = 0
    for net, want in zip((state.g, state.d), marked):
        got = fsdp.fsdp_param_shardings(dict(net.named_parameters()), world,
                                        MIN_SIZE)
        assert set(got) == set(want)
        for k, axis in got.items():
            assert axis == _varying_axis(want[k]), k
            n_sharded += axis is not None
    assert n_sharded > 20


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's FSDP step twice on the sharded global batch, and the 2-rank
    port run of the data-parallel and the FSDP steps, from the same
    weights and batch."""
    from animateportrait_tpu.train import module2 as j2

    cfg = _cfg()
    jb, tb = _batches(cfg, GLOBAL_BATCH)
    batch = {k: v.numpy() for k, v in tb.items()}
    state, frozen = _seeded(cfg)
    jstate, jfrozen, _ = _jax_side(cfg, state, frozen)
    mesh = Mesh(np.array(jax.devices()[:RANKS]), ("data",))
    shard = NamedSharding(mesh, PartitionSpec("data"))
    repl = NamedSharding(mesh, PartitionSpec())
    jb = {k: jax.device_put(v, shard) for k, v in jb.items()}
    jstate = j2.shard_state_fsdp(jstate, mesh, min_size=MIN_SIZE)
    jfrozen = jax.device_put(jfrozen, repl)
    assert any(not x.sharding.is_fully_replicated
               for x in jax.tree_util.tree_leaves(jstate.g_params))
    # two-pass InstanceNorm statistics, as tests/test_torch_train.py traces
    os.environ["AP_IN_STATS"] = "twopass"
    try:
        jstep = jax.jit(j2.build_train_step(_jax_cfg(cfg)),
                        out_shardings=(j2.state_shardings(jstate), None))
        jstates, jmetrics = [jstate], []
        for i in range(STEPS):
            s, met = jstep(jstates[-1], jb, jfrozen, jax.random.key(i))
            jstates.append(s)
            jmetrics.append({k: float(v) for k, v in met.items()})
    finally:
        del os.environ["AP_IN_STATS"]

    d = tmp_path_factory.mktemp("fsdp")
    ddp.spawn(jobs_rank, ["cpu"] * RANKS,
              {"steps": (fsdp_steps, (cfg, batch, STEPS, MIN_SIZE, str(d)))},
              str(d), timeout=SPAWN_TIMEOUT)
    ranks = [torch.load(d / f"rank{r}.pt")["steps"] for r in range(RANKS)]
    return dict(cfg=cfg, state=state, ranks=ranks, jstates=jstates, dir=d,
                jmetrics=jmetrics,
                grads64=_grads_f64(cfg, state, frozen, tb),
                jgrads=_port_named(cfg, adam_grads(jstates[1].g_opt,
                                                   cfg.beta1),
                                   adam_grads(jstates[1].d_opt, cfg.beta1)))


def test_each_rank_holds_a_slice_of_every_sharded_leaf(runs):
    for rank in runs["ranks"]:
        rec = rank["fsdp"]
        full = {f"{net}.{k}": v for net in ("g", "d")
                for k, v in rec["params"][0][net].items()}
        assert len(rec["shapes"]) > 20
        for key, (shape, axis, moments) in rec["shapes"].items():
            want = list(full[key].shape)
            want[axis] //= RANKS
            assert list(shape) == want, key
            assert list(moments) == [shape, shape], key
        b = rec["fsdp_bytes"]
        assert b["sharded"] * RANKS == b["unsharded"] > 0
        assert b["sharded"] > 10 * b["replicated"]
        assert rec["reduce_scatter_bytes"] == 4 * sum(
            np.prod(s) for s, _, _ in rec["shapes"].values()) * RANKS


def test_fsdp_losses_match_jax(runs):
    got = runs["ranks"][0]["fsdp"]["metrics"]
    for step in range(STEPS):
        want = runs["jmetrics"][step]
        assert set(got[step]) == set(want)
        for k in want:
            np.testing.assert_allclose(got[step][k], want[k],
                                       err_msg=f"step {step} {k}",
                                       **LOSS_TOL)


@pytest.mark.parametrize("net", ["g", "d"])
def test_fsdp_gradients_and_updates_match_jax(runs, net):
    """The first step's gradients (JAX's from its first Adam moment) by
    ``grad_parity`` with the port's float64 step, as
    ``tests/test_torch_data_parallel.py`` holds the DP step; each update
    of the parameters by ``adam_update_parity``."""
    cfg = runs["cfg"]
    i = 0 if net == "g" else 1
    rec = runs["ranks"][0]["fsdp"]
    noise = in_cancelled_biases(getattr(runs["state"], net))
    want = runs["jgrads"][i]
    errs = grad_parity(rec["grads"][0][net], want,
                       getattr(runs["grads64"], net), noise)
    over = {k: e for k, e in errs.items() if e > LEAF_RTOL}
    assert len(over) <= KINK_LEAVES and all(
        e <= KINK_RTOL for e in over.values()), over
    assert max(errs.values()) > 0.0          # two implementations
    old = rec["params"][0][net]
    for steps in (1, STEPS):
        js = runs["jstates"][steps]
        jp = _port_named(cfg, js.g_params, js.d_params)[i]
        bound, decided = adam_update_parity(rec["params"][steps][net], jp,
                                            old, want, cfg.lr, steps)
        assert bound <= 1.0, (steps, bound)
        assert steps > 1 or decided <= 1.0, decided


def test_fsdp_takes_the_data_parallel_update(runs):
    for rank in runs["ranks"]:
        dp, fs = rank["dp"], rank["fsdp"]
        assert rank["backend"] == "gloo"
        assert dp["metrics"] == fs["metrics"]
        for step in range(STEPS):
            for net in ("g", "d"):
                for k, v in dp["grads"][step][net].items():
                    assert torch.equal(fs["grads"][step][net][k], v), k
                for k, v in dp["params"][step + 1][net].items():
                    assert torch.equal(fs["params"][step + 1][net][k], v), k
        assert fs["allreduce_bytes"] < dp["allreduce_bytes"]


def test_checkpoint_of_a_sharded_state_loads_as_the_unsharded_one(runs):
    """Each run's state after 2 steps, saved through ``CheckpointManager``
    (the sharded one gathered whole by ``train_state_dict`` on both
    ranks): the sharded checkpoint loads into an unsharded state and
    equals the data-parallel one, Adam moments too; a sharded state
    refuses a load."""
    d = runs["dir"]
    sharded = CheckpointManager(str(d / "fsdp")).restore(
        None, _seeded(runs["cfg"])[0])
    dp = torch.load(d / "dp" / f"{STEPS}.pt", weights_only=False)
    got = train_state_dict(sharded)
    assert got["step"] == dp["step"] == STEPS
    for net in ("g", "d"):
        for k, v in dp[net].items():
            assert torch.equal(got[net][k], v), k
    for opt in ("g_opt", "d_opt"):
        assert got[opt]["state"].keys() == dp[opt]["state"].keys()
        for i, st in dp[opt]["state"].items():
            for k, v in st.items():
                assert torch.equal(got[opt]["state"][i][k], v), (opt, i, k)
    s = _seeded(runs["cfg"])[0]
    s.fsdp = object()
    with pytest.raises(ValueError, match="unsharded"):
        CheckpointManager(str(d / "fsdp")).restore(None, s)
