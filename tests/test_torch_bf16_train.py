"""The port's Module2 training step in bf16 (``compute_dtype="bfloat16"``,
``train_cli --compute_dtype bfloat16``) against the JAX package's, on the
CPU at the JAX tests' small configuration (``tests/test_torch_train.py``:
crop 64, ngf = ndf = 8, pool 4, batch 1), on the same weights, batch and
pool draws; JAX traced with its two-pass InstanceNorm statistics, as there.

bf16 rounds at other places in the two frameworks, and at random init the
bf16 gradients lie far from the fp32 ones in JAX itself (measured: the
generator's leaves 42-443% of a leaf's scale away, the discriminators'
0.03-42%), so the gradient bar is relative to that error:
each leaf's distance from the port's bf16 step to JAX's bf16 step is at most
twice JAX's bf16 distance to fp32, or twice one bf16 ulp of the leaf's
scale where that distance is below it, each as a share of the leaf's fp32
scale. The fp32 gradients are the port's fp32 step's, which
``tests/test_torch_train.py`` holds to JAX's fp32 step within 1e-3 of each
leaf's scale (this file saves a third JAX step trace that way).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

from animateportrait_tpu_torch import train_cli
from animateportrait_tpu_torch.io import checkpoint as tckpt
from animateportrait_tpu_torch.train import module2 as m2
from animateportrait_tpu_torch.utils import options as toptions
from test_torch_train import (_batches, _jax_cfg, _jax_side, _port_named,
                              _small_cfg)
from test_torch_train_cli import tree  # noqa: F401
from torch_port_helpers import in_cancelled_biases

# losses against JAX's bf16 step; measured at most 3.13e-3 (geom_B_lipline)
LOSS_RTOL = 5e-3
# a gradient leaf's distance below this share of its scale is bf16 rounding
BF16_ULP = 2.0 ** -8
GRAD_FACTOR = 2.0


@pytest.fixture(scope="module")
def bf16_pair():
    cfg = dataclasses.replace(_small_cfg(), compute_dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    state = m2.init_state(cfg, gen, "cpu")
    frozen = m2.init_frozen_random(gen, "cpu")
    jstate, jfrozen, _ = _jax_side(cfg, state, frozen)
    jb, tb = _batches(cfg)
    from animateportrait_tpu.train import module2 as j2

    os.environ["AP_IN_STATS"] = "twopass"
    try:
        gg, dg, _, _, metrics = jax.jit(j2.build_train_step(
            _jax_cfg(cfg)).grads_fn)(jstate, jb, jfrozen, jax.random.key(1))
    finally:
        del os.environ["AP_IN_STATS"]
    f32 = m2.build_train_step(dataclasses.replace(cfg, compute_dtype=(
        "float32"))).grads(state, tb, frozen, torch.Generator().manual_seed(1))
    step = m2.build_train_step(cfg)
    grads = step.grads(state, tb, frozen, torch.Generator().manual_seed(1))
    remat = m2.build_train_step(dataclasses.replace(cfg, remat=True)).grads(
        state, tb, frozen, torch.Generator().manual_seed(1))
    old = {k: v.detach().clone() for k, v in state.g.state_dict().items()}
    step.step(state, tb, frozen, torch.Generator().manual_seed(1))
    return dict(cfg=cfg, state=state, old=old, grads=grads, f32=f32,
                remat=remat, jgrads=_port_named(cfg, gg, dg),
                jmetrics={k: float(v) for k, v in metrics.items()})


def test_bf16_losses_match_jax_bf16(bf16_pair):
    got = {k: float(v) for k, v in bf16_pair["grads"].metrics.items()}
    want = bf16_pair["jmetrics"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL,
                                   err_msg=k)


@pytest.mark.parametrize("net", ["g", "d"])
def test_bf16_gradients_relative_to_jax_bf16_error(bf16_pair, net):
    """Measured, worst ratio of the port's distance to JAX bf16 over JAX
    bf16's distance to fp32 (floored at one bf16 ulp): G 0.90
    (model_landmark_trans.0.weight), D 1.18 (d_a_ll.model.8.weight)."""
    i = 0 if net == "g" else 1
    want = bf16_pair["jgrads"][i]
    got = getattr(bf16_pair["grads"], net)
    f32 = getattr(bf16_pair["f32"], net)
    assert set(got) == set(want) == set(f32)
    zero = in_cancelled_biases(getattr(bf16_pair["state"], net))
    ratios = {}
    for k, w in want.items():
        g = got[k].numpy().astype(np.float64)
        assert got[k].dtype == torch.float32 and g.shape == w.shape, k
        if k in zero:
            continue
        ref = f32[k].numpy().astype(np.float64)
        scale = np.abs(ref).max()
        w = w.numpy().astype(np.float64)
        port_to_jax = np.abs(g - w).max() / scale
        jax_to_f32 = np.abs(w - ref).max() / scale
        ratios[k] = port_to_jax / max(jax_to_f32, BF16_ULP)
    assert max(ratios.values()) <= GRAD_FACTOR, sorted(
        ratios.items(), key=lambda kv: kv[1])[-3:]


def test_bf16_masters_and_adam_stay_fp32_and_move(bf16_pair):
    state, old = bf16_pair["state"], bf16_pair["old"]
    assert state.step == 1 and state.compute_dtype == "bfloat16"
    for net, opt in ((state.g, state.g_opt), (state.d, state.d_opt)):
        assert {p.dtype for p in net.parameters()} == {torch.float32}
        assert {t.dtype for s in opt.state.values() for t in s.values()
                if t.is_floating_point()} == {torch.float32}
    moved = max(float((v - old[k]).abs().max())
                for k, v in state.g.state_dict().items())
    assert 0.0 < moved <= 1.5 * bf16_pair["cfg"].lr
    assert state.pool.dtype == torch.float32 and state.pool_count == 2


@pytest.mark.parametrize("net", ["g", "d"])
def test_bf16_remat_gives_the_same_gradients(bf16_pair, net):
    """On the CPU the recompute repeats the forward bit for bit."""
    ref = getattr(bf16_pair["grads"], net)
    got = getattr(bf16_pair["remat"], net)
    for k, v in ref.items():
        assert torch.equal(got[k], v), k


def test_train_cli_bf16_trains_saves_and_resumes(tree, tmp_path):  # noqa: F811
    """``train_cli --compute_dtype bfloat16`` for two steps on the CPU: the
    checkpoint holds fp32 masters and the dtype, restores bit for bit,
    refuses an fp32 state, and ``--continue_train`` resumes from it."""
    ck = str(tmp_path / "ck")
    argv = ["--dataroot", tree, "--checkpoints_dir", ck, "--name", "bf16",
            "--output_nc", "1", "--ngf", "8", "--ndf", "8", "--load_size",
            "72", "--crop_size", "64", "--batch_size", "2",
            "--num_threads", "2", "--pool_size", "4", "--steps_per_epoch",
            "4", "--print_freq", "1", "--display_freq", "2",
            "--compute_dtype", "bfloat16", "--frozen_dir",
            str(tmp_path / "none"), "--device", "cpu"]
    run = train_cli.main(argv + ["--max_steps", "2"])
    assert run.state.step == 2 and run.state.compute_dtype == "bfloat16"
    assert all(np.isfinite(r.comp_s) for r in run.records)
    mgr = tckpt.CheckpointManager(os.path.join(ck, "bf16", "checkpoints"))
    saved = mgr.restore(2, None)
    assert saved["compute_dtype"] == "bfloat16"
    assert {v.dtype for v in saved["g"].values()} == {torch.float32}
    cfg, _ = toptions.to_configs(train_cli.build_argparser().parse_args(
        argv))
    fresh = mgr.restore(2, m2.init_state(
        cfg, torch.Generator().manual_seed(5), "cpu"))
    a, b = tckpt.train_state_dict(run.state), tckpt.train_state_dict(fresh)
    assert a["compute_dtype"] == b["compute_dtype"] and a["step"] == b["step"]
    for part in ("g", "d"):
        for k, v in a[part].items():
            assert torch.equal(v, b[part][k]), (part, k)
    assert torch.equal(a["pool"], b["pool"])
    for opt in ("g_opt", "d_opt"):
        for i, s in a[opt]["state"].items():
            for k, v in s.items():
                assert torch.equal(v, b[opt]["state"][i][k]), (opt, i, k)
    with pytest.raises(ValueError, match="bfloat16 run"):
        mgr.restore(2, m2.init_state(dataclasses.replace(
            cfg, compute_dtype="float32"), torch.Generator().manual_seed(5),
            "cpu"))
    run2 = train_cli.main(argv + ["--max_steps", "3", "--continue_train"])
    assert run2.resumed_from == 2 and run2.state.step == 3
