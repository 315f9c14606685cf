"""SENet50, the FaceLoss net a 'senet' ``--face_recog_model`` selects,
against the JAX package on the CPU: its five feature levels on a 224 x 224
input, and a training step with it (crop 64, ngf = ndf = 4, as
``tests/test_dataset.py::test_train_step_senet_identity_loss`` runs it),
every loss within rtol 1e-4 and the gradient leaves within 1e-3 of their
scale (as ``tests/test_torch_train.py`` holds them)."""
import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

from animateportrait_tpu.models import perception as jperc
from animateportrait_tpu_torch.io import from_jax
from animateportrait_tpu_torch.models.perception import SENet50
from animateportrait_tpu_torch.train import module2 as m2
from test_torch_train import (KINK_LEAVES, KINK_RTOL, LEAF_RTOL, LOSS_TOL,
                              ZERO_LEAF_ATOL, _batches, _jax_cfg, _jax_side,
                              _numpy_sd, _port_named)
from torch_port_helpers import in_cancelled_biases, nchw


def test_senet50_forward_matches_jax():
    from animateportrait_tpu.utils.smoke import random_variables

    net = jperc.SENet50()
    v = random_variables(lambda: net.init(jax.random.key(0),
                                          jnp.zeros((1, 224, 224, 3))))
    rng = np.random.default_rng(1)
    v = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 2.0, a.shape).astype(a.dtype)
                      if "var" in str(p[-1]) else np.asarray(a)), v)
    port = SENet50().eval()
    port.load_state_dict(from_jax.senet50_state_dict(v))
    x = rng.uniform(-1, 1, (1, 224, 224, 3)).astype(np.float32)
    want = net.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = port(nchw(x))
    assert len(got) == len(want) == 5
    for w, g in zip(want, got):
        w = np.asarray(w)
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()


def test_senet_training_step_matches_jax():
    from animateportrait_tpu.train import module2 as j2

    cfg = m2.Module2Config(crop_size=64, output_nc=1, ngf=4, ndf=4,
                           pool_size=2, steps_per_epoch=2,
                           face_recog_model="checkpoints/senet50_ft.pkl")
    assert cfg.use_senet and cfg.face_crop_hw == (224, 224)
    state = m2.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    frozen = m2.init_frozen_random(torch.Generator().manual_seed(1), "cpu",
                                   cfg.face_recog_model)
    assert isinstance(frozen.sphere, SENet50)
    # the JAX side's FaceLoss net from the same weights, by its own loader
    sphere, frozen.sphere = frozen.sphere, m2.init_frozen_random(
        torch.Generator().manual_seed(1), "cpu").sphere
    jstate, jfrozen, _ = _jax_side(cfg, state, frozen)
    frozen.sphere = sphere
    jfrozen = jfrozen.replace(
        sphere=jperc.load_senet50_params(_numpy_sd(sphere)))
    jb, tb = _batches(cfg)
    os.environ["AP_IN_STATS"] = "twopass"
    try:
        jstep = j2.build_train_step(_jax_cfg(cfg))
        gg, dg, _, _, metrics = jax.jit(jstep.grads_fn)(
            jstate, jb, jfrozen, jax.random.key(1))
    finally:
        del os.environ["AP_IN_STATS"]
    grads = m2.build_train_step(cfg).grads(state, tb, frozen,
                                           torch.Generator().manual_seed(1))
    got = {k: float(v) for k, v in grads.metrics.items()}
    want = {k: float(v) for k, v in metrics.items()}
    assert set(got) == set(want) and got["iden_B"] > 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **LOSS_TOL)
    for i, net in enumerate(("g", "d")):
        ref = _port_named(cfg, gg, dg)[i]
        mine = getattr(grads, net)
        zero = in_cancelled_biases(getattr(state, net))
        gscale = max(float(w.abs().max()) for w in ref.values())
        errs = {}
        for k, w in ref.items():
            if k in zero:
                assert max(float(w.abs().max()), float(mine[k].abs().max())
                           ) <= ZERO_LEAF_ATOL * gscale, k
                continue
            errs[k] = float((mine[k] - w).abs().max() / w.abs().max())
        over = {k: e for k, e in errs.items() if e > LEAF_RTOL}
        assert len(over) <= KINK_LEAVES and all(
            e <= KINK_RTOL for e in over.values()), (net, over)
