"""The port's checkpoints and reference-file loading against the JAX
package, on the CPU at the small configuration (crop 64, ngf = ndf = 8):

- ``CheckpointManager`` keeps the JAX (Orbax) manager's step sets in the
  epoch namespace, ``latest/`` and ``iters/`` for one sequence of saves
  (the force, keep and latest cases of ``tests/test_observe.py``, and a
  seeded random sequence);
- a restore round trip is bit-exact (parameters, Adam moments and steps,
  pool and count, step), and the next step from a restored state equals
  the next step from the live state, bitwise;
- a ``.flax.npz`` that the JAX ``save_flax_npz`` wrote loads into the port
  (``io/reference.py:load_frozen``) and its forward equals the JAX net's;
- reference-style files (a ``module.`` prefix, a ``state_dict`` wrapper,
  the keys the port drops, the SENet50 numpy pickle) load strictly, to the
  weights the JAX loaders read from them.
"""
import copy
import os
import pickle
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from animateportrait_tpu.io import checkpoint as jckpt
from animateportrait_tpu.io.torch_convert import load_torch_statedict
from animateportrait_tpu.models import perception as jperc
from animateportrait_tpu_torch.io import checkpoint as tckpt
from animateportrait_tpu_torch.io import from_jax, reference
from animateportrait_tpu_torch.train import module2 as m2
from torch_port_helpers import nchw


def _steps(directory):
    """The step numbers saved in one namespace directory (Orbax's step
    directories or the port's ``<step>.pt`` files)."""
    if not os.path.isdir(directory):
        return set()
    return {int(f.split(".")[0]) for f in os.listdir(directory)
            if f.split(".")[0].isdigit()}


# (step, force, keep, latest) sequences
SEQUENCES = {
    "force": [(10, 0, 0, 0), (13, 0, 0, 0), (13, 1, 0, 0), (14, 1, 1, 0),
              (20, 0, 0, 0), (25, 0, 1, 0), (30, 0, 0, 0)],
    "latest": [(10, 0, 0, 0), (11, 0, 0, 1), (12, 0, 0, 1), (13, 0, 1, 1),
               (14, 0, 0, 1), (20, 0, 0, 0), (21, 0, 1, 1), (30, 0, 0, 0),
               (40, 0, 0, 0), (50, 0, 0, 0)],
    "keep": [(3, 0, 1, 0), (5, 0, 1, 1), (4, 0, 1, 0), (10, 1, 1, 0),
             (12, 0, 1, 1), (20, 0, 1, 0)],
}


def _random_sequence(seed=0, n=40):
    rng, step, out = random.Random(seed), 0, []
    for _ in range(n):
        step += rng.choice([1, 1, 2, 3])
        out.append((step, rng.random() < 0.2, rng.random() < 0.3,
                    rng.random() < 0.3))
    return out


@pytest.mark.parametrize("name", ["force", "latest", "keep", "random"])
def test_manager_keeps_the_jax_step_sets(tmp_path, name):
    seq = SEQUENCES.get(name) or _random_sequence()
    jm = jckpt.CheckpointManager(str(tmp_path / "j"), max_to_keep=3,
                                 save_interval_steps=10 if name != "random"
                                 else 4)
    tm = tckpt.CheckpointManager(str(tmp_path / "t"), max_to_keep=3,
                                 save_interval_steps=jm._mgr._options
                                 .save_interval_steps)
    for step, force, keep, latest in seq:
        state = {"w": np.full(2, step, np.float32)}
        kw = dict(force=bool(force), keep=bool(keep), latest=bool(latest))
        assert tm.save(step, state, **kw) == jm.save(step, state, **kw), step
    for sub in ("", "latest", "iters"):
        assert _steps(str(tmp_path / "t" / sub)) == _steps(
            str(tmp_path / "j" / sub)), sub
    assert tm.latest_step() == jm.latest_step()
    for step in [None] + sorted(_steps(str(tmp_path / "j"))):
        want = jm.restore(step, {"w": np.zeros(2, np.float32)})
        np.testing.assert_array_equal(tm.restore(step, None)["w"], want["w"])
    jm.close()


def test_saving_a_held_step_again_raises(tmp_path):
    tm = tckpt.CheckpointManager(str(tmp_path / "t"))
    assert tm.save(5, {"w": 1})
    with pytest.raises(ValueError, match="step 5 already exists"):
        tm.save(5, {"w": 2}, force=True)
    assert tm.save(6, {"w": 3}, latest=True)
    with pytest.raises(ValueError, match="step 6 already exists"):
        tm.save(6, {"w": 4}, latest=True)
    assert not tm.save(5, {"w": 5})          # unforced: not after the newest


def _cfg():
    return m2.Module2Config(crop_size=64, ngf=8, ndf=8, pool_size=4,
                            steps_per_epoch=2)


@pytest.fixture(scope="module")
def stepped():
    """A state after one step, a frozen set, a batch and the step."""
    cfg = _cfg()
    state = m2.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    frozen = m2.init_frozen_random(torch.Generator().manual_seed(1), "cpu")
    batch = m2.make_random_batch(cfg, 1, torch.Generator().manual_seed(2),
                                 "cpu")
    step = m2.build_train_step(cfg)
    step.step(state, batch, frozen, torch.Generator().manual_seed(0))
    return state, frozen, batch, step


def _flat(state) -> dict:
    out = {}

    def walk(x, name):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{name}.{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{name}[{i}]")
        else:
            out[name] = x

    walk(tckpt.train_state_dict(state), "state")
    return out


def _assert_states_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert set(fa) == set(fb)
    for k, v in fa.items():
        if torch.is_tensor(v):
            assert v.dtype == fb[k].dtype and torch.equal(v, fb[k]), k
        else:
            assert v == fb[k], k


def test_restore_round_trip_is_bit_exact(tmp_path, stepped):
    state = stepped[0]
    mgr = tckpt.CheckpointManager(str(tmp_path / "ck"))
    assert mgr.save(state.step, state)
    fresh = m2.init_state(_cfg(), torch.Generator().manual_seed(9), "cpu")
    with pytest.raises(AssertionError):
        _assert_states_equal(state, fresh)
    restored = mgr.restore(None, fresh)
    assert restored is fresh and fresh.step == 1 and fresh.pool_count == 2
    assert any(len(s) for s in fresh.g_opt.state_dict()["state"].values())
    _assert_states_equal(state, fresh)
    # nothing but the file was left behind
    assert sorted(os.listdir(tmp_path / "ck")) == ["1.pt"]


def test_next_step_from_a_restored_state_is_bitwise(tmp_path, stepped):
    state, frozen, batch, step = stepped
    mgr = tckpt.CheckpointManager(str(tmp_path / "ck"))
    mgr.save(state.step, state, latest=True)
    live = m2.init_state(_cfg(), torch.Generator().manual_seed(9), "cpu")
    tckpt.load_train_state(live, copy.deepcopy(tckpt.train_state_dict(state)))
    restored = mgr.restore(None, m2.init_state(
        _cfg(), torch.Generator().manual_seed(8), "cpu"))
    out = [step.step(s, batch, frozen, torch.Generator().manual_seed(1))
           for s in (live, restored)]
    for k, v in out[0].items():
        assert torch.equal(v, out[1][k]), k
    _assert_states_equal(live, restored)


def test_a_state_with_capturable_adam_resumes_on_the_host(tmp_path, stepped):
    """The single-card step's CUDA graph leaves both Adams ``capturable``,
    which the host's Adam refuses. A checkpoint of such a state is written
    as an eager step leaves it (the live state keeps its groups), so it
    resumes on the CPU, and the next step there equals the next step of
    the state as it was before, bitwise."""
    state, frozen, batch, step = stepped
    graphed = copy.deepcopy(state)
    for opt in (graphed.g_opt, graphed.d_opt):
        for group in opt.param_groups:
            group["capturable"] = True
    mgr = tckpt.CheckpointManager(str(tmp_path / "ck"))
    mgr.save(graphed.step, graphed)
    assert all(g["capturable"] for opt in (graphed.g_opt, graphed.d_opt)
               for g in opt.param_groups)
    restored = mgr.restore(None, m2.init_state(
        _cfg(), torch.Generator().manual_seed(8), "cpu"))
    assert not any(g["capturable"]
                   for opt in (restored.g_opt, restored.d_opt)
                   for g in opt.param_groups)
    live = copy.deepcopy(state)
    out = [step.step(s, batch, frozen, torch.Generator().manual_seed(1))
           for s in (live, restored)]
    for k, v in out[0].items():
        assert torch.equal(v, out[1][k]), k
    _assert_states_equal(live, restored)


def _jax_variables(role, key):
    """A JAX net of ``role`` with numerically tame random weights
    (``utils/smoke.py:random_variables``) and running variances in
    [0.5, 2)."""
    from animateportrait_tpu.models.flowunet import FlowUnet as JFlow
    from animateportrait_tpu.models.modnet import MODNet as JMODNet
    from animateportrait_tpu.utils.smoke import random_variables

    net, shape = {"mobilefacenet": (jperc.MobileFaceNet(), (1, 112, 112, 3)),
                  "sphere": (jperc.Sphere20a(), (1, 112, 96, 3)),
                  "modnet": (JMODNet(), (1, 64, 64, 3)),
                  "flowunet": (JFlow(), (1, 64, 64, 136))}[role]
    v = random_variables(lambda: net.init(key, jnp.zeros(shape)))
    rng = np.random.default_rng(5)
    v = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 2.0, a.shape).astype(a.dtype)
                      if "var" in str(p[-1]) else np.asarray(a)), v)
    return net, v, shape


@pytest.mark.parametrize("role", ["mobilefacenet", "sphere", "modnet",
                                  "flowunet"])
def test_flax_npz_of_the_jax_package_loads(tmp_path, role, capsys):
    net, v, shape = _jax_variables(role, jax.random.key(3))
    jckpt.save_flax_npz(str(tmp_path / f"{role}.flax.npz"), v)
    frozen = reference.load_frozen(str(tmp_path), _cfg(),
                                   torch.Generator().manual_seed(1), "cpu")
    out = capsys.readouterr()
    assert f"frozen {role}: native" in out.out
    assert out.err.count("missing frozen ckpt") == 3
    port = getattr(frozen, role)
    x = np.random.default_rng(4).uniform(0, 1, shape).astype(np.float32)
    want = net.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = port(nchw(x))
    if role == "modnet":
        want, got = want[2], got          # the matte
    if role == "flowunet":
        want, got = want[0], got[0]       # the flow
    pairs = list(zip(jax.tree_util.tree_leaves(want),
                     got if isinstance(got, (list, tuple)) else [got]))
    assert pairs
    for w, g in pairs:
        w = np.asarray(w)
        g = g.numpy()
        g = g if g.ndim < 4 else np.moveaxis(g, 1, -1)
        scale = max(float(np.abs(w).max()), 1e-6)
        assert np.abs(g - w).max() <= 1e-4 * scale, role
    # the port's own writer round-trips through the JAX reader
    tckpt.save_flax_npz(str(tmp_path / "again.npz"), v)
    back = jckpt.load_flax_npz(str(tmp_path / "again.npz"))
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, v)


# MODNet's training heads, as the reference checkpoint holds them: the JAX
# loader reads them, the port drops them
MODNET_HEADS = {
    "lr_branch.conv_lr.layers.0.weight": (1, 32, 3, 3),
    "lr_branch.conv_lr.layers.0.bias": (1,),
    **{f"hr_branch.conv_hr.0.layers.{k}": (32,) for k in (
        "0.bias", "1.bnorm.weight", "1.bnorm.bias", "1.bnorm.running_mean",
        "1.bnorm.running_var")},
    "hr_branch.conv_hr.0.layers.0.weight": (32, 35, 3, 3),
    "hr_branch.conv_hr.1.layers.0.weight": (1, 32, 1, 1),
    "hr_branch.conv_hr.1.layers.0.bias": (1,)}


def _module_sd(net) -> dict:
    return {f"module.{k}": v.clone() for k, v in net.state_dict().items()}


def test_reference_files_load_strictly(tmp_path):
    """The four reference files, as the reference writes them, through
    ``load_frozen``: equal to the nets they came from, and to what the JAX
    package's loaders read from the same files."""
    from animateportrait_tpu.models.flowunet import load_flowunet_params
    from animateportrait_tpu.models.modnet import load_modnet_params

    src = m2.init_frozen_random(torch.Generator().manual_seed(5), "cpu")
    fd = tmp_path / "frozen"
    (fd / "FlowReg_id_flow_faces").mkdir(parents=True)
    sphere = _module_sd(src.sphere)
    sphere["module.fc6.weight"] = torch.ones(10, 512)     # dropped
    torch.save(sphere, fd / "sphere20a_20171020.pth")
    torch.save({"epoch": 7, "best_nme": 0.1,
                "state_dict": _module_sd(src.mobilefacenet)},
               fd / "mobilefacenet_model_best.pth.tar")
    torch.save(_module_sd(src.flowunet),
               fd / "FlowReg_id_flow_faces" / "best_net_netF.pth")
    modnet = _module_sd(src.modnet)
    rng = np.random.default_rng(6)
    for k, shape in MODNET_HEADS.items():      # dropped by the port
        modnet[f"module.{k}"] = torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32))
    torch.save(modnet, fd / "modnet_photographic_portrait_matting.ckpt")

    got = reference.load_frozen(str(fd), _cfg(),
                                torch.Generator().manual_seed(1), "cpu")
    for role in ("modnet", "mobilefacenet", "sphere", "flowunet"):
        want = getattr(src, role).state_dict()
        for k, v in getattr(got, role).state_dict().items():
            assert torch.equal(v, want[k]), (role, k)
    jax_read = {
        "sphere": from_jax.sphere20a_state_dict(jperc.load_sphere20a_params(
            load_torch_statedict(str(fd / "sphere20a_20171020.pth")))),
        "mobilefacenet": from_jax.mobilefacenet_state_dict(
            jperc.load_mobilefacenet_params(load_torch_statedict(
                str(fd / "mobilefacenet_model_best.pth.tar")))),
        "flowunet": from_jax.flowunet_state_dict(load_flowunet_params(
            load_torch_statedict(str(fd / "FlowReg_id_flow_faces"
                                     / "best_net_netF.pth")))),
        "modnet": from_jax.modnet_state_dict(load_modnet_params(
            load_torch_statedict(str(
                fd / "modnet_photographic_portrait_matting.ckpt")))),
    }
    for role, sd in jax_read.items():
        port = getattr(got, role).state_dict()
        for k, v in sd.items():
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_array_equal(port[k].numpy(), v.numpy(),
                                              err_msg=f"{role} {k}")
    # a key the port has no place for is an error, not dropped silently
    sphere["module.conv9_9.weight"] = torch.ones(1)
    torch.save(sphere, fd / "sphere20a_20171020.pth")
    with pytest.raises(RuntimeError, match="Unexpected key"):
        reference.load_frozen(str(fd), _cfg(),
                              torch.Generator().manual_seed(1), "cpu")


def test_senet50_pickle_loads(tmp_path):
    """The SENet50 weights as the reference ships them (a latin-1 numpy
    pickle with torch-style names and the classifier), selected by a
    'senet' ``--face_recog_model``: equal to their source, and to what the
    JAX loader reads from the same dict."""
    from animateportrait_tpu_torch.models.perception import SENet50

    src = SENet50()
    m2._lecun_init_(src, torch.Generator().manual_seed(2))
    weights = {k: v.numpy() for k, v in src.state_dict().items()
               if not k.endswith("num_batches_tracked")}
    weights["fc.weight"] = np.ones((8631, 2048), np.float32)
    weights["fc.bias"] = np.zeros(8631, np.float32)
    with open(tmp_path / "senet50_ft.pkl", "wb") as f:
        pickle.dump(weights, f)
    cfg = m2.Module2Config(crop_size=64, ngf=8, ndf=8,
                           face_recog_model="./ckpt/senet50_ft.pkl")
    got = reference.load_frozen(str(tmp_path), cfg,
                                torch.Generator().manual_seed(1), "cpu")
    assert isinstance(got.sphere, SENet50) and cfg.face_crop_hw == (224, 224)
    for k, v in src.state_dict().items():
        assert torch.equal(got.sphere.state_dict()[k], v), k
    jv = from_jax.senet50_state_dict(jperc.load_senet50_params(weights))
    for k, v in jv.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(
                got.sphere.state_dict()[k].numpy(), v.numpy(), err_msg=k)
