"""The Module1 trainers of the PyTorch port against the JAX package: the
speaker-aware net and the content net in training mode, the Laplacian
term, one step of each trainer (losses, gradients, parameters and the
content net's BatchNorm statistics after the step), the speaker-aware
weights' round trip, and the audio2landmark datasets item for item on
pickles the test writes. Bounds are stated per test."""
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from animateportrait_tpu.utils.smoke import random_variables
from animateportrait_tpu_torch.io import from_jax
from animateportrait_tpu_torch.models.audio2landmark import (
    Audio2landmarkContent, Audio2landmarkSpeakerAware)
from animateportrait_tpu_torch.train import module1 as tm1
from animateportrait_tpu_torch.utils.smoke import cancelled_biases, grad_parity
from torch_port_helpers import adam_grads, maxdiff, module_grads


def f64_grads(trainer_cls, cfg, net, *batch, **kw):
    """The gradients of one step of a float64 copy of ``net`` on the
    float64 batch (an exact-arithmetic stand-in for both packages' fp32
    sums)."""
    import copy
    net64 = copy.deepcopy(net).double()
    tr = trainer_cls(cfg, net64, device="cpu")
    tr.step(*(b.double() if torch.is_tensor(b) and b.is_floating_point()
              else b for b in batch),
            **{k: v.double() if torch.is_tensor(v) else v
               for k, v in kw.items()})
    return module_grads(tr.model)

K = jax.random.key(0)
T = 10


def _speaker_vars():
    from animateportrait_tpu.models.audio2landmark import (
        Audio2landmarkSpeakerAware as J)
    return random_variables(lambda: J().init(
        {"params": K, "z_spk": K}, jnp.zeros((2, 18, 80)),
        jnp.zeros((2, 256)), jnp.zeros((1, 204)), add_z_spk=True), seed=3)


def _content_vars():
    from animateportrait_tpu.models.audio2landmark import (
        Audio2landmarkContent as J)
    rng = np.random.default_rng(5)
    v = random_variables(lambda: J().init(K, jnp.zeros((2, 18, 80)),
                                          jnp.zeros((1, 204))), seed=4)
    # non-trivial running statistics, and LSTM weights (std 0.15) large
    # enough that its last output varies across windows: at 0.05 some of
    # fc.1's channels (which also see the one face_id) have std/|mean|
    # ~ 1e-3, where flax's E[x^2] - E[x]^2 in fp32 keeps ~2 digits of the
    # variance in either package, and at 0.4 the LSTM saturates; at both,
    # each package's gradients are ~2e-3 (of their scale) from a float64
    # run
    return jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 2.0, a.shape).astype(a.dtype)
                      if "var" in str(p[-1]) else
                      rng.uniform(-0.5, 0.5, a.shape).astype(a.dtype)
                      if "mean" in str(p[-1]) else
                      a * 3 if "lstm" in jax.tree_util.keystr(p) else a), v)


def _z_draw(params, key, shape):
    """The JAX module's z: its ``z_spk`` rng as ``make_rng`` derives it in
    the root scope, drawn unit normal."""
    from animateportrait_tpu.models.audio2landmark import (
        Audio2landmarkSpeakerAware as J)
    k = J().apply({"params": params}, method=lambda m: m.make_rng("z_spk"),
                  rngs={"z_spk": key})
    return np.asarray(jax.random.normal(k, shape))


def _a2l_batch(seed=0):
    rng = np.random.default_rng(seed)
    aus = rng.standard_normal((T, 18, 80)).astype(np.float32)
    fls = rng.standard_normal((T, 18, 204)).astype(np.float32) * 0.1
    embs = rng.standard_normal((T, 256)).astype(np.float32)
    fid = rng.standard_normal((1, 204)).astype(np.float32)
    gt = rng.standard_normal((T, 204)).astype(np.float32)
    quat = rng.standard_normal((T, 4)).astype(np.float32)
    trans = rng.standard_normal((T, 3, 4)).astype(np.float32)
    return dict(aus=aus, fls=fls, embs=embs, fid=fid, gt=gt, quat=quat,
                trans=trans)


def test_speaker_aware_forward_matches_jax_with_its_z():
    """Eval forward with the JAX module's own z draw: max |diff| <= 1e-4;
    the drawn z is the spk_encode difference of add_z_spk on and off."""
    from animateportrait_tpu.models.audio2landmark import (
        Audio2landmarkSpeakerAware as J)
    v = _speaker_vars()
    b = _a2l_batch()
    key = jax.random.key(11)
    args = [jnp.asarray(b[k]) for k in ("aus", "embs", "fid")]
    ref = J().apply(v, *args, add_z_spk=True, rngs={"z_spk": key})
    ref0 = J().apply(v, *args)
    z = _z_draw(v["params"], key, (T, 128))
    assert maxdiff((np.asarray(ref[3]) - np.asarray(ref0[3])) / 0.01, z) \
        < 1e-4
    net = Audio2landmarkSpeakerAware()
    net.load_state_dict(from_jax.speaker_aware_state_dict(v))
    with torch.no_grad():
        got = net(*(torch.from_numpy(b[k]) for k in ("aus", "embs", "fid")),
                  add_z_spk=True, z=torch.from_numpy(z))
    for g, r in zip(got, ref):
        assert maxdiff(g, r) <= 1e-4
    # a torch.Generator draw when no z is given
    g1 = net(*(torch.from_numpy(b[k]) for k in ("aus", "embs", "fid")),
             add_z_spk=True, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(g1[0]).all()


def test_speaker_aware_state_dict_round_trips():
    """Every key of the port's module is written, and each leaf is the JAX
    leaf transposed, so the JAX tree comes back exactly."""
    v = _speaker_vars()
    sd = from_jax.speaker_aware_state_dict(v)
    net = Audio2landmarkSpeakerAware()
    assert set(sd) == set(net.state_dict())
    p = v["params"]
    assert np.array_equal(sd["pos_out.4.weight"].numpy().T,
                          np.asarray(p["pos_l2"]["kernel"]))
    assert np.array_equal(sd["fls_out.0.weight"].numpy().T,
                          np.asarray(p["fls_l0"]["kernel"]))
    assert np.array_equal(
        sd["encoder.layers.1.attn.q_linear.bias"].numpy(),
        np.asarray(p["encoder"]["layer1"]["attn"]["q"]["bias"]))


def test_content_train_mode_matches_flax_batchnorm():
    """Training-mode forward and the running statistics it leaves (flax
    updates the running variance with the biased batch variance): the
    statistics within 1e-4 of their scale, the output within 1e-4 and no
    farther from a float64 run of the port than 1.5x JAX's own distance
    from it."""
    from animateportrait_tpu.models.audio2landmark import (
        Audio2landmarkContent as J)
    v = _content_vars()
    b = _a2l_batch(1)
    (ref, _), upd = J().apply(v, jnp.asarray(b["aus"]), jnp.asarray(b["fid"]),
                              train=True, mutable=["batch_stats"])
    net = Audio2landmarkContent()
    net.load_state_dict(from_jax.content_state_dict(v))
    net.train()
    got, _ = net(torch.from_numpy(b["aus"]), torch.from_numpy(b["fid"]))
    net64 = Audio2landmarkContent().double().train()
    net64.load_state_dict(from_jax.content_state_dict(v))
    g64, _ = net64(torch.from_numpy(b["aus"]).double(),
                   torch.from_numpy(b["fid"]).double())
    assert maxdiff(got.detach(), ref) <= 1e-4
    assert maxdiff(got.detach(), g64.detach()) <= 1.5 * maxdiff(
        ref, g64.detach())
    sd = from_jax.content_state_dict({"params": v["params"],
                                      "batch_stats": upd["batch_stats"]})
    for k, t in net.state_dict().items():
        if "running" in k:
            assert maxdiff(t, sd[k]) <= 1e-4 * float(sd[k].abs().max()), k


def test_laplacian_l1_matches_jax():
    from animateportrait_tpu.train.module1 import laplacian_l1
    rng = np.random.default_rng(2)
    a, b = (rng.standard_normal((5, 204)).astype(np.float32)
            for _ in range(2))
    ref = float(laplacian_l1(jnp.asarray(a), jnp.asarray(b)))
    got = float(tm1.laplacian_l1(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def _check_step(net, sd_of, new_params, new_stats, grads, loss_ref,
                loss_got, lr, grads_f64=None):
    """Loss within rtol 1e-4. Every gradient leaf to ``grad_parity``'s
    per-leaf bar with JAX's leaf as the reference: within 1e-3 of its
    scale of JAX's, or, given ``grads_f64`` (a float64 run of the port's
    step) and where JAX's own fp32 leaf is farther than 1e-3 from it, no
    farther from the float64 run than 3x JAX's distance; a bias whose
    gradient is 0 in exact arithmetic (``cancelled_biases``: rounding
    noise in both) within 1e-3 of the largest |g| of the tree. The
    parameters after the step within 2 lr + 1e-5 (Adam's first step moves
    each element by lr g / (|g| + eps), so an element whose gradient is
    noise may take either sign), and within 1e-5 where both gradients have
    one sign and |g| > 1e-5.
    The running statistics within 1e-4 of their scale."""
    np.testing.assert_allclose(float(loss_got), float(loss_ref), rtol=1e-4)
    g_ref = sd_of({"params": grads, "batch_stats": new_stats})
    g_got = module_grads(net)
    noise = cancelled_biases(net)
    errs = grad_parity(g_got, g_ref, grads_f64, noise)
    assert max(errs.values()) <= 1e-3, sorted(errs.items(),
                                              key=lambda kv: -kv[1])[:3]
    p_ref = sd_of({"params": new_params, "batch_stats": new_stats})
    got = net.state_dict()
    for k, r in p_ref.items():
        if "num_batches" in k:
            continue
        g = got[k].detach().cpu().numpy()
        r = r.numpy()
        if "running" in k:
            assert maxdiff(g, r) <= 1e-4 * np.max(np.abs(r)), k
            continue
        assert maxdiff(g, r) <= 2 * lr + 1e-5, k
        if k not in noise and k in g_got:     # (not a shared module's alias)
            gr, gg = g_ref[k].numpy(), g_got[k].detach().cpu().numpy()
            sure = (np.sign(gr) == np.sign(gg)) & (np.abs(gr) > 1e-5)
            if sure.any():
                assert maxdiff(g[sure], r[sure]) <= 1e-5, k


def test_content_step_matches_jax():
    from animateportrait_tpu.train.module1 import (
        ContentConfig, ContentTrainState, build_content_train_step)
    cfg = ContentConfig(lr=1e-3)
    v = _content_vars()
    state = ContentTrainState(step=jnp.zeros((), jnp.int32), variables=v,
                              opt=optax.adam(cfg.lr).init(v["params"]))
    b = _a2l_batch(2)
    s1, m = jax.jit(build_content_train_step(cfg))(
        state, jnp.asarray(b["fls"]), jnp.asarray(b["aus"]),
        jnp.asarray(b["fid"]))
    net = Audio2landmarkContent()
    net.load_state_dict(from_jax.content_state_dict(v))
    tr = tm1.ContentTrainer(tm1.ContentConfig(lr=1e-3), net, device="cpu")
    got = tr.step(*(torch.from_numpy(b[k]) for k in ("fls", "aus", "fid")))
    _check_step(net, from_jax.content_state_dict, s1.variables["params"],
                s1.variables["batch_stats"], adam_grads(s1.opt), m["loss"],
                got["loss"], cfg.lr)


def test_speaker_aware_step_matches_jax():
    from animateportrait_tpu.train.module1 import (
        SpeakerAwareConfig, SpeakerAwareTrainState,
        build_speaker_aware_train_step)
    cfg = SpeakerAwareConfig(lr=1e-3)
    v = _speaker_vars()
    state = SpeakerAwareTrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"],
        opt=optax.adam(cfg.lr).init(v["params"]))
    b = _a2l_batch(3)
    key = jax.random.key(4)
    names = ("aus", "embs", "fid", "gt", "quat", "trans")
    s1, m = jax.jit(build_speaker_aware_train_step(cfg))(
        state, *(jnp.asarray(b[k]) for k in names), key)
    z = _z_draw(v["params"], key, (T, 128))
    net = Audio2landmarkSpeakerAware()
    net.load_state_dict(from_jax.speaker_aware_state_dict(v))
    tr = tm1.SpeakerAwareTrainer(tm1.SpeakerAwareConfig(lr=1e-3), net,
                                 device="cpu")
    got = tr.step(*(torch.from_numpy(b[k]) for k in names),
                  z=torch.from_numpy(z))
    for k in ("reg", "lap", "pos"):
        np.testing.assert_allclose(float(got[k]), float(m[k]), rtol=1e-4)
    _check_step(net, from_jax.speaker_aware_state_dict, s1.params, {},
                adam_grads(s1.opt), m["loss"], got["loss"], cfg.lr)


# --- the datasets ---------------------------------------------------------

def _write_dumps(tmp_path, n_clips=5, gaze=False):
    rng = np.random.default_rng(9)
    fl, au, rt, rq, anc = [], [], [], [], []
    for i in range(n_clips):
        t = 22 + 3 * i
        name = f"{i:02d}_x_{('48uYS3bHIA8', 'other')[i % 2]}.mp4"
        fl.append((rng.standard_normal((t, 204)).astype(np.float32),
                   ("vid", name)))
        au.append((rng.standard_normal((t, 80)).astype(np.float32),
                   ("vid", name, rng.standard_normal(256).astype(np.float32))))
        rt.append(rng.standard_normal((t, 3, 4)).astype(np.float32))
        rq.append(rng.standard_normal((t, 4)).astype(np.float32))
        anc.append(rng.standard_normal((t, 68, 3)).astype(np.float32))
    for kind, obj in (("fl", fl), ("au", au)):
        with open(tmp_path / f"random_val_{kind}.pickle", "wb") as f:
            pickle.dump(obj, f)
    if gaze:
        with open(tmp_path / "random_val_gaze.pickle", "wb") as f:
            pickle.dump({"rot_trans": rt, "rot_quat": rq,
                         "anchor_t_shape": anc}, f)


def _same(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype and np.array_equal(a, b)
    else:
        assert a == b


def test_audio2landmark_dataset_matches_jax_exactly(tmp_path):
    from animateportrait_tpu.data import audio2landmark as ja
    from animateportrait_tpu_torch.data import audio2landmark as ta
    _write_dumps(tmp_path)
    j = ja.Audio2landmarkDataset(str(tmp_path))
    t = ta.Audio2landmarkDataset(str(tmp_path))
    assert len(j) == len(t)
    for i in range(len(j)):
        _same(t[i], j[i])
    _same(t.collate_in_segments([t[0], t[2]]),
          j.collate_in_segments([j[0], j[2]]))


@pytest.mark.parametrize("use_11spk_only", [False, True])
def test_speaker_aware_dataset_matches_jax_exactly(tmp_path, use_11spk_only):
    from animateportrait_tpu.data import audio2landmark as ja
    from animateportrait_tpu_torch.data import audio2landmark as ta
    _write_dumps(tmp_path, gaze=True)
    j = ja.SpeakerAwareDataset(str(tmp_path), use_11spk_only=use_11spk_only)
    t = ta.SpeakerAwareDataset(str(tmp_path), use_11spk_only=use_11spk_only)
    assert len(j) == len(t) == (3 if use_11spk_only else 5)
    for i in range(len(j)):
        _same(t[i], j[i])
    _same(t.collate_in_segments([t[i] for i in range(len(t))]),
          j.collate_in_segments([j[i] for i in range(len(j))]))


def test_gaze_registration_matches_jax():
    """estimate_neck and close_face_lip exactly; norm_output_fls_rot (ICP
    by SVD, float32 in JAX, float64 here) within 1e-4 and its quaternions
    in scipy's (x, y, z, w) order."""
    from animateportrait_tpu.data import audio2landmark as ja
    from animateportrait_tpu_torch.data import audio2landmark as ta
    from animateportrait_tpu.utils.assets import std_face_landmarks
    rng = np.random.default_rng(4)
    std = std_face_landmarks().reshape(68, 3)
    fl = np.stack([std + rng.normal(0, 0.01, std.shape) for _ in range(4)])
    fl[:, :, 2] += np.linspace(0, 0.05, 4)[:, None]
    _same(ta.estimate_neck(fl[0]), ja.estimate_neck(fl[0]))
    assert ta.close_face_lip(fl) == ja.close_face_lip(fl)
    _same(ta.default_anchor_t_shape(), ja.default_anchor_t_shape())
    ref = ja.norm_output_fls_rot(fl.reshape(4, 204))
    got = ta.norm_output_fls_rot(fl.reshape(4, 204))
    for g, r in zip(got, ref):
        assert g.shape == r.shape and maxdiff(g, r) <= 1e-4


@pytest.mark.parametrize("name", ["content", "speaker"])
def test_convergence_runner_matches_the_jax_tool(name, monkeypatch):
    """train/convergence.py's run at 3 steps from the JAX tool's initial
    weights (and, for the speaker branch, its z draws): the first loss
    within rtol 1e-4, the last within rtol 1e-2 (Adam's
    normalized steps move each near-zero, rounding-noise gradient element
    by +-lr, so three steps drift: the content run's last loss is 2.1e-3
    from JAX's and a float64 run of the port 2.6e-3 from the port's)."""
    from animateportrait_tpu_torch.train import convergence
    from torch_port_helpers import jax_tool_run
    (f, l), weights, z_of_step = jax_tool_run(name, 3, monkeypatch)
    got = convergence.run_all(3, "cpu", (name,), weights, z_of_step,
                              say=lambda m: None)
    assert len(got) == 1
    np.testing.assert_allclose(got[0][1], f, rtol=1e-4)
    np.testing.assert_allclose(got[0][2], l, rtol=1e-2)


def test_convergence_runner_refuses_the_runs_not_ported():
    """The runner takes all seven of the JAX tool's runs (face_of_art and
    FAN were refused by name before they were ported) and refuses any
    other name."""
    from animateportrait_tpu_torch.train import convergence
    assert convergence.RUNS == ("content", "speaker", "foa", "flow",
                                "imtrans", "pose", "fan")
    assert not hasattr(convergence, "NOT_PORTED")
    rows = convergence.run_all(1, "cpu", ("foa", "fan"), say=lambda m: None)
    assert [r[0] for r in rows] == ["face_of_art valid NME (argmax decode)",
                                    "FAN/AWing NME (argmax decode)"]
    with pytest.raises(ValueError, match="not one of"):
        convergence.run_all(1, "cpu", ("gan",))


def test_trainers_default_to_the_card():
    """Every ported trainer's entry point runs on the card unless the
    caller asks for the CPU, and refuses without one (never a silent CPU
    fall back)."""
    from animateportrait_tpu_torch.train import (
        face_of_art, fan, flow_regression, image_translation, pose_transfer)
    from animateportrait_tpu_torch.utils.device import DEFAULT_DEVICE
    import inspect
    for cls in (tm1.ContentTrainer, tm1.SpeakerAwareTrainer,
                flow_regression.FlowRegTrainer,
                image_translation.ImageTranslationTrainer,
                pose_transfer.PoseTransferTrainer, fan.FANTrainer,
                face_of_art.FOATrainer, face_of_art.train_foa):
        assert inspect.signature(cls).parameters["device"].default \
            == DEFAULT_DEVICE == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm1.ContentTrainer(tm1.ContentConfig(), Audio2landmarkContent())
