"""The port's Module2 GAN convergence run (``train/gan_convergence.py``) and
its stand-in frozen nets (``train/standin_frozen.py``) against the JAX
package's ``tools/overfit_convergence.py`` and
``tools/train_standin_frozen.py``, on the CPU.

- The data: the landmark generators and every numpy draw are the JAX
  tools' (landmarks, windows, labels and the generator's state after a
  set: bit-equal). The constructed tree has the JAX tool's files; its
  landmark texts are byte-equal, and the dots and part masks (OpenCV's
  8-connected fills, which the port draws exactly) byte-equal; its
  photos and drawings, which the JAX tool anti-aliases and the port does
  not, differ on a few percent of the pixels (the edges).
- One MobileFaceNet step through ``extract_landmarks`` and one Sphere20a
  step through ``crop_head_bbox`` on the same weights and batch as JAX's
  loss functions: losses within rtol 1e-4; the gradients of the float64
  steps (JAX's under ``enable_x64``; Sphere20a's on one float64 crop)
  within 1e-4 of each leaf's scale, and
  the port's fp32 leaves within 5e-2 of float64 (fp32 kinks; the measured
  numbers are in ``_check_grads``).
- The stand-ins' flax variable trees equal the JAX package's
  ``load_*_params`` of the same state dicts, round-trip through
  ``io/from_jax.py``, and ``io/reference.py:load_frozen`` takes them.
- ``summarize`` writes the JAX tool's table on a seeded loss log.

The stand-ins' training and a resumed CPU run of the GAN are in
``tests/test_torch_gan_convergence_run.py`` (split off so that the two
halves run on two workers).
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from animateportrait_tpu_torch.io import from_jax, to_flax
from animateportrait_tpu_torch.train import gan_convergence as tgc
from animateportrait_tpu_torch.train import standin_frozen as tsf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import overfit_convergence as jgc  # noqa: E402
import train_standin_frozen as jsf  # noqa: E402


def test_landmark_generators_are_the_jax_tools():
    for seed in range(4):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        for mouth in (1.0, 5.5, 9.0):
            np.testing.assert_array_equal(tgc._face_landmarks(a, 300, mouth),
                                          jgc._face_landmarks(b, 300, mouth))
        ident = tsf._identity_landmarks(np.random.default_rng(seed), 300)
        np.testing.assert_array_equal(
            ident, jsf._identity_landmarks(np.random.default_rng(seed), 300))
        np.testing.assert_array_equal(tsf._vary(ident, a, 300),
                                      jsf._vary(ident, b, 300))
        assert a.bit_generator.state == b.bit_generator.state
    _, lms, wins = tsf.build_landmark_set(12, 3)
    _, jlms, jwins = jsf.build_landmark_set(12, 3)
    np.testing.assert_array_equal(lms, jlms)
    np.testing.assert_array_equal(wins, jwins)
    _, wins, labels = tsf.build_identity_set(3, 4, 1)
    _, jwins, jlabels = jsf.build_identity_set(3, 4, 1)
    np.testing.assert_array_equal(wins, jwins)
    np.testing.assert_array_equal(labels, jlabels)


def test_constructed_tree_matches_the_jax_tool(tmp_path):
    import cv2
    roots = {k: str(tmp_path / k) for k in ("port", "jax")}
    tgc.build_dataset(roots["port"], n_a=2, n_b=2, n_clip=3)
    jgc.build_dataset(roots["jax"], n_a=2, n_b=2, n_clip=3)

    def files(r):
        return sorted(os.path.relpath(os.path.join(d, f), r)
                      for d, _, fs in os.walk(r) for f in fs)

    names = files(roots["port"])
    assert names == files(roots["jax"]) and len(names) == 47
    for name in names:
        a, b = (os.path.join(roots[k], name) for k in ("port", "jax"))
        if name.endswith(".txt"):
            with open(a) as fa, open(b) as fb:
                assert fa.read() == fb.read(), name
            continue
        x = cv2.imread(a, cv2.IMREAD_UNCHANGED)
        y = cv2.imread(b, cv2.IMREAD_UNCHANGED)
        assert x.shape == y.shape, name
        kind = name.split("/")[0]
        if kind in ("Alm", "Blm", "Amask", "Bmask"):
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            # anti-aliased edges in the JAX tool's drawings and photos
            assert np.count_nonzero(x != y) <= 0.05 * x.size, name


def _jax_tree(x):
    return jax.tree_util.tree_map(jnp.asarray, x)


def _check_grads(net, loss64, jax_grads64, key=None):
    """The step's gradients in float64, the port's (``loss64`` of a float64
    copy of ``net``) against JAX's (``jax_grads64``, under
    ``enable_x64``): every leaf within 1e-4 of its scale, so the two
    backward passes are one function (measured: 1.6e-5, the float32 of
    ``io/from_jax.py``'s conversion). The port's fp32 leaves within 5e-2
    of the float64 ones: both steps are ill-conditioned in fp32 at these
    random weights. Measured with torch's default thread count:
    MobileFaceNet 1.36e-3 (a depthwise block's BatchNorm bias; torch's
    CPU sums), Sphere20a 2.1e-2 at conv3_9, where one input of relu3_9 at
    6.6e-7 takes the other side of the PReLU's kink in fp32."""
    import copy

    net64 = copy.deepcopy(net).double()
    for p in net64.parameters():
        p.grad = None
    loss64(net64).backward()
    grads64 = dict(net64.named_parameters())
    for k, p in net.named_parameters():
        g64 = grads64[k].grad.numpy()
        scale = np.abs(g64).max()
        jax64 = np.asarray(jax_grads64[k])
        assert np.abs(jax64 - g64).max() <= 1e-4 * scale, k
        assert np.abs(p.grad.numpy() - g64).max() <= 5e-2 * scale, k


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def test_mobilefacenet_step_matches_jax():
    from animateportrait_tpu.train.module2 import extract_landmarks as jel
    from animateportrait_tpu_torch.train.module2 import extract_landmarks

    imgs, lms, wins = tsf.build_landmark_set(4, 0)
    net = tsf.init_mobilefacenet(0, "cpu")
    variables = to_flax.mobilefacenet_variables(net.state_dict())
    loss = tsf.mfn_loss(net, torch.as_tensor(imgs), torch.as_tensor(lms),
                        torch.as_tensor(wins))
    loss.backward()

    def jloss(p, stats, dtype):
        img = jnp.asarray(imgs, dtype)[..., None] / 127.5 - 1.0
        pred = jel({"params": p, "batch_stats": stats}, img,
                   jnp.asarray(wins), 256)
        return jnp.mean(jnp.square((pred - jnp.asarray(lms, dtype)) / 256))

    jl = jloss(_jax_tree(variables["params"]),
               _jax_tree(variables["batch_stats"]), jnp.float32)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-4)
    with jax.enable_x64(True):
        jg = jax.grad(jloss)(_f64(variables["params"]),
                             _f64(variables["batch_stats"]), jnp.float64)
        jg = jax.tree_util.tree_map(np.asarray, jg)

    def loss64(net64):
        img = torch.as_tensor(imgs, dtype=torch.float64)[:, None] / 127.5 - 1
        pred = extract_landmarks(net64, img, torch.as_tensor(wins))
        return torch.mean(torch.square((pred - torch.as_tensor(
            lms, dtype=torch.float64)) / 256))

    _check_grads(net, loss64, from_jax.mobilefacenet_state_dict(
        {"params": jg, "batch_stats": variables["batch_stats"]}))


def test_sphere_step_matches_jax():
    import optax
    from animateportrait_tpu.models.perception import (
        Sphere20a, crop_head_bbox)
    from animateportrait_tpu_torch.models.perception import (
        crop_head_bbox as crop_head_bbox_t)

    imgs, wins, labels = tsf.build_identity_set(2, 3, 0)
    net, head = tsf.init_sphere(2, 0, "cpu")
    loss = tsf.sphere_loss(net, head, torch.as_tensor(imgs),
                           torch.as_tensor(wins), torch.as_tensor(labels))
    loss.backward()
    variables = to_flax.sphere20a_variables(net.state_dict())
    w0 = head.detach().numpy()

    def jloss(pw, crops):
        p, w = pw
        feats = Sphere20a().apply({"params": p}, crops)
        f = feats[4] / (jnp.linalg.norm(feats[4], axis=-1,
                                        keepdims=True) + 1e-6)
        wn = w / (jnp.linalg.norm(w, axis=0, keepdims=True) + 1e-6)
        ce = optax.softmax_cross_entropy_with_integer_labels(
            16.0 * (f @ wn), jnp.asarray(labels)).mean()
        fs = sum(jnp.square(jnp.log(jnp.sqrt(jnp.mean(jnp.square(x))
                                              + 1e-12))) for x in feats)
        return ce + 0.05 * fs

    img = jnp.asarray(imgs, jnp.float32)[..., None] / 127.5 - 1.0
    jl = jloss((_jax_tree(variables["params"]), jnp.asarray(w0)),
               crop_head_bbox(jnp.repeat(img, 3, -1), jnp.asarray(wins)))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-4)
    # the float64 steps on one float64 crop: the sample grid is float32 in
    # the port and float64 in JAX under x64, and relu3_9 has an input at
    # 6.6e-7 that the 1e-8 px between them moves
    img64 = torch.as_tensor(imgs, dtype=torch.float64)[:, None] / 127.5 - 1
    crops64 = crop_head_bbox_t(img64.repeat(1, 3, 1, 1),
                               torch.as_tensor(wins))
    with jax.enable_x64(True):
        jg, jgw = jax.grad(jloss)(
            (_f64(variables["params"]), _f64(w0)),
            jnp.asarray(crops64.permute(0, 2, 3, 1).numpy()))
        jg = jax.tree_util.tree_map(np.asarray, jg)
        jgw = np.asarray(jgw)
    head64 = head.detach().double().requires_grad_(True)

    def loss64(net64):
        feats = net64(crops64)
        ce = torch.nn.functional.cross_entropy(
            tsf.cos_logits(feats[4], head64), torch.as_tensor(labels).long())
        return ce + 0.05 * sum(torch.square(torch.log(torch.sqrt(
            torch.mean(torch.square(f)) + 1e-12))) for f in feats)

    _check_grads(net, loss64, from_jax.sphere20a_state_dict({"params": jg}))
    g64 = head64.grad.numpy()
    scale = np.abs(g64).max()
    assert np.abs(jgw - g64).max() <= 1e-4 * scale
    assert np.abs(head.grad.numpy() - g64).max() <= 5e-2 * scale


def test_flax_variables_are_the_jax_loaders_and_load_frozen(tmp_path,
                                                            capsys):
    from animateportrait_tpu.models.perception import (
        load_mobilefacenet_params, load_sphere20a_params)
    from animateportrait_tpu_torch.io.checkpoint import save_flax_npz
    from animateportrait_tpu_torch.io.reference import load_frozen
    from animateportrait_tpu_torch.train import module2 as m2

    mfn = tsf.init_mobilefacenet(1, "cpu")
    sphere, _ = tsf.init_sphere(3, 1, "cpu")
    for net, ours, theirs, back, role in (
            (mfn, to_flax.mobilefacenet_variables, load_mobilefacenet_params,
             from_jax.mobilefacenet_state_dict, "mobilefacenet"),
            (sphere, to_flax.sphere20a_variables, load_sphere20a_params,
             from_jax.sphere20a_state_dict, "sphere")):
        sd = net.state_dict()
        got = ours(sd)
        want = theirs({k: v.numpy() for k, v in sd.items()})
        flat = jax.tree_util.tree_flatten_with_path
        (g, gt), (w, wt) = flat(got), flat(want)
        assert gt == wt
        for (_, a), (_, b) in zip(g, w):
            np.testing.assert_array_equal(a, b)
        for k, v in back(got).items():
            assert torch.equal(v, sd[k]), k
        save_flax_npz(str(tmp_path / f"{role}.flax.npz"), got)
    cfg = m2.Module2Config(crop_size=64, ngf=8, ndf=8)
    frozen = load_frozen(str(tmp_path), cfg, torch.Generator().manual_seed(0),
                         "cpu")
    out = capsys.readouterr().out
    assert "frozen mobilefacenet: native" in out
    assert "frozen sphere: native" in out
    for a, b in ((frozen.mobilefacenet, mfn), (frozen.sphere, sphere)):
        for (k, x), (_, y) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(x, y), k


def test_summarize_writes_the_jax_tools_table(tmp_path, capsys):
    rng = np.random.default_rng(0)
    log = tmp_path / "ck" / "overfit" / "metrics.jsonl"
    os.makedirs(log.parent)
    with open(log, "w") as f:
        for i in range(30):
            row = {"epoch": 1 + i // 10, "iters": i + 1,
                   "G_A": float(rng.uniform(1, 2)), "D_A": 0.5 - 0.01 * i,
                   "warp_B": 1.0 - 0.02 * i, "geom_B": 0.3 - 0.005 * i,
                   "iden_B": float(rng.uniform(8, 10))}
            f.write(json.dumps(row) + "\n")
    ours = tgc.summarize(str(tmp_path / "ck"), str(tmp_path / "port.md"))
    theirs = jgc.summarize(str(tmp_path / "ck"), str(tmp_path / "jax.md"))
    assert ours == theirs
    with open(tmp_path / "port.md") as a, open(tmp_path / "jax.md") as b:
        assert a.read() == b.read()
    with open(log, "a") as f:
        f.write(json.dumps(dict(row, iters=31, warp_B=5.0)) + "\n")
    for mod in (tgc, jgc):
        with pytest.raises(AssertionError, match="warp_B rose"):
            mod.summarize(str(tmp_path / "ck"), str(tmp_path / "x.md"),
                          window=1)
