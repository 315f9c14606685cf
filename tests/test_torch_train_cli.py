"""The port's trainer against the JAX package's, on the CPU at the small
configuration (crop 64, load 72, ngf = ndf = 8, sources of 96^2):

- ``to_configs`` equal to the JAX one on every field the two configs share
  (the JAX ``compute_dtype`` being float32), for the readme's drawing and
  cartoon commands and four flag variants; the flags the port once refused
  (bf16, ``--data_parallel``, ``--multihost``) parse as the JAX CLI's;
- the slice as a whole: a dataset batch of a ``write_umlvd_tree`` tree (the
  ``tri_motion`` branch) through the port's ``grads`` and the JAX
  ``grads_fn``, with the port's weights carried into the JAX package by its
  own loaders and the JAX step traced with ``AP_IN_STATS=twopass``: losses
  within rtol 1e-4; with identity TPS warps (``slice_pair``), the
  landmark dot images jittered by 1e-3 and no geometry loss, gradient
  leaves within 1e-3 of their scale (as ``tests/test_torch_train.py``
  holds them); on the raw batch with every loss, the discriminators' so
  and the generator's within 5e-2, where a float64 run of the generator
  shows the port within 2e-5 and JAX's InstanceNorm off;
- ``visuals`` against ``visuals_fn``: images within 1e-4, the detected
  landmarks within 1e-3 px;
- ``remat`` grads equal to the plain step's within 1e-6 of each leaf's
  scale;
- ``train_cli.main`` for 2 steps with two loader worker processes, then
  ``--continue_train`` for 1: the options archive, ``loss_log.txt``,
  ``metrics.jsonl``, the gallery and the checkpoint steps.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax

from animateportrait_tpu.data import umlvd_ifw as jdata
from animateportrait_tpu.utils import options as joptions
from animateportrait_tpu_torch import train_cli
from animateportrait_tpu_torch.data import umlvd_ifw as tdata
from animateportrait_tpu_torch.train import module2 as m2
from animateportrait_tpu_torch.utils import options as toptions
from animateportrait_tpu_torch.utils.smoke import write_umlvd_tree
from test_torch_train import (KINK_LEAVES, KINK_RTOL, LEAF_RTOL, LOSS_TOL,
                              ZERO_LEAF_ATOL, _jax_cfg, _jax_side,
                              _port_named)
from torch_port_helpers import in_cancelled_biases, nhwc

README_DRAWING = (
    "--dataroot drawing --name training/drawing1 --model geomgm_ifw_fore "
    "--netG resnet_9blocks_rcatland32_full_ifw --netg_resb_div 3 "
    "--netg_resb_disp 3 --output_nc 1 --lr 0.00005 --lambda_geom 50 "
    "--lambda_geom_lipline 50 --more_weight_for_lip 2 --lambda_face 3.0 "
    "--lambda_warp_inter 10 --blendbg 1 --select_target12_thre 0.0 "
    "--niter 70 --niter_decay 0").split()
README_CARTOON = (
    "--dataroot cartoon --name training/cartoon1 --model "
    "geomgm_ifw_cartoon_fore --dataset_mode umlvd_ifw_cartoon --netG "
    "resnet_9blocks_rcatland32_full_ifw --netg_resb_div 3 "
    "--netg_resb_disp 3 --output_nc 3 --lr 0.00005 --lambda_geom 50 "
    "--lambda_face 3.0 --blendbg 1 --niter 70 --niter_decay 0").split()
VIS_ATOL = 1e-4
LM_ATOL = 1e-3          # px
REMAT_RTOL = 1e-6


@pytest.mark.parametrize("argv", [
    README_DRAWING, README_CARTOON, README_DRAWING + ["--direction", "BtoA"],
    README_DRAWING + ["--suffix", "{netG}_size{load_size}"],
    README_DRAWING + ["--batch_size", "1"],
    README_DRAWING + ["--batch_size", "4", "--remat", "1", "--face_recog_model",
                      "./checkpoints/senet50_ft.pkl"]],
    ids=["drawing", "cartoon", "BtoA", "suffix", "batch1", "batch4"])
def test_to_configs_match_jax(argv):
    jargs = joptions.build_train_argparser().parse_args(argv)
    targs = train_cli.build_argparser().parse_args(argv)
    jm, jd = joptions.to_configs(jargs)
    tm, td = toptions.to_configs(targs)
    assert jm.compute_dtype == "float32"
    shared = [f.name for f in dataclasses.fields(tm)
              if f.name in {g.name for g in dataclasses.fields(jm)}]
    assert len(shared) == len(dataclasses.fields(tm))
    for name in shared:
        assert getattr(tm, name) == getattr(jm, name), name
    assert dataclasses.asdict(td) == dataclasses.asdict(jd)
    assert targs.name == jargs.name
    assert (tm.use_senet, tm.face_crop_hw) == (jm.use_senet, jm.face_crop_hw)


@pytest.mark.parametrize("flag", [["--compute_dtype", "bfloat16"],
                                  ["--data_parallel", "2"],
                                  ["--multihost", "1"]])
def test_refused_flags_exit_with_their_name(tmp_path, flag, monkeypatch):
    """The flags the port once refused are accepted now and parse as the
    JAX CLI parses them: a bf16 step's config carries the dtype (the bf16
    trainer itself runs in tests/test_torch_bf16_train.py), and the
    multi-card flags (run in tests/test_torch_data_parallel.py) keep
    their values and the JAX defaults of the others."""
    from animateportrait_tpu import train_cli as jtrain_cli

    argv = ["--dataroot", str(tmp_path), "--device", "cpu", *flag]
    if flag[0] == "--multihost":
        argv += ["--coordinator_address", "127.0.0.1:1234",
                 "--num_processes", "2", "--process_id", "1"]
    targs = train_cli.build_argparser().parse_args(argv)
    m2cfg, _ = toptions.to_configs(targs)
    assert m2cfg.compute_dtype == ("bfloat16" if flag[1] == "bfloat16"
                                   else "float32")
    # the JAX CLI builds its parser inside main: stop it there
    import argparse

    parsed = {}

    def grab(self, args=None, namespace=None):
        parsed["args"] = self.parse_known_args(args)[0]
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(SystemExit):
        jtrain_cli.main([a for a in argv if a not in ("--device", "cpu")])
    monkeypatch.undo()
    jargs = parsed["args"]
    for k in ("data_parallel", "multihost", "coordinator_address",
              "num_processes", "process_id"):
        assert getattr(targs, k) == getattr(jargs, k), k


def test_cuda_device_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--dataroot", str(tmp_path)])


def _small_cfg(**kw):
    return m2.Module2Config(crop_size=64, output_nc=1, ngf=8, ndf=8,
                            steps_per_epoch=2, pool_size=4,
                            lambda_geom_lipline=50.0, **kw)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_umlvd_tree(str(tmp_path_factory.mktemp("umlvd")),
                            n_photos=3, n_styles=3, clips=1, frames=3,
                            size=96, seed=0, png_filter=4)


# the landmark dot images' values jittered by up to this much (the same on
# both sides) in the ``smooth`` run of ``slice_pair``
DOT_JITTER = 1e-3


def _jittered(jb: dict, tb: dict) -> tuple[dict, dict]:
    rng = np.random.default_rng(4)
    jj, tj = dict(jb), dict(tb)
    for k in ("A_lm", "tB_lm", "tB2_lm"):
        jj[k] = (jb[k] + rng.uniform(-DOT_JITTER, DOT_JITTER,
                                     jb[k].shape)).astype(np.float32)
        tj[k] = torch.from_numpy(np.ascontiguousarray(
            jj[k].transpose(0, 3, 1, 2)))
    return jj, tj


def _slice(tree, smooth=False, **data_kw):
    """One dataset batch (2 items, the ``tri_motion`` branch) through both
    packages' steps (``raw``); with ``smooth``, also the same batch with
    the dot images jittered by DOT_JITTER and without the geometry loss
    (``smooth``), and the visuals and the remat step of the raw batch."""
    import jax.numpy as jnp
    from animateportrait_tpu.train import module2 as j2

    kw = dict(root=tree, output_nc=1, load_size=72, crop_size=64, **data_kw)
    jb = jdata.UMLVDIFWDataset(jdata.DataConfig(**kw)).batch(
        [0, 2], np.random.default_rng(3), num_threads=2)
    tb = {k: torch.as_tensor(v) for k, v in tdata.UMLVDIFWDataset(
        tdata.DataConfig(**kw)).batch([0, 2], np.random.default_rng(3),
                                      num_threads=2).items()}
    assert "tri_motion" in tb and "warp_motion" not in tb
    cfg = _small_cfg()
    state = m2.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    frozen = m2.init_frozen_random(torch.Generator().manual_seed(1), "cpu")
    jstate, jfrozen, _ = _jax_side(cfg, state, frozen)
    runs = {"raw": (cfg, jb, tb)}
    if smooth:
        runs["smooth"] = (dataclasses.replace(cfg, lambda_geom=0.0),
                          *_jittered(jb, tb))
    out = dict(cfg=cfg, state=state)
    os.environ["AP_IN_STATS"] = "twopass"
    try:
        for name, (c, jbatch, tbatch) in runs.items():
            jstep = j2.build_train_step(_jax_cfg(c))
            jbatch = {k: jnp.asarray(v) for k, v in jbatch.items()}
            gg, dg, _, _, metrics = jax.jit(jstep.grads_fn)(
                jstate, jbatch, jfrozen, jax.random.key(1))
            out[name] = dict(jgrads=(gg, dg), grads=m2.build_train_step(
                c).grads(state, tbatch, frozen,
                         torch.Generator().manual_seed(1)),
                jmetrics={k: float(v) for k, v in metrics.items()})
            if smooth and name == "raw":
                jvis, jaux = jax.jit(jstep.visuals_fn)(jstate, jbatch,
                                                       jfrozen)
                out.update(jvis=jax.tree_util.tree_map(np.asarray, jvis),
                           jaux=jax.tree_util.tree_map(np.asarray, jaux))
    finally:
        del os.environ["AP_IN_STATS"]
    if smooth:
        out["remat"] = m2.build_train_step(dataclasses.replace(
            cfg, remat=True)).grads(state, tb, frozen,
                                    torch.Generator().manual_seed(1))
        out["vis"], out["aux"] = m2.build_train_step(cfg).visuals(
            state, tb, frozen)
    return out


@pytest.fixture(scope="module")
def slice_pair(tree):
    """The targets are each photo's own landmarks (``select_noniden_thre``
    0, ``max_offset`` 0), so every TPS warp of the step is the identity,
    which an fp32 solve gives exactly. On the warps between two faces the
    fp32 TPS solve is ill-conditioned: both packages' masks are 4-6e-3 off
    float64 at their edges, the fakes differ by up to ~2e-3, and the
    gradients by a few percent (``slice_losses`` holds the losses there)."""
    return _slice(tree, smooth=True, select_noniden_thre=0.0,
                  max_offset=0.0)


@pytest.fixture(scope="module")
def slice_losses(tree):
    """The default targets (another face's landmarks, offset)."""
    return _slice(tree)


def test_slice_losses_on_face_warps_match_jax(slice_losses):
    got = {k: float(v) for k, v in
           slice_losses["raw"]["grads"].metrics.items()}
    want = slice_losses["raw"]["jmetrics"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **LOSS_TOL)


def test_slice_losses_match_jax(slice_pair):
    for name in ("raw", "smooth"):
        got = {k: float(v) for k, v in
               slice_pair[name]["grads"].metrics.items()}
        want = slice_pair[name]["jmetrics"]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                       **LOSS_TOL)


def _leaf_errors(slice_pair, name, net):
    """Each gradient leaf's max |port - JAX| over its max |JAX|; the biases
    an InstanceNorm cancels are held to ZERO_LEAF_ATOL of the tree's
    largest |g| here and left out."""
    run = slice_pair[name]
    want = _port_named(slice_pair["cfg"], *run["jgrads"])[
        0 if net == "g" else 1]
    got = getattr(run["grads"], net)
    assert set(got) == set(want)
    zero = in_cancelled_biases(getattr(slice_pair["state"], net))
    gscale = max(float(w.abs().max()) for w in want.values())
    errs = {}
    for k, w in want.items():
        w = w.numpy().astype(np.float64)
        g = got[k].numpy().astype(np.float64)
        if k in zero:
            assert max(np.abs(w).max(), np.abs(g).max()) <= \
                ZERO_LEAF_ATOL * gscale, k
            continue
        errs[k] = np.abs(g - w).max() / np.abs(w).max()
    return errs


@pytest.mark.parametrize("net", ["g", "d"])
def test_slice_gradients_match_jax(slice_pair, net):
    """Every leaf within LEAF_RTOL of its scale (up to KINK_LEAVES past a
    ReLU kink, as ``tests/test_torch_train.py`` allows) on the ``smooth``
    run, and the discriminators' on the raw batch too. On the raw batch
    the generator's leaves part by up to ~1%, held here within KINK_RTOL:
    the JAX package's InstanceNorm misses float64 on the dot images
    (``test_generator_backward_on_dot_images_is_float64_accurate``), and
    the geometry loss's gradient follows the fp32 noise of its input
    through MobileFaceNet's PReLU kinks in either package."""
    errs = _leaf_errors(slice_pair, "smooth", net)
    over = {k: e for k, e in errs.items() if e > LEAF_RTOL}
    assert len(over) <= KINK_LEAVES and all(
        e <= KINK_RTOL for e in over.values()), over
    raw = _leaf_errors(slice_pair, "raw", net)
    if net == "d":
        over = {k: e for k, e in raw.items() if e > LEAF_RTOL}
        assert len(over) <= KINK_LEAVES, over
    assert max(raw.values()) <= KINK_RTOL, max(raw.items(),
                                                key=lambda kv: kv[1])


def test_generator_backward_on_dot_images_is_float64_accurate(tree):
    """The generator alone on a dataset batch's inputs, backward from a
    seeded cotangent: every leaf of the port within 2e-5 of its scale of a
    float64 run of the port, and the JAX package's worst leaf farther.
    The dot images' background is exactly -1, so mostly constant planes
    with |mean| many times their std meet the landmark encoder's
    InstanceNorms: JAX takes (x - mean) with an fp32 mean of thousands of
    equal values, whose rounding errors add up with one sign, and the
    port shifts by its mean twice."""
    import copy

    import jax.numpy as jnp
    from animateportrait_tpu.models.gan import TridentGeneratorFullIFW

    kw = dict(root=tree, output_nc=1, load_size=72, crop_size=64,
              select_noniden_thre=0.0, max_offset=0.0)
    tb = {k: torch.as_tensor(v) for k, v in tdata.UMLVDIFWDataset(
        tdata.DataConfig(**kw)).batch([0], np.random.default_rng(3)).items()}
    cfg = _small_cfg()
    state = m2.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    frozen = m2.init_frozen_random(torch.Generator().manual_seed(1), "cpu")
    jstate = _jax_side(cfg, state, frozen)[0]
    with torch.no_grad():
        sh = m2.build_train_step(cfg).forward_shared(tb, frozen)
    args = (sh["real_A_fore"], tb["A_lm"], tb["tB_lm"], sh["warp_motion"],
            sh["iw_flow"], sh["if_mask"])
    cot = torch.randn((1, 1, 64, 64),
                      generator=torch.Generator().manual_seed(5))
    names = [k for k, _ in state.g.named_parameters()]

    def port_grads(g, dtype):
        out = g(*(a.to(dtype) for a in args))
        return dict(zip(names, torch.autograd.grad(
            out, list(g.parameters()), cot.to(dtype))))

    ref = port_grads(copy.deepcopy(state.g).double(), torch.float64)
    mine = port_grads(state.g, torch.float32)
    jg = TridentGeneratorFullIFW(output_nc=1, ngf=cfg.ngf,
                                 div=cfg.netg_resb_div,
                                 disp=cfg.netg_resb_disp)
    jargs = [jnp.asarray(nhwc(a)) for a in args[:3]] + [
        jnp.asarray(args[3].numpy()), jnp.asarray(nhwc(args[4])),
        jnp.asarray(nhwc(args[5]))]
    os.environ["AP_IN_STATS"] = "twopass"
    try:
        _, vjp = jax.vjp(lambda p: jg.apply({"params": p}, *jargs),
                         jstate.g_params)
        (jgrads,) = vjp(jnp.asarray(nhwc(cot)))
    finally:
        del os.environ["AP_IN_STATS"]
    theirs = _port_named(cfg, jgrads, {})[0]
    zero = in_cancelled_biases(state.g)

    def worst(got):
        return max(float((got[k].double() - v).abs().max() / v.abs().max())
                   for k, v in ref.items() if k not in zero)

    assert worst(mine) <= 2e-5
    assert worst(theirs) > worst(mine)


def test_visuals_match_jax(slice_pair):
    vis, aux = slice_pair["vis"], slice_pair["aux"]
    jvis, jaux = slice_pair["jvis"], slice_pair["jaux"]
    assert set(vis) == set(jvis) and set(aux) == set(jaux)
    for k, v in vis.items():
        np.testing.assert_allclose(nhwc(v), jvis[k], atol=VIS_ATOL, err_msg=k)
    for k, v in aux.items():
        np.testing.assert_allclose(v.numpy(), jaux[k], atol=LM_ATOL,
                                   err_msg=k)
    # the fakes are those of the gradient pass
    assert torch.equal(vis["fake_B"], slice_pair["raw"]["grads"].pool[0:2])


@pytest.mark.parametrize("net", ["g", "d"])
def test_remat_grads_equal_the_plain_step(slice_pair, net):
    ref = getattr(slice_pair["raw"]["grads"], net)
    got = getattr(slice_pair["remat"], net)
    gscale = max(float(v.abs().max()) for v in ref.values())
    zero = in_cancelled_biases(getattr(slice_pair["state"], net))
    for k, v in ref.items():
        scale = gscale if k in zero else float(v.abs().max())
        assert float((got[k] - v).abs().max()) <= REMAT_RTOL * scale, k
    for k, v in slice_pair["raw"]["grads"].metrics.items():
        assert float(slice_pair["remat"].metrics[k]) == float(v), k


def test_train_cli_trains_logs_saves_and_resumes(tree, tmp_path, capsys):
    ck = str(tmp_path / "ck")
    argv = ["--dataroot", tree, "--checkpoints_dir", ck, "--name", "smoke",
            "--output_nc", "1", "--ngf", "8", "--ndf", "8", "--load_size",
            "72", "--crop_size", "64", "--batch_size", "2",
            "--num_threads", "2", "--pool_size", "4", "--niter", "1",
            "--niter_decay", "0", "--steps_per_epoch", "4",
            "--print_freq", "1", "--display_freq", "2",
            "--update_html_freq", "2", "--save_latest_freq", "1",
            "--save_by_iter", "--frozen_dir", str(tmp_path / "none"),
            "--device", "cpu"]
    run = train_cli.main(argv + ["--max_steps", "2", "--verbose"])
    out = capsys.readouterr()
    assert "[verbose] G params" in out.out and "D[d_a_coh]" in out.out
    assert out.err.count("missing frozen ckpt") == 4
    assert run.state.step == 2 and run.resumed_from is None
    assert [r.step for r in run.records] == [1, 2]
    run2 = train_cli.main(argv + ["--max_steps", "3", "--continue_train"])
    assert run2.resumed_from == 2 and run2.state.step == 3
    exp = os.path.join(ck, "smoke")
    opts = open(os.path.join(exp, "train_opt.txt")).read()
    assert "batch_size: 2" in opts and "continue_train: True" in opts
    log = open(os.path.join(exp, "loss_log.txt")).read()
    assert log.count("Training Loss") == 2
    for i in (1, 2, 3):
        assert f"(epoch: 1, iters: {i}," in log
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["iters"] for r in rows] == [1, 2, 3]
    assert all(np.isfinite(v) for r in rows for v in r.values())
    images = os.listdir(os.path.join(exp, "web", "images"))
    assert len(images) == 11 and all("iter0000002" in f for f in images)
    assert "iters [2]" in open(os.path.join(exp, "web", "index.html")).read()
    ckdir = os.path.join(exp, "checkpoints")
    assert sorted(os.listdir(ckdir)) == ["2.pt", "3.pt", "iters", "latest"]
    assert os.listdir(os.path.join(ckdir, "latest")) == ["3.pt"]
    assert sorted(os.listdir(os.path.join(ckdir, "iters"))) == [
        "1.pt", "2.pt", "3.pt"]
