"""The pose-transfer trainer of the PyTorch port against the JAX package:
the residual Unets of flowunet_extra (DualUnet with each visibility mode,
the Unet, its multi-output variant) and the BatchNorm PatchGAN in both
modes with their weights' round trips, pixel_shuffle's channel order,
the GAN and VGG losses (the JAX package's torch-oracle bars), SSIM and
PSNR, and one train step (G or netPW, and D) and one test step. Bounds
are stated per test."""
import copy
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from animateportrait_tpu_torch.io import from_jax
from animateportrait_tpu_torch.models import flowunet_extra as tfe
from animateportrait_tpu_torch.models.flowunet import FlowUnet
from animateportrait_tpu_torch.models.image_translation import Vgg19Features
from animateportrait_tpu_torch.train import pose_transfer as tpt
from animateportrait_tpu_torch.utils import metrics as tmet
from test_torch_module1 import _check_step
from torch_port_helpers import (
    adam_grads, assert_as_exact_as_jax, f64_run, maxdiff, module_grads,
    nchw, nhwc, port_stats_match, random_jax_variables)

K = jax.random.key(0)


def test_pixel_shuffle_channel_order_is_torchs():
    from animateportrait_tpu.models.flowunet_extra import pixel_shuffle
    x = np.random.default_rng(0).standard_normal((2, 3, 5, 12)).astype(
        np.float32)
    assert np.array_equal(nhwc(F.pixel_shuffle(nchw(x), 2)),
                          np.asarray(pixel_shuffle(jnp.asarray(x), 2)))


def _run(jm, v, tm, args_nhwc, train, sd_of):
    """The JAX module and the port's on the same inputs, in eval or
    training mode: (port output, JAX output, float64 port output, the
    JAX statistics after a training pass as a state dict)."""
    j_args = [None if a is None else jnp.asarray(a) for a in args_nhwc]
    t_args = [None if a is None else nchw(a) for a in args_nhwc]
    f64 = f64_run(tm, *t_args, train=train) if train else None
    if train:
        ref, upd = jm.apply(v, *j_args, train=True, mutable=["batch_stats"])
        upd = sd_of({"params": v["params"],
                     "batch_stats": upd["batch_stats"]})
    else:
        ref, upd = jm.apply(v, *j_args), None
    got = tm.train(train)(*t_args)
    return got, ref, f64, upd


def _flow_vis(rng, n, s):
    flow = rng.uniform(-3, 3, (n, s, s, 2)).astype(np.float32)
    vis = rng.integers(0, 3, (n, s, s, 1)).astype(np.float32)
    return flow, vis


@pytest.mark.parametrize("vis_mode", ["none", "hard_gate", "soft_gate",
                                      "residual", "res_no_vis"])
@pytest.mark.parametrize("train", [False, True])
def test_dual_unet_matches_jax_and_round_trips(vis_mode, train):
    """DualUnet (nf 8, max 16, 3 scales, 2 warp scales, 6 pose channels,
    32^2, batch 2) with a flow and visibility: every key written (the
    shared downsamples under both names); the output within 1e-4
    (``assert_as_exact_as_jax`` in training mode); the statistics within
    1e-4 of their scale."""
    from animateportrait_tpu.models.flowunet_extra import DualUnetGenerator
    kw = dict(pose_nc=6, nf=8, max_nf=16, num_scales=3, num_warp_scales=2,
              vis_mode=vis_mode)
    jm = DualUnetGenerator(**kw)
    v = random_jax_variables(lambda: jm.init(
        K, jnp.zeros((1, 32, 32, 6)), jnp.zeros((1, 32, 32, 3)),
        jnp.zeros((1, 32, 32, 2)), jnp.zeros((1, 32, 32, 1))), seed=9)

    def sd_of(tree):
        return from_jax.dual_unet_state_dict(
            tree, num_scales=3, num_warp_scales=2, vis_mode=vis_mode)
    sd = sd_of(v)
    tm = tfe.DualUnetGenerator(**kw)
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    rng = np.random.default_rng(10)
    xp = rng.standard_normal((2, 32, 32, 6)).astype(np.float32)
    xa = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    got, ref, f64, upd = _run(jm, v, tm, (xp, xa, *_flow_vis(rng, 2, 32)),
                              train, sd_of)
    if train:
        assert_as_exact_as_jax(nhwc(got), ref, nhwc(f64), 1e-4)
        port_stats_match(tm, upd)
    else:
        assert maxdiff(nhwc(got), ref) <= 1e-4


@pytest.mark.parametrize("multi", [(), (1, 2)])
@pytest.mark.parametrize("train", [False, True])
def test_if_unet_matches_jax_and_round_trips(multi, train):
    """The Unet (slope 0.1) and its multi-output variant (nf 8, max 16, 3
    scales, 5 input channels, 32^2, batch 2): as the DualUnet test."""
    from animateportrait_tpu.models.flowunet_extra import (
        IFUnetGenerator, IFUnetGeneratorMultiOutput)
    kw = dict(nf=8, max_nf=16, num_scales=3, slope=0.1)
    jm = IFUnetGeneratorMultiOutput(output_nc=multi, **kw) if multi \
        else IFUnetGenerator(**kw)
    v = random_jax_variables(lambda: jm.init(K, jnp.zeros((1, 32, 32, 5))),
                             seed=11)

    def sd_of(tree):
        return from_jax.if_unet_state_dict(tree, num_scales=3,
                                           multi_output_nc=multi)
    sd = sd_of(v)
    tm = tfe.IFUnetGenerator(5, multi_output_nc=multi, **kw)
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    x = np.random.default_rng(12).standard_normal((2, 32, 32, 5)).astype(
        np.float32)
    got, ref, f64, upd = _run(jm, v, tm, (x,), train, sd_of)
    outs = list(zip(got, ref, f64 if train else got)) if multi \
        else [(got, ref, f64)]
    for g, r, d in outs:
        if train:
            assert_as_exact_as_jax(nhwc(g), r, nhwc(d), 1e-4)
        else:
            assert maxdiff(nhwc(g), r) <= 1e-4
    if train:
        port_stats_match(tm, upd)


@pytest.mark.parametrize("use_sigmoid", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_bn_patch_discriminator_matches_jax(use_sigmoid, train):
    """ndf 8, 2 layers, 10 input channels, 32^2, batch 2: the output
    within 1e-5 (``assert_as_exact_as_jax`` in training mode), every key
    written, the statistics within 1e-4 of their scale."""
    from animateportrait_tpu.train.pose_transfer import BNPatchDiscriminator
    jm = BNPatchDiscriminator(ndf=8, n_layers=2, use_sigmoid=use_sigmoid)
    v = random_jax_variables(lambda: jm.init(K, jnp.zeros((1, 32, 32, 10))),
                             seed=13)

    def sd_of(tree):
        return from_jax.bn_patch_d_state_dict(tree, n_layers=2)
    tm = tpt.BNPatchDiscriminator(10, ndf=8, n_layers=2,
                                  use_sigmoid=use_sigmoid)
    sd = sd_of(v)
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    x = np.random.default_rng(14).standard_normal((2, 32, 32, 10)).astype(
        np.float32)
    got, ref, f64, upd = _run(jm, v, tm, (x,), train, sd_of)
    if train:
        assert_as_exact_as_jax(nhwc(got), ref, nhwc(f64), 1e-5)
        port_stats_match(tm, upd)
    else:
        assert maxdiff(nhwc(got), ref) <= 1e-5


def test_gan_and_vgg_losses_match_jax():
    """gan_loss (lsgan, dcgan) within 1e-6; pt_vgg_loss content, style and
    shifted style within rtol 1e-4 (tests/test_pose_transfer.py's
    bars)."""
    from animateportrait_tpu.models.image_translation import Vgg19Features \
        as JV
    from animateportrait_tpu.train import pose_transfer as jpt
    rng = np.random.default_rng(15)
    p = rng.uniform(0.05, 0.95, (2, 1, 3, 3)).astype(np.float32)
    for gt in ("lsgan", "dcgan"):
        for real in (True, False):
            assert abs(float(tpt.gan_loss(torch.from_numpy(p), real, gt))
                       - float(jpt.gan_loss(jnp.asarray(p), real, gt))) \
                <= 1e-6
    v = random_jax_variables(lambda: JV().init(K, jnp.zeros((1, 64, 64, 3))),
                             seed=16)
    vgg = Vgg19Features()
    vgg.load_state_dict(from_jax.vgg19_state_dict(v))
    x, y = (rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
            for _ in range(2))
    for lt, shifted in (("content", False), ("style", False),
                        ("style", True)):
        ref = jpt.pt_vgg_loss(v, jnp.asarray(x), jnp.asarray(y), lt, shifted)
        got = tpt.pt_vgg_loss(vgg, nchw(x), nchw(y), lt, shifted)
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-4)


def test_ssim_and_psnr_match_jax():
    """ssim, ssim_ref (with and without a mask) and psnr_ref within
    1e-5."""
    from animateportrait_tpu.utils import metrics as jmet
    rng = np.random.default_rng(17)
    a = rng.uniform(-1, 1, (3, 32, 24, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), -1, 1).astype(np.float32)
    mask = (rng.random((3, 32, 24, 1)) > 0.2).astype(np.float32)
    u8 = (rng.random((3, 32, 24, 3)) * 255).round().astype(np.float32)
    assert maxdiff(tmet.ssim(nchw(u8), nchw(u8[::-1].copy())),
                   jmet.ssim(jnp.asarray(u8), jnp.asarray(u8[::-1]))) <= 1e-5
    for m in (None, mask):
        ref = jmet.ssim_ref(jnp.asarray(a), jnp.asarray(b),
                            None if m is None else jnp.asarray(m))
        got = tmet.ssim_ref(nchw(a), nchw(b), None if m is None else nchw(m))
        assert abs(float(got) - float(ref)) <= 1e-5
    assert abs(float(tmet.psnr_ref(nchw(a), nchw(b)))
               - float(jmet.psnr_ref(jnp.asarray(a), jnp.asarray(b)))) <= 1e-5


# --- the train and test steps ---------------------------------------------

def _small_cfg(jpt, **kw):
    """The JAX convergence tool's widths."""
    return jpt.PoseTransferConfig(G_nf=8, G_max_nf=32, G_n_scale=3,
                                  G_n_warp_scale=2, joint_nc=6, size=32,
                                  D_nf=8, D_n_layers=2, lr=1e-3, **kw)


def _jax_state(jpt, cfg):
    """A PTTrainState of seeded random variables (init_pt_state's trees
    without its eager init)."""
    from animateportrait_tpu.models.flowunet import FlowUnet as JF
    from animateportrait_tpu.models.image_translation import Vgg19Features \
        as JV
    s, j = cfg.size, cfg.joint_nc
    img, jmap = jnp.zeros((1, s, s, 3)), jnp.zeros((1, s, s, j))
    gm = jpt._build_g(cfg)
    if cfg.which_model_G == "dual_unet":
        g = random_jax_variables(lambda: gm.init(
            K, jmap, img, jnp.zeros((1, s, s, 2)), jnp.zeros((1, s, s, 1))),
            seed=20)
    else:
        g = random_jax_variables(lambda: gm.init(
            K, jnp.concatenate([img, jmap], -1)), seed=20)
    pw = random_jax_variables(lambda: jpt._build_pw(cfg).init(
        K, jnp.zeros((1, s, s, 9))), seed=21) if cfg.G_pix_warp else None
    d = random_jax_variables(lambda: jpt.BNPatchDiscriminator(
        ndf=cfg.D_nf, n_layers=cfg.D_n_layers).init(
        K, jnp.zeros((1, s, s, 6 + j))), seed=22)
    # a flow net whose flow is a few pixels and whose visibility varies
    netf = random_jax_variables(lambda: JF().init(
        K, jnp.zeros((1, s, s, 2 * j))), seed=23)
    vgg = random_jax_variables(lambda: JV().init(K, img), seed=24)
    tx_g = jpt._torch_adam(cfg.lr, cfg.beta1, cfg.beta2, cfg.weight_decay)
    tx_d = jpt._torch_adam(cfg.lr_D, cfg.beta1, cfg.beta2,
                           cfg.weight_decay_D)
    trained = pw["params"] if cfg.G_pix_warp else g["params"]
    return jpt.PTTrainState(step=jnp.zeros((), jnp.int32), g=g, pw=pw, d=d,
                            netf=netf, vgg=vgg, opt_g=tx_g.init(trained),
                            opt_d=tx_d.init(d["params"]))


def _g_sd(cfg):
    if cfg.which_model_G == "dual_unet":
        return lambda t: from_jax.dual_unet_state_dict(
            t, num_scales=cfg.G_n_scale, num_warp_scales=cfg.G_n_warp_scale,
            vis_mode=cfg.G_vis_mode)
    return lambda t: from_jax.if_unet_state_dict(t, num_scales=cfg.G_n_scale)


def _pw_sd(cfg):
    return lambda t: from_jax.if_unet_state_dict(
        t, num_scales=cfg.G_n_scale, multi_output_nc=(1,))


def _port_trainer(state, cfg, device="cpu"):
    tcfg = tpt.PoseTransferConfig(**{
        f.name: getattr(cfg, f.name)
        for f in tpt.PoseTransferConfig.__dataclass_fields__.values()})
    g = tpt.build_g(tcfg)
    g.load_state_dict(_g_sd(cfg)(state.g))
    pw = None
    if cfg.G_pix_warp:
        pw = tpt.build_pw(tcfg)
        pw.load_state_dict(_pw_sd(cfg)(state.pw))
    d = tpt.build_d(tcfg)
    d.load_state_dict(from_jax.bn_patch_d_state_dict(
        state.d, n_layers=cfg.D_n_layers))
    netf = FlowUnet(input_nc=2 * cfg.joint_nc)
    netf.load_state_dict(from_jax.flowunet_state_dict(state.netf))
    vgg = Vgg19Features()
    vgg.load_state_dict(from_jax.vgg19_state_dict(state.vgg))
    return tpt.PoseTransferTrainer(tcfg, g, netf, vgg, d=d, pw=pw,
                                   device=device)


def _pt_batch(cfg, seed=25):
    rng = np.random.default_rng(seed)
    n, s, j = 2, cfg.size, cfg.joint_nc
    b = {"img_1": rng.uniform(-1, 1, (n, s, s, 3)).astype(np.float32),
         "img_2": rng.uniform(-1, 1, (n, s, s, 3)).astype(np.float32),
         "kp_1": rng.uniform(4, s - 4, (n, j, 2)).astype(np.float32)}
    b["kp_2"] = (b["kp_1"] + rng.uniform(-3, 3, (n, j, 2))).astype(
        np.float32)
    port = {k: nchw(v) if v.ndim == 4 else torch.from_numpy(v)
            for k, v in b.items()}
    return {k: jnp.asarray(v) for k, v in b.items()}, port


@pytest.mark.parametrize("variant", [
    {}, {"G_pix_warp": True}, {"which_model_G": "unet",
                               "G_activation": "leaky_relu",
                               "loss_weight_style": 1.0,
                               "shifted_style_loss": True}])
def test_pose_transfer_step_matches_jax(variant):
    """One step at the convergence tool's widths (batch 2): every metric
    within rtol 1e-4; G's (or netPW's) and D's gradients, parameters and
    statistics after the step to _check_step's bars (D's gradients
    without its L2 term, which torch's Adam adds itself)."""
    from animateportrait_tpu.train import pose_transfer as jpt
    cfg = _small_cfg(jpt, **variant)
    state = _jax_state(jpt, cfg)
    jb, tb = _pt_batch(cfg)
    s1, m = jax.jit(jpt.build_pt_train_step(cfg))(state, jb)
    tr = _port_trainer(state, cfg)
    tr64 = copy.deepcopy(tr)
    for net in (tr64.g, tr64.pw, tr64.d, tr64.netf, tr64.vgg):
        if net is not None:
            net.double()
    tr64.step({k: v.double() for k, v in tb.items()})
    got = tr.step(tb)
    for k, r in m.items():
        np.testing.assert_allclose(float(got[k]), float(r), rtol=1e-4,
                                   err_msg=k)
    if cfg.G_pix_warp:
        net, sd_of, new, old = tr.pw, _pw_sd(cfg), s1.pw, state.pw
    else:
        net, sd_of, new, old = tr.g, _g_sd(cfg), s1.g, state.g
    loss_ref = (float(m["loss_l1"]) * cfg.loss_weight_l1
                + float(m["loss_content"]) * cfg.loss_weight_content
                + float(m.get("loss_style", 0.0)) * cfg.loss_weight_style
                + float(m["loss_G"]) * cfg.loss_weight_gan)
    _check_step(net, sd_of, new["params"], new["batch_stats"],
                adam_grads(s1.opt_g), loss_ref, got["loss"], cfg.lr,
                grads_f64=module_grads(tr64.trained))
    # G stays as it was in the pixel-warper stage
    if cfg.G_pix_warp:
        for k, t in tr.g.state_dict().items():
            assert torch.equal(t, _g_sd(cfg)(state.g)[k]), k
    d_sd = lambda t: from_jax.bn_patch_d_state_dict(t, n_layers=2)  # noqa
    gd = adam_grads(s1.opt_d)
    gd = jax.tree_util.tree_map(
        lambda g_, p: g_ - cfg.weight_decay_D * np.asarray(p), gd,
        state.d["params"])
    _check_step(tr.d, d_sd, s1.d["params"], s1.d["batch_stats"], gd,
                m["loss_D"], got["loss_D"], cfg.lr_D,
                grads_f64=module_grads(tr64.d))


def test_pose_transfer_test_step_matches_jax():
    """The eval forward's output image within 1e-4; PSNR and SSIM within
    1e-5 (1e-3 dB for PSNR, whose uint8 levels may flip at a tie)."""
    from animateportrait_tpu.train import pose_transfer as jpt
    cfg = _small_cfg(jpt)
    state = _jax_state(jpt, cfg)
    jb, tb = _pt_batch(cfg, seed=26)
    out_j, meas_j = jax.jit(jpt.build_pt_test_step(cfg))(state, jb)
    out_t, meas_t = _port_trainer(state, cfg).test(tb)
    assert maxdiff(nhwc(out_t["img_out"]), out_j["img_out"]) <= 1e-4
    assert maxdiff(nhwc(out_t["img_warp"]), out_j["img_warp"]) <= 1e-4
    assert abs(float(meas_t["SSIM"]) - float(meas_j["SSIM"])) <= 1e-5
    assert abs(float(meas_t["PSNR"]) - float(meas_j["PSNR"])) <= 1e-3


def test_convergence_runner_matches_the_jax_tool(monkeypatch):
    """train/convergence.py's pose-transfer run at 3 steps from the JAX
    tool's initial weights: L1 and PSNR, first within rtol 1e-4, last
    within rtol 1e-2 (as the content run's test states)."""
    from animateportrait_tpu_torch.train import convergence
    from torch_port_helpers import jax_tool_run
    ref, weights, _ = jax_tool_run("pose", 3, monkeypatch)
    got = convergence.run_pose_transfer(3, "cpu", weights)
    for g, r, tol in zip(got, ref, (1e-4, 1e-2, 1e-4, 1e-2)):
        np.testing.assert_allclose(g, r, rtol=tol)


@pytest.mark.parametrize("which", ["dual_unet", "unet"])
def test_a_size_the_scales_do_not_divide_is_refused_at_construction(which):
    """The options' size 224 is no multiple of 2^7: build_g and the
    trainer refuse it by name, before any forward (the decoder's skips
    would not line up)."""
    cfg = tpt.PoseTransferConfig(which_model_G=which)
    assert cfg.size == 224 and cfg.G_n_scale == 7
    with pytest.raises(ValueError, match=r"size 224 .* 2\^G_n_scale = 128"):
        tpt.build_g(cfg)
    small = _small_cfg(tpt, which_model_G=which)
    g = tpt.build_g(small)
    bad = dataclasses.replace(small, size=36)
    with pytest.raises(ValueError, match=r"size 36 .* = 8 \(G_n_scale 3\)"):
        tpt.PoseTransferTrainer(bad, g, FlowUnet(input_nc=12),
                                Vgg19Features(), d=tpt.build_d(small),
                                device="cpu")
