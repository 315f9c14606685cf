"""The port's Module2 network registry (``models/gan_extra.py`` and the
``ResnetGenerator`` / ``PixelDiscriminator`` of ``models/gan.py``) against
the JAX package's ``define_g`` / ``define_d`` / ``define_p`` on the same
weights (JAX random variables carried over by ``io/from_jax.py``) and
inputs, at small widths: every name's forward within 1e-4 of the output's
scale; the gradients of one generator of each family and of the
discriminators through K2's plain version by ``grad_parity`` with the
port's float64 run (within 1e-3 of the JAX leaf's scale, or no farther
from float64 than 3x JAX's leaf); the converters with a JAX loader
checked by a round trip through it; and unknown names refused as the JAX
registry refuses them.

rcatland4 is the case for the float64 run: ``jax.grad`` of its first
head's blocks is up to 15% of their scale from the float64 gradient of
the same forward, which a central difference of the port's float64
forward confirms (``test_dual_head_gradient_is_the_derivative``)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from animateportrait_tpu.models import gan as jgan
from animateportrait_tpu.models import gan_extra as jx
from animateportrait_tpu.utils.smoke import random_variables
from animateportrait_tpu_torch.io import from_jax
from animateportrait_tpu_torch.models import gan_extra as tx
from animateportrait_tpu_torch.utils.smoke import grad_parity
from torch_port_helpers import (
    assert_as_exact_as_jax, f64_run, in_cancelled_biases, maxdiff, nchw,
    nhwc, random_jax_variables)

K = jax.random.key(0)
NGF = 8
NB = 3


def _inputs(cs: int, land_nc: int = 1, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    f = np.float32
    return {
        "x": rng.uniform(-1, 1, (2, cs, cs, 3)).astype(f),
        "land1": np.where(rng.uniform(size=(2, cs, cs, land_nc)) > 0.9, 1.0,
                          -1.0).astype(f),
        "land2": np.where(rng.uniform(size=(2, cs, cs, land_nc)) > 0.9, 1.0,
                          -1.0).astype(f),
        "motion": rng.uniform(-1, 1, (2, cs, cs, 2)).astype(f),
        "motion2": rng.uniform(-1, 1, (2, cs, cs, 2)).astype(f),
        "flow": rng.uniform(-3, 3, (2, cs, cs, 2)).astype(f),
        "mask": rng.uniform(0, 1, (2, cs, cs, 1)).astype(f),
    }


# name -> (arguments, as keys of _inputs, in the JAX module's order; size;
# converter of the JAX variables)
_COND = ("resnet_9blocks_rcatland32", "resnet_10blocks_rcatland32",
         "resnet_9blocks_rcatland32_fw", "resnet_9blocks_rcatland32_fw2",
         "resnet_9blocks_rcatland32_ifw", "resnet_9blocks_rcatland",
         "resnet_9blocks_rcatland3")
_WARP_ARGS = {"none": ("x", "land1", "land2"),
              "fw": ("x", "land1", "land2", "motion"),
              "fw2": ("x", "land1", "land2", "motion"),
              "ifw": ("x", "land1", "land2", "motion", "flow", "mask")}
_TRIDENT_ARGS = {"both": ("x", "land1", "land2", "motion", "flow", "mask"),
                 "dual_motion": ("x", "land1", "land2", "motion", None, None,
                                 "motion2"),
                 "motion": ("x", "land1", "land2", "motion"),
                 "flow": ("x", "land1", "land2", None, "flow", "mask")}


def _g_case(name: str):
    if name in _COND:
        return _WARP_ARGS[tx.CONDITIONAL[name][1]], 64, \
            from_jax.conditional_resnet_state_dict
    if name in tx.TRIDENT_VARIANTS:
        return _TRIDENT_ARGS[tx.TRIDENT_VARIANTS[name]["warp"]], 64, \
            lambda v: from_jax.trident_state_dict(v, NB, 3, 1)
    return {
        "resnet_9blocks": (("x",), 64,
                           lambda v: from_jax.resnet_g_state_dict(v, NB)),
        "resnet_6blocks": (("x",), 64,
                           lambda v: from_jax.resnet_g_state_dict(v, NB)),
        "resnet_style2_9blocks": (("x", "style"), 64,
                                  lambda v: from_jax.style2_state_dict(v, NB)),
        "resnet_9blocks_rcatland32_full_ifw": (
            _TRIDENT_ARGS["both"], 64,
            lambda v: from_jax.trident_state_dict(v, NB, 3, 1)),
        "resnet_9blocks_rcatland4": (("x", "land1", "land2"), 64,
                                     from_jax.dual_head_state_dict),
        "resnet_9blocks_rcatland2": (("x", "x2"), 64,
                                     from_jax.warped_resnet_state_dict),
        "unet_128": (("x",), 128, from_jax.unet_state_dict),
        "unet_256": (("x",), 256, from_jax.unet_state_dict),
        "regressor": (("x",), 11, from_jax.flat_state_dict),
        "combiner": (("x",), 64, from_jax.combiner_state_dict),
    }[name]


def _g_args(name, args, cs):
    inp = _inputs(cs, land_nc=3 if name.endswith("colorcoded") else 1)
    inp["style"] = np.tile(np.float32([0, 1, 0]), (2, cs // 4, cs // 4, 1))
    inp["x2"] = np.roll(inp["x"], 3, axis=1)
    return [None if a is None else inp[a] for a in args]


def _torch_arg(key, a):
    if a is None:
        return None
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if key in ("motion", "motion2") else t.permute(0, 3, 1, 2)


def _ngf(name):
    return 4 if name == "unet_256" else NGF


def _build(name, cs, args):
    kw = dict(output_nc=1, ngf=_ngf(name), n_blocks=NB, div=3, disp=1)
    if name in ("unet_128", "unet_256", "regressor", "combiner"):
        kw = dict(output_nc=1, ngf=_ngf(name))
        if name == "regressor":
            kw = dict(ngf=_ngf(name), arch=2)
    jm = jx.define_g(name, **kw)
    xs = [None if a is None else jnp.asarray(a) for a in args]
    v = random_variables(lambda: jm.init(K, *xs), seed=1)
    tm = tx.define_g(name, input_nc=3, **kw).eval()
    return jm, v, tm, xs


@pytest.mark.parametrize("name", sorted(tx.NETG))
def test_define_g_forward_matches_jax(name):
    keys, cs, convert = _g_case(name)
    args = _g_args(name, keys, cs)
    jm, v, tm, xs = _build(name, cs, args)
    tm.load_state_dict(convert(v), strict=True)
    ref = jm.apply(v, *xs)
    with torch.no_grad():
        got = tm(*(_torch_arg(k, a) for k, a in zip(keys, args)))
    refs = ref if isinstance(ref, tuple) else (ref,)
    gots = got if isinstance(got, tuple) else (got,)
    for g, r in zip(gots, refs):
        r = np.asarray(r)
        assert g.shape == tuple(np.moveaxis(r, -1, 1).shape)
        scale = float(np.abs(r).max())
        assert maxdiff(nhwc(g) if g.dim() == 4 else g, r) <= 1e-4 * scale, \
            name


def test_unet_256_reaches_2x2_planes():
    """unet_256 at 256^2 puts InstanceNorm on 2x2 planes (the innermost up
    and the last mid level's down): they are in the forward above, and the
    port's norm sees them."""
    from animateportrait_tpu_torch.nn import InstanceNorm2d
    tm = tx.define_g("unet_256", output_nc=1, ngf=4)
    seen = []
    for m in tm.modules():
        if isinstance(m, InstanceNorm2d):
            m.register_forward_hook(
                lambda mod, inp, out: seen.append(tuple(inp[0].shape[2:])))
    with torch.no_grad():
        tm(torch.zeros(1, 3, 256, 256))
    assert (2, 2) in seen and (4, 4) in seen


_D_CASES = {
    "basic": (64, from_jax.nlayer_d_state_dict),
    "n_layers": (64, lambda v: from_jax.nlayer_d_state_dict(v, 2)),
    "pixel": (32, from_jax.pixel_d_state_dict),
    "cls": (512, from_jax.flat_state_dict),
}


@pytest.mark.parametrize("name", sorted(tx.NETD))
def test_define_d_forward_and_grads_match_jax(name):
    """Forward within 1e-4 of its scale; the gradients of the mean square of
    every output by ``grad_parity`` (K2b's plain version in the port)."""
    cs, convert = _D_CASES[name]
    n_layers = 2 if name == "n_layers" else 3
    x = np.random.default_rng(3).uniform(-1, 1, (1, cs, cs, 3)).astype(
        np.float32)
    jm = jx.define_d(name, ndf=NGF, n_layers=n_layers)
    v = random_variables(lambda: jm.init(K, jnp.asarray(x)), seed=2)
    tm = tx.define_d(name, 3, ndf=NGF, n_layers=n_layers)
    tm.load_state_dict(convert(v), strict=True)

    def jloss(params):
        out = jm.apply({"params": params}, jnp.asarray(x))
        outs = out if isinstance(out, tuple) else (out,)
        return sum(jnp.mean(jnp.square(o)) for o in outs), outs

    (jl, jouts), jg = jax.value_and_grad(jloss, has_aux=True)(v["params"])
    outs = tm(nchw(x))
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum(torch.mean(torch.square(o)) for o in outs)
    loss.backward()
    for o, r in zip(outs, jouts):
        r = np.asarray(r)
        o = nhwc(o) if o.dim() == 4 else o.detach().numpy()
        assert maxdiff(o, r) <= 1e-4 * float(np.abs(r).max())
    assert abs(float(loss) - float(jl)) <= 1e-4 * abs(float(jl))
    ref = convert({"params": jax.tree_util.tree_map(np.asarray, jg)})
    got = {k: p.grad for k, p in tm.named_parameters()}
    errs = grad_parity(got, ref, _grads64(tm, [nchw(x)]),
                       in_cancelled_biases(tm) | _cancelled_flat(tm))
    assert max(errs.values()) <= 1e-3, max(errs, key=errs.get)


def _mean_square(out) -> torch.Tensor:
    outs = out if isinstance(out, tuple) else (out,)
    return sum(torch.mean(torch.square(o)) for o in outs)


def _grads64(net, inputs) -> dict:
    """The gradients of the mean square of a float64 copy's outputs."""
    import copy
    net64 = copy.deepcopy(net).double()
    _mean_square(net64(*(None if t is None else t.double()
                         for t in inputs))).backward()
    return {k: p.grad for k, p in net64.named_parameters()}


def _cancelled_flat(net):
    """The biases of the flat nets' convs that an InstanceNorm follows
    (attributes, not ``Sequential`` neighbours)."""
    out = set()
    for conv, norm in (("p_conv0", "p_norm"), ("c_conv0", "c_norm0"),
                       ("c_conv1", "c_norm1"), ("conv1", "norm1"),
                       ("conv2", "norm2")):
        if hasattr(net, conv) and hasattr(net, norm):
            out.add(f"{conv}.bias")
    return out


# one generator of each family, and unet_256 with its 2x2 planes: the
# gradients of the mean square of the output
_GRAD_NAMES = ("resnet_9blocks", "resnet_9blocks_rcatland32_fw",
               "resnet_9blocks_rcatland32_ifw",
               "resnet_9blocks_rcatland32_full_ifw2",
               "resnet_9blocks_rcatland32_full_ifw_single2",
               "resnet_9blocks_rcatland4", "unet_256")


@pytest.mark.parametrize("name", _GRAD_NAMES)
def test_define_g_grads_match_jax(name, monkeypatch):
    """The loss within rtol 1e-4 and every gradient leaf by ``grad_parity``
    against ``jax.grad`` (JAX's InstanceNorm statistics two-pass, as the
    port's; its one-pass default cancels on near-constant planes)."""
    monkeypatch.setenv("AP_IN_STATS", "twopass")
    keys, cs, convert = _g_case(name)
    args = _g_args(name, keys, cs)
    jm, v, tm, xs = _build(name, cs, args)
    tm.load_state_dict(convert(v), strict=True)
    tm.train()

    def jloss(params):
        out = jm.apply({"params": params}, *xs)
        outs = out if isinstance(out, tuple) else (out,)
        return sum(jnp.mean(jnp.square(o)) for o in outs)

    jl, jg = jax.value_and_grad(jloss)(v["params"])
    targs = [_torch_arg(k, a) for k, a in zip(keys, args)]
    out = tm(*targs)
    outs = out if isinstance(out, tuple) else (out,)
    loss = sum(torch.mean(torch.square(o)) for o in outs)
    loss.backward()
    assert abs(float(loss) - float(jl)) <= 1e-4 * abs(float(jl))
    ref = convert({"params": jax.tree_util.tree_map(np.asarray, jg)})
    got = {k: p.grad for k, p in tm.named_parameters()}
    errs = grad_parity(got, ref, _grads64(tm, targs), in_cancelled_biases(tm))
    assert max(errs.values()) <= 1e-3, max(errs, key=errs.get)


@pytest.mark.parametrize("which", ["unet_128", "unet_256"])
def test_define_p_matches_jax(which):
    """``define_p``: BatchNorm in eval mode on non-trivial statistics, and
    one training-mode forward (batch statistics, running statistics
    within 1e-4 after it), each within 1e-4 of the output's scale."""
    cs = 64 if which == "unet_128" else 128
    x = np.random.default_rng(4).uniform(-1, 1, (2, cs, cs, 3)).astype(
        np.float32)
    jm = jx.define_p(3, which, ngf=4)
    v = random_jax_variables(lambda: jm.init(K, jnp.asarray(x)), seed=3)
    tm = tx.define_p(3, which, ngf=4)
    sd = from_jax.unet_parse_state_dict(v)
    tm.load_state_dict(sd, strict=True)
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm.eval()(nchw(x))
    assert maxdiff(nhwc(got), ref) <= 1e-4
    ref_t, mut = jm.apply(v, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
    with torch.no_grad():
        got_t = tm.train()(nchw(x))
    assert maxdiff(nhwc(got_t), ref_t) <= 1e-4
    after = from_jax.unet_parse_state_dict({"params": v["params"], **mut})
    for k, t in tm.state_dict().items():
        if "running" in k:
            assert maxdiff(t, after[k]) <= 1e-4 * float(after[k].abs().max()), k


def test_small_nets_match_jax():
    """HED, ULP and the five Regressor archs (arch 5 with its dropout off
    in eval mode, and on in training mode with a seeded generator: the
    same mask twice, a different one for another seed)."""
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (2, 40, 40, 3)).astype(np.float32)
    jm = jx.HED()
    v = random_variables(lambda: jm.init(K, jnp.asarray(x)), seed=4)
    tm = tx.HED()
    tm.load_state_dict(from_jax.flat_state_dict(v), strict=True)
    with torch.no_grad():
        # logits of ~1e3 (255-scale input): a sigmoid near its step moves
        # by fp32 rounding alone, so the bar falls back to float64
        assert_as_exact_as_jax(nhwc(tm(nchw(x))), jm.apply(v, jnp.asarray(x)),
                               nhwc(f64_run(tm, nchw(x))), 1e-4)
    lm = rng.standard_normal((2, 68, 2)).astype(np.float32)
    jm = jx.ULP(17)
    v = random_variables(lambda: jm.init(K, jnp.asarray(lm)), seed=5)
    tm = tx.ULP(17)
    tm.load_state_dict(from_jax.flat_state_dict(v), strict=True)
    with torch.no_grad():
        ref = np.asarray(jm.apply(v, jnp.asarray(lm)))
        assert maxdiff(tm(torch.from_numpy(lm)), ref) <= 1e-4 * np.abs(
            ref).max()
    p = rng.standard_normal((2, 11, 11, 3)).astype(np.float32)
    for arch in (1, 2, 3, 4, 5):
        jm = jx.Regressor(ngf=4, arch=arch)
        v = random_variables(lambda: jm.init(K, jnp.asarray(p)), seed=arch)
        tm = tx.Regressor(3, ngf=4, arch=arch)
        tm.load_state_dict(from_jax.flat_state_dict(v), strict=True)
        ref = np.asarray(jm.apply(v, jnp.asarray(p)))
        with torch.no_grad():
            got = tm.eval()(nchw(p))
        got = nhwc(got) if got.dim() == 4 else got.numpy()
        assert maxdiff(got, ref) <= 1e-4 * np.abs(ref).max(), arch
    tm.train()
    with torch.no_grad():
        a, b, c = (tm(nchw(p), torch.Generator().manual_seed(s))
                   for s in (0, 0, 1))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_unet_dropout_draws_from_its_generator():
    """unet with dropout: eval mode deterministic; training mode the same
    output for the same generator seed, another for another seed."""
    tm = tx.UnetGenerator(3, 1, num_downs=7, ngf=4, use_dropout=True)
    x = torch.from_numpy(np.random.default_rng(6).uniform(
        -1, 1, (1, 3, 128, 128)).astype(np.float32))
    with torch.no_grad():
        e1, e2 = tm.eval()(x), tm(x)
        tm.train()
        a, b, c = (tm(x, torch.Generator().manual_seed(s)) for s in (0, 0, 1))
    assert torch.equal(e1, e2) and torch.equal(a, b)
    assert not torch.equal(a, c)


def test_registry_refuses_unknown_names():
    for port, ref, bad in ((tx.define_g, jx.define_g, "no_such_netg"),
                           (tx.define_d, jx.define_d, "no_such_netd")):
        with pytest.raises(ValueError) as want:
            ref(bad)
        with pytest.raises(ValueError) as got:
            port(bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown parse netG"):
        tx.define_p(3, "unet_512")


def test_resnet_g_converter_round_trip():
    """``resnet_g_state_dict`` is the inverse of ``load_resnet_g_params``:
    the port's state dict loads strictly and maps back to the same
    variables."""
    jm = jgan.ResnetGenerator(output_nc=1, ngf=NGF, n_blocks=NB)
    v = random_variables(lambda: jm.init(K, jnp.zeros((1, 32, 32, 3))))
    sd = from_jax.resnet_g_state_dict(v, NB)
    tx.define_g("resnet_9blocks", output_nc=1, ngf=NGF,
                n_blocks=NB).load_state_dict(sd, strict=True)
    back = jgan.load_resnet_g_params({k: t.numpy() for k, t in sd.items()},
                                     NB)
    flat_v = jax.tree_util.tree_flatten_with_path(v)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_v) == len(flat_b)
    for path, a in flat_v:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(a))


def test_dual_head_gradient_is_the_derivative():
    """rcatland4's first-head leaf where ``jax.grad`` and the port differ
    most: the port's float64 gradient is the central difference of its
    float64 forward (h 1e-7, within 1e-4 of the value); the loss is JAX's
    to 1e-6 in fp32."""
    name = "resnet_9blocks_rcatland4"
    keys, cs, convert = _g_case(name)
    args = _g_args(name, keys, cs)
    jm, v, tm, xs = _build(name, cs, args)
    tm.load_state_dict(convert(v), strict=True)
    targs = [_torch_arg(k, a).double() for k, a in zip(keys, args)]
    import copy
    net = copy.deepcopy(tm).double()
    _mean_square(net(*targs)).backward()
    w = net.a_model2[2].conv_block[1].weight
    idx = (10, 40, 1, 1)
    h = 1e-7
    with torch.no_grad():
        w[idx] += h
        lp = float(_mean_square(net(*targs)))
        w[idx] -= 2 * h
        lm = float(_mean_square(net(*targs)))
        w[idx] += h
    fd = (lp - lm) / (2 * h)
    assert abs(fd - float(w.grad[idx])) <= 1e-4 * abs(fd)
    ref = float(sum(jnp.mean(jnp.square(o)) for o in jm.apply(v, *xs)))
    assert abs(float(_mean_square(net(*targs))) - ref) <= 1e-6 * ref
