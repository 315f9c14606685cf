"""The port's bf16 building blocks against the JAX package's bf16 paths, on
the CPU, on the same weights and seeded inputs:

- InstanceNorm: K2's and K2b's plain versions on bf16 tensors against the
  JAX package's XLA formulation on bf16 input and ``jax.vjp`` of it (the
  gradient of K2 in JAX), with and without ReLU, on a flat plane, a plane
  with |mean|/std ~ 12 and an odd H*W. JAX runs with its two-pass
  statistics (``AP_IN_STATS=twopass``), which the port's shifted sums
  compute (ROADMAP Queue 3). Bar: within one bf16 ulp of the reference at
  every element, or within 2^-16 of the largest |value| where that ulp is
  finer than fp32's own error (dx near 0 after cancellation).
- BatchNorm in eval mode on bf16 input, in both JAX casts: the renderer's
  (scale and bias bf16, statistics fp32) and the training step's (all
  bf16).
- FlowUnet in both casts and the trident generator in bf16. bf16 rounds at
  other places in the two frameworks, so the bars are relative to JAX's
  own bf16 error: (a) PSNR(port bf16, JAX fp32) >= PSNR(JAX bf16, JAX fp32)
  - 1 dB; (b) PSNR(port bf16, JAX bf16) >= PSNR(JAX bf16, JAX fp32) - 3.5
  dB (two independent roundings of equal power).
"""
import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from animateportrait_tpu_torch.io import from_jax
from animateportrait_tpu_torch.nn import BatchNorm2d, cast_parameters
from animateportrait_tpu_torch.ops import instnorm
from torch_port_helpers import nchw, nhwc, psnr

# the bars of (a) and (b), in dB below JAX's own bf16 PSNR against fp32
BAR_A_DB = 1.0
BAR_B_DB = 3.5
# below one bf16 ulp, fp32 noise: 2^-16 of the largest |value| (fp32's
# error in dx = rstd (gy - E[gy] - xhat E[gy xhat]) is ~1e-6 of the top)
ULP_FLOOR = 2.0 ** -16


def _bf16(a) -> torch.Tensor:
    """A numpy or JAX array, NHWC, as a bf16 NCHW tensor of equal values."""
    return nchw(np.asarray(jnp.asarray(a).astype(jnp.float32))).bfloat16()


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _ulps(got: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """|got - ref| in bf16 ulps at |ref|, with the ULP_FLOOR."""
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126)))
                  - 7)
    return np.abs(got - ref) / np.maximum(ulp, ULP_FLOOR * np.abs(ref).max())


IN_PLANES = {
    "flat": (lambda r: r.standard_normal((2, 64, 64, 8)), ),
    "offset12": (lambda r: r.standard_normal((2, 64, 64, 8)) + 12.0, ),
    "odd": (lambda r: r.standard_normal((2, 31, 31, 8)) * 3 + 1, ),
}


@pytest.fixture(scope="module")
def in_cases():
    """Each plane and ReLU: the JAX forward and gradient of a bf16 input
    and bf16 upstream gradient, and the port's plain versions."""
    from animateportrait_tpu.ops.pallas_instnorm import _xla_instance_norm

    rng = np.random.default_rng(0)
    out = {}
    os.environ["AP_IN_STATS"] = "twopass"
    try:
        for name, (make,) in IN_PLANES.items():
            xb = jnp.asarray(make(rng).astype(np.float32)).astype(
                jnp.bfloat16)
            gb = jnp.asarray(rng.standard_normal(xb.shape).astype(
                np.float32)).astype(jnp.bfloat16)
            for relu in (False, True):
                fn = (lambda v, r=relu: _xla_instance_norm(v, 1e-5, r))
                y, vjp = jax.vjp(fn, xb)
                x, g = _bf16(xb), _bf16(gb)
                stats = instnorm.instance_norm_stats_plain(x)
                out[name, relu] = dict(
                    ref=_f32(y), dref=_f32(vjp(gb)[0]),
                    got=nhwc(instnorm.instance_norm_plain(x, relu=relu)
                             .float()),
                    dgot=nhwc(instnorm.instance_norm_backward_plain(
                        x, g, stats, relu).float()))
    finally:
        del os.environ["AP_IN_STATS"]
    return out


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("plane", list(IN_PLANES))
def test_instance_norm_bf16_plain_within_one_ulp_of_jax(in_cases, plane,
                                                        relu):
    """K2's plain version in bf16 against ``_xla_instance_norm`` on bf16
    input. Measured: at most 1 ulp; 99.993-100% of the elements
    bit-equal."""
    c = in_cases[plane, relu]
    assert c["got"].shape == c["ref"].shape
    assert _ulps(c["got"], c["ref"]).max() <= 1.0
    assert (c["got"] == c["ref"]).mean() >= 0.999


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("plane", list(IN_PLANES))
def test_instance_norm_bf16_backward_within_one_ulp_of_jax(in_cases, plane,
                                                           relu):
    """K2b's plain version in bf16 (x and g widened, dx in fp32, rounded
    once) against ``jax.vjp`` of the XLA formulation on bf16 input.
    Measured: at most 1 ulp (with the floor); 99.95-100% bit-equal. Taken
    in bf16 arithmetic, as the plain backward did before, it was 63-75%
    bit-equal and 180-8000 ulps off (with the floor) on these planes."""
    c = in_cases[plane, relu]
    assert _ulps(c["dgot"], c["dref"]).max() <= 1.0
    assert (c["dgot"] == c["dref"]).mean() >= 0.995


def _bn_variables(rng, c):
    """flax BatchNorm variables with non-trivial scale, bias and
    statistics."""
    return {"params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                       "bias": rng.normal(0, 0.3, c).astype(np.float32)},
            "batch_stats": {"mean": rng.normal(0, 0.5, c).astype(np.float32),
                            "var": rng.uniform(0.5, 2.0, c).astype(
                                np.float32)}}


@pytest.mark.parametrize("cast", ["render", "train"])
def test_batch_norm_bf16_matches_flax(cast):
    """Eval-mode BatchNorm on bf16 input: the renderer's cast (parameters
    bf16, statistics fp32) and the training step's (every leaf bf16).
    Measured: bit-equal to flax in both."""
    import flax.linen as fnn

    rng = np.random.default_rng(1)
    v = _bn_variables(rng, 16)
    x = jnp.asarray(rng.normal(0.3, 2.0, (2, 9, 7, 16)).astype(
        np.float32)).astype(jnp.bfloat16)
    jv = jax.tree_util.tree_map(jnp.asarray, v)
    jv = {"params": jax.tree_util.tree_map(
        lambda t: t.astype(jnp.bfloat16), jv["params"]),
        "batch_stats": jv["batch_stats"] if cast == "render" else
        jax.tree_util.tree_map(lambda t: t.astype(jnp.bfloat16),
                               jv["batch_stats"])}
    ref = fnn.BatchNorm(use_running_average=True, epsilon=1e-5).apply(jv, x)
    assert ref.dtype == jnp.bfloat16
    bn = BatchNorm2d(16).eval()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(v["params"]["scale"]))
        bn.bias.copy_(torch.from_numpy(v["params"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(v["batch_stats"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(v["batch_stats"]["var"]))
    bn = cast_parameters(bn, torch.bfloat16) if cast == "render" else \
        bn.to(torch.bfloat16)
    with torch.no_grad():
        got = bn(_bf16(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(nhwc(got.float()), _f32(ref))


def _perturb_batch_stats(variables, seed):
    """Random BatchNorm scales, biases and statistics in a variables tree
    (``random_variables`` leaves them 1 and 0)."""
    rng = np.random.default_rng(seed)

    def fill(path, t):
        p = "/".join(str(getattr(q, "key", q)) for q in path).lower()
        t = np.asarray(t)
        if p.endswith("scale") or p.endswith("var"):
            return rng.uniform(0.5, 1.5, t.shape).astype(t.dtype)
        if "bn" in p or "norm" in p or p.endswith("mean"):
            if p.endswith("bias") or p.endswith("mean"):
                return rng.normal(0, 0.2, t.shape).astype(t.dtype)
        return t

    return jax.tree_util.tree_map_with_path(fill, variables)


def _cast_tree(tree):
    return jax.tree_util.tree_map(
        lambda t: t.astype(jnp.bfloat16) if t.dtype == jnp.float32 else t,
        tree)


@pytest.fixture(scope="module")
def flowunets():
    """FlowUnet (nf 4, 3 scales) on keypoint-like binary maps, in fp32 and
    in both bf16 casts, in JAX and in the port."""
    from animateportrait_tpu.models.flowunet import FlowUnet as JF
    from animateportrait_tpu.utils.smoke import random_variables
    from animateportrait_tpu_torch.models.flowunet import FlowUnet

    jf = JF(nf=4, num_scale=3, max_nf=64)
    v = random_variables(lambda: jf.init(jax.random.key(0),
                                         jnp.zeros((1, 224, 224, 136))),
                         seed=2)
    v = jax.tree_util.tree_map(jnp.asarray, _perturb_batch_stats(v, 3))
    rng = np.random.default_rng(4)
    x = (rng.uniform(size=(2, 224, 224, 136)) < 0.02).astype(np.float32)
    net = FlowUnet(nf=4, num_scale=3, max_nf=64)
    net.load_state_dict(from_jax.flowunet_state_dict(v, 3))
    apply = jax.jit(jf.apply)
    out = {"f32": apply(v, jnp.asarray(x))[:2]}
    casts = {"render": dict(v, params=_cast_tree(v["params"])),
             "train": _cast_tree(v)}
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    port = {"render": cast_parameters(copy.deepcopy(net), torch.bfloat16),
            "train": copy.deepcopy(net).to(torch.bfloat16)}
    with torch.no_grad():
        for cast, jv in casts.items():
            out[f"jax_{cast}"] = apply(jv, xb)[:2]
            flow, vis, _, _ = port[cast](nchw(x).bfloat16())
            out[f"port_{cast}"] = (nhwc(flow.float()), nhwc(vis.float()))
    return {k: tuple(_f32(t) for t in v) for k, v in out.items()}


@pytest.mark.parametrize("cast", ["render", "train"])
def test_flowunet_bf16_relative_to_jax_bf16_error(flowunets, cast):
    """FlowUnet's flow in bf16, PSNR over the fp32 flow's span. Measured:
    render cast JAX-bf16 vs fp32 / port vs fp32 / port vs JAX-bf16
    55.62 / 56.49 / 56.60 dB; train cast 53.79 / 54.31 / 56.45 dB."""
    f32 = flowunets["f32"][0]
    peak = float(f32.max() - f32.min())
    jb, pb = flowunets[f"jax_{cast}"][0], flowunets[f"port_{cast}"][0]
    base = psnr(jb, f32, peak)
    assert psnr(pb, f32, peak) >= base - BAR_A_DB
    assert psnr(pb, jb, peak) >= base - BAR_B_DB


@pytest.mark.parametrize("cast", ["render", "train"])
def test_flowunet_bf16_visibility_argmax_flips(flowunets, cast):
    """The renderer's mask is argmax(vis) < 2; on bf16 logits near-ties
    may flip. Measured, of 100352 pixels: none flipped against JAX bf16,
    and none between JAX bf16 and fp32, in both casts."""
    def mask(v):
        return np.argmax(v, -1) < 2

    m32 = mask(flowunets["f32"][1])
    mj = mask(flowunets[f"jax_{cast}"][1])
    mp = mask(flowunets[f"port_{cast}"][1])
    flips_jax = int((mj != m32).sum())
    flips_port = int((mp != mj).sum())
    assert flips_port <= 2 * flips_jax + 20
    assert flips_port <= 1e-3 * mp.size


@pytest.fixture(scope="module")
def generators():
    """The trident generator (ngf 8, 3 blocks, 64 px) on random images,
    grids and flows: JAX fp32, JAX bf16 (every parameter and image bf16,
    grids fp32) and the port's bf16 copy."""
    from animateportrait_tpu.models.gan import TridentGeneratorFullIFW as JT
    from animateportrait_tpu.utils.smoke import random_variables
    from animateportrait_tpu_torch.models.gan import TridentGeneratorFullIFW

    H = 64
    jt = JT(output_nc=1, ngf=8, n_blocks=3, div=3, disp=3)
    z = jnp.zeros
    v = random_variables(lambda: jt.init(
        jax.random.key(0), z((1, H, H, 3)), z((1, H, H, 1)),
        z((1, H, H, 1)), z((1, H, H, 2)), z((1, H, H, 2)),
        z((1, H, H, 1))), seed=5)
    rng = np.random.default_rng(6)
    imgs = [rng.uniform(-1, 1, (2, H, H, c)).astype(np.float32)
            for c in (3, 1, 1)]
    motion = rng.uniform(-1, 1, (2, H, H, 2)).astype(np.float32)
    flow = rng.normal(0, 3, (2, H, H, 2)).astype(np.float32)
    mask = (rng.uniform(size=(2, H, H, 1)) > 0.2).astype(np.float32)
    grids = [jnp.asarray(motion), jnp.asarray(flow), jnp.asarray(mask)]
    apply = jax.jit(jt.apply)
    f32 = apply(v, *map(jnp.asarray, imgs), *grids)
    jb = apply(_cast_tree(jax.tree_util.tree_map(jnp.asarray, v)),
                  *(jnp.asarray(a).astype(jnp.bfloat16) for a in imgs),
                  *grids)
    g = TridentGeneratorFullIFW(output_nc=1, ngf=8, n_blocks=3, div=3,
                                disp=3)
    g.load_state_dict(from_jax.trident_state_dict(v, 3, 3, 3))
    g = cast_parameters(g, torch.bfloat16)
    with torch.no_grad():
        pb = g(*(nchw(a).bfloat16() for a in imgs),
               torch.from_numpy(motion), nchw(flow), nchw(mask))
    assert pb.dtype == torch.bfloat16
    return _f32(f32), _f32(jb), nhwc(pb.float())


def test_generator_bf16_relative_to_jax_bf16_error(generators):
    """Measured: JAX bf16 vs fp32 49.23 dB, port bf16 vs fp32 49.53 dB,
    port vs JAX bf16 50.27 dB."""
    f32, jb, pb = generators
    base = psnr(jb, f32)
    assert psnr(pb, f32) >= base - BAR_A_DB
    assert psnr(pb, jb) >= base - BAR_B_DB


# CTAs per plane that K2-bf16 (2 bytes an element, 16-byte slices) and
# K2b-bf16 (4: x and g) take at the default budget, beside fp32's
@pytest.mark.parametrize("shape,k2,k2b,k2_f32,k2b_f32", [
    ((2, 3, 64, 64), 1, 1, 1, 1), ((2, 4, 256, 256), 2, 4, 4, 8),
    ((1, 4, 512, 512), 8, 8, 8, 0), ((1, 2, 1024, 1024), 0, 0, 0, 0),
    ((1, 2, 257, 255), 2, 4, 4, 8), ((3, 5, 31, 31), 1, 1, 1, 1)])
def test_bf16_cluster_sizes(shape, k2, k2b, k2_f32, k2b_f32):
    x = torch.empty(shape, dtype=torch.bfloat16)
    assert (instnorm.k2_cluster(x), instnorm.k2b_cluster(x)) == (k2, k2b)
    x = x.float()
    assert (instnorm.k2_cluster(x), instnorm.k2b_cluster(x)) == (k2_f32,
                                                                 k2b_f32)
    # a K2-bf16 slice is a multiple of 8 elements (16 bytes)
    assert instnorm.slice_elems(shape[2] * shape[3], max(k2, 1), 8) % 8 == 0


def test_bf16_bounds():
    """K2-bf16 moves 4 bytes an element (and 12 a plane of statistics in
    training), K2b-bf16 6 (and 12 a plane): half of fp32's."""
    from animateportrait_tpu_torch.utils import kernel_bench as kb

    shape = (8, 256, 64, 64)
    n, planes = 8 * 256 * 64 * 64, 8 * 256
    assert kb.k2_work(shape, 2) == (4 * n, 8 * n)
    assert kb.k2_work(shape, 2, stats=True)[0] == 4 * n + 12 * planes
    assert kb.k2b_work(shape, 2) == (6 * n + 12 * planes, 10 * n)
    assert kb.k2b_work(shape)[0] == 12 * n + 12 * planes
    ms, by = kb.bound(*kb.k2_work(shape, 2))
    assert by == "bytes" and abs(ms - 4 * n / 3.35e9) < 1e-12
    assert set(kb.K2_BATCH_MIX) <= set(kb.K2_BF16_RENDER_SHAPES)
