"""The port's two kernels (K1 STFT magnitude, K2 InstanceNorm): their plain
versions against the JAX package (XLA path and the Pallas kernel in
interpret mode) and the wrappers' dispatch rules on the CPU; the kernels
themselves are tested on the card by tests/test_torch_cuda.py. Also checks
that the port and chip_smoke.py import nothing of JAX, Flax, Optax or
Orbax, nor OpenCV, PIL or torchvision (the card machine has none of them),
and no module of the JAX package at all."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from animateportrait_tpu.ops.pallas_instnorm import (
    _pallas_forward, _xla_instance_norm)
from animateportrait_tpu.ops.pallas_stft import stft_magnitude_pallas
from animateportrait_tpu.ops.spectral import stft_magnitude as jax_stft
from animateportrait_tpu_torch.ops import instnorm, stft
from animateportrait_tpu_torch.ops.spectral import stft_magnitude as stft_plain
from animateportrait_tpu_torch.utils.kernel_bench import (
    K2_SHAPES, K2_STREAM_SHAPE)
from torch_port_helpers import maxdiff

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# K1: 1024-term fp32 sums accumulate in another order on each side; the
# JAX package's own Pallas-vs-XLA test uses the same bound
K1_TOL = dict(atol=2e-3, rtol=1e-3)


def _signal(n, seed=0):
    return (np.random.default_rng(seed).standard_normal(n) * 0.3).astype(
        np.float32)


@pytest.mark.parametrize("n", [16037, 96001])
def test_k1_plain_matches_jax_xla(n):
    x = _signal(n)
    ref = np.asarray(jax_stft(jnp.asarray(x)))
    got = stft_plain(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (n // 256 + 1, 513)
    np.testing.assert_allclose(got, ref, **K1_TOL)


def test_k1_plain_matches_pallas_interpret():
    x = _signal(16000 + 37, seed=1)
    ref = np.asarray(stft_magnitude_pallas(jnp.asarray(x)))  # interpret
    got = stft_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, **K1_TOL)


def test_k1_wrapper_takes_plain_on_cpu():
    x = torch.from_numpy(_signal(5000))
    before = stft.stft_magnitude.launches
    np.testing.assert_array_equal(stft.stft_magnitude(x).numpy(),
                                  stft_plain(x).numpy())
    assert stft.stft_magnitude.launches == before


def _act(shape, seed=0):
    """NHWC activations with per-channel scales and offsets, like a conv
    output. The offsets stay within ~2 standard deviations: the one-pass
    variance E[x^2] - E[x]^2 (the JAX package's formula) loses digits in
    proportion to mean^2 / var, which would blur any comparison of two
    summation orders."""
    rng = np.random.default_rng(seed)
    n, c = shape[0], shape[-1]
    return (rng.standard_normal(shape) * rng.uniform(1.0, 2.0, (n, 1, 1, c))
            + 0.5 * rng.standard_normal((n, 1, 1, c))).astype(np.float32)


def _k2_port(x_nhwc, relu, eps=1e-5):
    t = torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).contiguous()
    return instnorm.instance_norm_plain(t, eps, relu).permute(
        0, 2, 3, 1).numpy()


@pytest.mark.parametrize("shape", [(2, 16, 16, 8), (1, 8, 8, 256)])
@pytest.mark.parametrize("relu", [False, True])
def test_k2_plain_matches_jax(shape, relu):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = _k2_port(x, relu)
    # 1e-6 against the Pallas kernel K2 replaces (the JAX kernel test's
    # own bound; fp32 sums of <= 256 terms in another order)
    np.testing.assert_allclose(
        got, np.asarray(_pallas_forward(jnp.asarray(x), 1e-5, relu,
                                        interpret=True)), atol=1e-6)
    # 2e-6 against the XLA one-pass form: on these inputs it differs from
    # the JAX package's own Pallas kernel by up to 1.4e-6
    np.testing.assert_allclose(
        got, np.asarray(_xla_instance_norm(jnp.asarray(x), 1e-5, relu)),
        atol=2e-6)
    if relu:
        assert got.min() >= 0.0


def test_k2_plain_large_plane_and_ibnorm_slice():
    # 1e-5: a 512x512 plane sums 262144 terms per statistic, and the
    # summation orders of XLA and torch differ by ~1e-6 relative there
    x = _act((1, 512, 512, 16), seed=2)
    np.testing.assert_allclose(
        _k2_port(x, False),
        np.asarray(_xla_instance_norm(jnp.asarray(x), 1e-5, False)),
        atol=1e-5)
    # IBNorm's InstanceNorm half: a channel slice, made contiguous
    y = _act((1, 32, 32, 32), seed=3)
    t = torch.from_numpy(y).permute(0, 3, 1, 2)[:, 16:]
    assert not t.is_contiguous()
    got = instnorm.instance_norm(t.contiguous()).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(
        got, np.asarray(_xla_instance_norm(jnp.asarray(y[..., 16:]), 1e-5,
                                           False)), atol=1e-5)


def _far_from_zero_planes(seed=4):
    """NCHW planes whose |mean| is many standard deviations: Gaussian
    planes offset by 10 and 50 std, and mostly flat planes with sparse
    bright dots, like the landmark encoder's first InstanceNorm input."""
    rng = np.random.default_rng(seed)
    gauss = rng.standard_normal((2, 4, 64, 64)) + np.array(
        [10.0, 50.0, -10.0, -50.0])[None, :, None, None]
    flat = 3.0 + 0.01 * rng.standard_normal((2, 4, 64, 64))
    flat += (rng.uniform(size=flat.shape) < 0.005) * rng.uniform(
        0, 5, flat.shape)
    return np.concatenate([gauss, flat], 1).astype(np.float32)


@pytest.mark.parametrize("relu", [False, True])
def test_k2_plain_holds_planes_far_from_zero_mean(relu):
    x = _far_from_zero_planes()
    x64 = x.astype(np.float64)
    mean = x64.mean((2, 3), keepdims=True)
    ref = (x64 - mean) / np.sqrt(x64.var((2, 3), keepdims=True) + 1e-5)
    if relu:
        ref = np.maximum(ref, 0.0)
    got = instnorm.instance_norm_plain(torch.from_numpy(x), relu=relu)
    # 1e-5 against float64 statistics: the shifted one-pass form stays
    # within ~4e-6 here (outputs reach ~27 on the dotted planes), where
    # the unshifted E[x^2] - E[x]^2 is off by ~5e-4 at mean/std 50
    assert maxdiff(got.numpy(), ref) <= 1e-5


def test_k2_wrapper_dispatch():
    x = torch.from_numpy(_act((2, 8, 8, 4))).permute(0, 3, 1, 2).contiguous()
    before = instnorm.instance_norm.launches
    np.testing.assert_array_equal(instnorm.instance_norm(x, relu=True),
                                  instnorm.instance_norm_plain(x, relu=True))
    assert instnorm.instance_norm.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        instnorm.instance_norm(torch.empty((1, 2, 4, 4), device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        stft.stft_magnitude(torch.empty((4096,), device="meta"))


def test_kernel_sources_and_build_key():
    from animateportrait_tpu_torch import kernels

    for name in kernels.SOURCES:
        src = (kernels.CSRC_DIR / name).read_text()
        assert "extern \"C\"" in src and "cudaGetLastError" in src
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
    assert kernels._source_hash() == kernels._source_hash()
    assert kernels.BUILD_ROOT.parts[-2:] == ("build", "torch_kernels")


def test_kernel_sources_compute_without_library_kernels():
    from animateportrait_tpu_torch import kernels

    k1 = (kernels.CSRC_DIR / "stft.cu").read_text()
    k2 = (kernels.CSRC_DIR / "instnorm.cu").read_text()
    code = [line.split("//")[0] for line in (k1 + k2).splitlines()]
    code = "\n".join(code).lower()
    for name in ("cufft", "cudnn", "cublas", "basis"):
        assert name not in code
    # K1 runs the FFT's butterflies; K2 stages planes by TMA bulk copies
    # and splits large ones over a thread block cluster
    assert "radix4_stage" in k1 and "sincospif" in k1
    for token in ("cp.async.bulk.shared::cluster", "mbarrier",
                  "cudaLaunchAttributeClusterDimension", "map_shared_rank"):
        assert token in k2


@pytest.mark.parametrize("shape", K2_SHAPES)
def test_k2_stages_every_main_path_plane_in_shared_memory(shape):
    hw = shape[2] * shape[3]
    k = instnorm.cluster_size(hw)
    assert k in (1, 2, 4, 8)
    slice_bytes = 4 * instnorm.slice_elems(hw, k)
    assert k * instnorm.slice_elems(hw, k) >= hw
    assert instnorm.slice_elems(hw, k) % 4 == 0
    # within the budget, or 8 CTAs' slices within the hardware's limit
    assert slice_bytes <= instnorm.SLICE_BYTES or (
        k == 8 and slice_bytes <= instnorm.MAX_SLICE_BYTES)
    # the smallest cluster that fits: half as many CTAs would not
    if k > 1:
        assert 4 * instnorm.slice_elems(hw, k // 2) > instnorm.SLICE_BYTES


def test_k2_cluster_sizes_and_streaming():
    assert instnorm.cluster_size(64 * 64) == 1
    assert instnorm.cluster_size(128 * 192) == 2
    assert instnorm.cluster_size(256 * 256) == 4
    assert instnorm.cluster_size(256 * 256, 128 * 1024) == 2
    assert instnorm.cluster_size(512 * 512) == 8
    assert instnorm.cluster_size(1024 * 1024) == 0   # K2_STREAM_SHAPE
    assert instnorm.cluster_size(K2_STREAM_SHAPE[2] * K2_STREAM_SHAPE[3]) == 0


def test_kernel_bounds():
    from animateportrait_tpu_torch.utils import kernel_bench as kb

    # K1 on the 6 s clip: 0.38 MB in, 0.77 MB out, ~10 MFLOP of FFT
    nbytes, flops = kb.k1_work(96001)
    assert nbytes == 4 * 96001 + 4 * 376 * 513
    assert 9e6 < flops < 11e6
    ms, by = kb.bound(nbytes, flops)
    assert by == "bytes" and abs(ms - nbytes / 3.35e9) < 1e-12
    # K2 at (8, 64, 256, 256): one read and one write, 80.1 us
    ms, by = kb.bound(*kb.k2_work((8, 64, 256, 256)))
    assert by == "bytes" and abs(ms - 0.0801) < 1e-4
    # a function with more operations than bytes is bound by operations
    assert kb.bound(1, 1e9)[1] == "operations"


_NO_JAX = r"""
import importlib, pkgutil, sys
# every module of the JAX package is blocked, even one that is numpy only
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "cv2", "PIL",
           "torchvision", "animateportrait_tpu")
def blocked(name):
    return name.split(".")[0] in BLOCKED
class Block:
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import animateportrait_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
assert not any(blocked(k) for k in sys.modules)
assert not any(k.split(".")[0] == "animateportrait_tpu" for k in sys.modules)
assert "animateportrait_tpu_torch.utils.assets" in sys.modules
assert "animateportrait_tpu_torch.cli" in mods
assert "animateportrait_tpu_torch.train_cli" in mods
assert "animateportrait_tpu_torch.utils.jpeg" in mods
assert "animateportrait_tpu_torch.models.fan3d" in mods
assert "animateportrait_tpu_torch.test_cli" in mods
assert "animateportrait_tpu_torch.pipeline.batch" in mods
from animateportrait_tpu_torch.utils.jpeg import decode_jpeg, encode_jpeg
from animateportrait_tpu_torch.utils.video import (
    read_first_frame, read_pcm_track)
from animateportrait_tpu_torch.utils.image import draw_landmarks
print(len(mods))
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 51


def test_chip_smoke_refuses_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout

