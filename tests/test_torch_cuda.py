"""Card-only tests of the port's CUDA kernels: each kernel against its plain
PyTorch version, the wrappers' checks and launch counters, and small runs
on the card against the CPU: the renderer (drawing and cartoon), the MTCNN
cascade, Photo2Cartoon and the speaker embedding. They skip without a CUDA
device.

This file imports neither JAX nor the JAX package, so it runs where JAX is
not installed; the repo's conftest imports JAX, so on such a machine run

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""
import numpy as np
import pytest
import torch

from animateportrait_tpu_torch.ops import instnorm, stft
from animateportrait_tpu_torch.ops.spectral import stft_magnitude as stft_plain
from animateportrait_tpu_torch.utils.kernel_bench import (
    K2_SHAPES, K2_STREAM_SHAPE, k2_input)
from torch_port_helpers import cuda_device, maxdiff, psnr  # noqa: F401

pytestmark = pytest.mark.cuda

# an fp32 FFT against 1024-term fp32 sums by cuBLAS (as the JAX tests)
K1_TOL = dict(atol=2e-3, rtol=1e-3)
# fp32 statistics over up to 262144 pixels, summed in another order
K2_ATOL = 1e-5


def _act(shape, seed=0, offset=0.5):
    """NCHW activations with per-channel scales in [1, 2) and offsets
    ~N(0, offset^2), like a conv output."""
    g = torch.Generator().manual_seed(seed)
    n, c = shape[:2]
    return (torch.randn(shape, generator=g)
            * (1 + torch.rand((n, c, 1, 1), generator=g))
            + offset * torch.randn((n, c, 1, 1), generator=g))


# 513 and 4095: every block touches a reflected edge; 96000 and 96001:
# the 6 s clip (condition_signal appends one sample to 96000); 960000: 60 s
@pytest.mark.parametrize("n", [513, 4095, 16037, 96000, 96001, 960000])
def test_k1_kernel_matches_plain(cuda_device, n):
    x = (torch.randn(n, generator=torch.Generator().manual_seed(n)) * 0.3
         ).to(cuda_device)
    with torch.inference_mode():
        got = stft.stft_magnitude(x)
        want = stft_plain(x)
    assert got.shape == (n // 256 + 1, 513)
    torch.testing.assert_close(got, want, **K1_TOL)


@pytest.mark.parametrize("shape", [(8, 256, 64, 64), (8, 8, 256, 256),
                                   (1, 64, 512, 512), (2, 3, 5, 7)])
@pytest.mark.parametrize("relu", [False, True])
# offset 50: means of tens of standard deviations, where an unshifted
# one-pass variance would lose ~3 digits; both sides shift each plane by
# its mean, so they still agree to K2_ATOL
@pytest.mark.parametrize("offset", [0.5, 50.0])
def test_k2_kernel_matches_plain(cuda_device, shape, relu, offset):
    x = _act(shape, offset=offset).to(cuda_device)
    with torch.inference_mode():
        got = instnorm.instance_norm(x, relu=relu)
        want = instnorm.instance_norm_plain(x, relu=relu)
    assert maxdiff(got.cpu(), want.cpu()) <= K2_ATOL


# every InstanceNorm shape of the main paths, and the streaming branch
@pytest.mark.parametrize("shape", K2_SHAPES + [K2_STREAM_SHAPE])
@pytest.mark.parametrize("relu", [False, True])
def test_k2_kernel_at_main_path_shapes(cuda_device, shape, relu):
    x = k2_input(shape, cuda_device)
    with torch.inference_mode():
        got = instnorm.instance_norm(x, relu=relu)
        want = instnorm.instance_norm_plain(x, relu=relu)
    assert maxdiff(got.cpu(), want.cpu()) <= K2_ATOL


# one shape for each number of CTAs per plane the dispatcher picks at the
# default budget (0: streaming), and a plane with hw % 4 != 0 split over a
# cluster (scalar loads into shared memory)
@pytest.mark.parametrize("shape,cluster", [
    ((2, 3, 64, 64), 1), ((2, 4, 128, 192), 2), ((2, 4, 256, 256), 4),
    ((1, 4, 512, 512), 8), ((1, 2, 1024, 1024), 0), ((1, 2, 257, 255), 4)])
@pytest.mark.parametrize("relu", [False, True])
def test_k2_every_cluster_size(cuda_device, shape, cluster, relu):
    assert instnorm.cluster_size(shape[2] * shape[3]) == cluster
    x = k2_input(shape, cuda_device, seed=3)
    with torch.inference_mode():
        got = instnorm.instance_norm(x, relu=relu)
        want = instnorm.instance_norm_plain(x, relu=relu)
    assert maxdiff(got.cpu(), want.cpu()) <= K2_ATOL


# every cluster a 256^2 plane can take: 2 (128 KB slices), 4, 8 (32 KB)
@pytest.mark.parametrize("cluster", [2, 4, 8])
def test_k2_any_valid_cluster_gives_the_same_result(cuda_device, cluster):
    x = k2_input((2, 8, 256, 256), cuda_device, seed=4)
    y = torch.empty_like(x)
    with torch.inference_mode():
        instnorm._launch(x, y, 1e-5, True, cluster)
    assert maxdiff(y.cpu(), instnorm.instance_norm_plain(x, relu=True)
                   .cpu()) <= K2_ATOL


# 3 CTAs, and slices over a CTA's shared memory (one CTA for 512^2)
@pytest.mark.parametrize("cluster", [3, 16, -1, 1])
def test_k2_refuses_a_cluster_it_cannot_run(cuda_device, cluster):
    x = k2_input((1, 2, 512, 512), cuda_device)
    before = instnorm.instance_norm.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        instnorm._launch(x, torch.empty_like(x), 1e-5, False, cluster)
    assert instnorm.instance_norm.launches == before


def test_k2_unaligned_input_takes_scalar_loads(cuda_device):
    # a contiguous view that starts 4 bytes into its buffer: no float4
    buf = _act((1, 1, 1, 1 + 4 * 64 * 64)).reshape(-1).to(cuda_device)
    x = buf[1:].view(4, 1, 64, 64)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    with torch.inference_mode():
        got = instnorm.instance_norm(x, relu=True)
    assert maxdiff(got.cpu(), instnorm.instance_norm_plain(x, relu=True)
                   .cpu()) <= K2_ATOL


def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    x = _act((2, 4, 8, 8)).to(cuda_device)
    with torch.inference_mode():
        with pytest.raises(TypeError):
            instnorm.instance_norm(x.double())
        with pytest.raises(ValueError, match="contiguous"):
            instnorm.instance_norm(x.transpose(2, 3))
        with pytest.raises(ValueError, match="NCHW"):
            instnorm.instance_norm(x[0])
        s = torch.zeros(4096, device=cuda_device)
        with pytest.raises(ValueError, match="n_fft"):
            stft.stft_magnitude(s, n_fft=512, hop=128)
        with pytest.raises(ValueError, match="1-D"):
            stft.stft_magnitude(s.view(2, 2048))
        with pytest.raises(ValueError, match="reflect"):
            stft.stft_magnitude(s[:512])
    with pytest.raises(RuntimeError, match="backward"):
        instnorm.instance_norm(x.clone().requires_grad_())


def test_launch_counters_count_kernel_launches_only(cuda_device):
    x = _act((2, 4, 8, 8)).to(cuda_device)
    s = torch.randn(4096, device=cuda_device)
    k1, k2 = stft.stft_magnitude.launches, instnorm.instance_norm.launches
    with torch.inference_mode():
        instnorm.instance_norm(x)
        instnorm.instance_norm(x, relu=True)
        stft.stft_magnitude(s)
        instnorm.instance_norm_plain(x)
        stft_plain(s)
        instnorm.instance_norm(x.cpu())
    assert instnorm.instance_norm.launches == k2 + 2
    assert stft.stft_magnitude.launches == k1 + 1


def test_small_renderer_card_matches_host(cuda_device):
    import copy

    from animateportrait_tpu_torch.models.flowunet import FlowUnet
    from animateportrait_tpu_torch.models.gan import (
        ResnetStyle2Generator, TridentGeneratorFullIFW)
    from animateportrait_tpu_torch.models.modnet import MODNet
    from animateportrait_tpu_torch.pipeline.render import Module2Renderer
    from animateportrait_tpu_torch.utils.smoke import init_random_

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    nets = [init_random_(n, g) for n in (
        TridentGeneratorFullIFW(output_nc=1, ngf=8, n_blocks=3, div=3,
                                disp=3),
        FlowUnet(nf=4, num_scale=3, max_nf=64), MODNet(),
        ResnetStyle2Generator(ngf=8, n_blocks=2))]
    rng = np.random.default_rng(0)
    photo = rng.uniform(-1, 1, (256, 256, 3)).astype(np.float32)
    a68 = rng.uniform(70, 190, (68, 2)).astype(np.float32)
    tb68 = a68 + rng.uniform(-2, 2, (3, 68, 2)).astype(np.float32)
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        r = Module2Renderer(*copy.deepcopy(nets), frame_batch=2, device=dev)
        with torch.inference_mode():
            outs.append(r(photo, a68, tb68))
    assert psnr(outs[0], outs[1]) >= 40.0


# Photo2Cartoon (ngf 32) planes at 256 px, down to the 16x16 hourglass
# bottom: 256 elements, one block each
@pytest.mark.parametrize("shape", [(1, 8, 256, 256), (1, 16, 128, 128),
                                   (1, 32, 16, 16), (1, 8, 16, 16),
                                   (1, 64, 128, 128), (1, 128, 64, 64)])
@pytest.mark.parametrize("relu", [False, True])
def test_k2_kernel_at_photo2cartoon_shapes(cuda_device, shape, relu):
    x = _act(shape, seed=1, offset=10.0).to(cuda_device)
    with torch.inference_mode():
        got = instnorm.instance_norm(x, relu=relu)
        want = instnorm.instance_norm_plain(x, relu=relu)
    assert maxdiff(got.cpu(), want.cpu()) <= K2_ATOL


def test_mtcnn_card_matches_host(cuda_device, tmp_path):
    import os

    from animateportrait_tpu_torch.models import mtcnn
    from animateportrait_tpu_torch.utils.smoke import write_mtcnn_weights

    d = write_mtcnn_weights(str(tmp_path / "mtcnn"))
    img = np.random.default_rng(6).uniform(0, 255, (200, 180, 3)).astype(
        np.float32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        det = mtcnn.MTCNNDetector(
            *(getattr(mtcnn, f"load_{n}")(os.path.join(d, f"{n}.npy"))
              for n in ("pnet", "rnet", "onet")), device=dev)
        outs.append(det(img))
    (bc, lc), (bh, lh) = outs
    assert bc.shape == bh.shape and len(bc) > 0
    # rounding in _to_square may move an edge by a pixel
    assert maxdiff(bc[:, :4], bh[:, :4]) <= 1.0
    assert maxdiff(lc, lh) <= 1.0


def test_photo2cartoon_and_speaker_card_match_host(cuda_device):
    import copy

    from animateportrait_tpu_torch.models.photo2cartoon import (
        Photo2CartoonGenerator)
    from animateportrait_tpu_torch.models.speaker_encoder import (
        VoiceEncoder, get_spk_emb)
    from animateportrait_tpu_torch.utils.smoke import init_random_, make_wav

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    p2c = init_random_(Photo2CartoonGenerator(ngf=8), g).eval()
    enc = init_random_(VoiceEncoder(), g).eval()
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (1, 3, 64, 64)).astype(np.float32))
    wav = make_wav(2.0, seed=1)
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        with torch.inference_mode():
            y = copy.deepcopy(p2c).to(dev)(x.to(dev))[0].cpu()
            e = get_spk_emb(copy.deepcopy(enc).to(dev), wav)
        outs.append((y, e))
    assert psnr(outs[0][0], outs[1][0]) >= 40.0
    assert maxdiff(outs[0][1], outs[1][1]) <= 1e-4
