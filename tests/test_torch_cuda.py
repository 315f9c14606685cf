"""Card-only tests of the port's CUDA kernels: each kernel against its plain
PyTorch version, the wrappers' checks and launch counters, K2's gradient
path (K2 forward, K2b backward) against autograd through the plain version,
and small runs on the card against the CPU: the renderer (drawing and
cartoon, ``render_visuals`` too), the MTCNN cascade, Photo2Cartoon, the
speaker embedding and the Module2 training step; ``test_cli.main`` and
``cli.main --video`` on the card, the batched front end against
single calls, and one step of each Module1-side trainer (content,
speaker-aware, flow regression, image translation, pose transfer, FAN,
face_of_art) on the card against the host and a float64 host run, and
their convergence runs with no kernel launch; a few ``define_g`` /
``define_d`` nets (K2 and K2b on the card) and LPIPS card against host;
``postalign_video`` card against host; the data-parallel step of two
ranks and a renderer of two replicas, both on one card; and, one rank a
card over NCCL, the FSDP step against the data-parallel step, the
tensor-parallel generator and the sequence-parallel pos branch against one
card. They skip without a CUDA device, the last three with fewer than 2
cards.

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
    K2_SHAPES, K2_STREAM_SHAPE, k2_gradient_errors, k2_input)
from torch_port_helpers import (  # noqa: F401
    cuda_device, in_cancelled_biases, maxdiff, psnr)

pytestmark = pytest.mark.cuda

# an fp32 FFT against 1024-term fp32 sums by cuBLAS (as the JAX tests)
K1_TOL = dict(atol=2e-3, rtol=1e-3)
# fp32 statistics over up to 262144 pixels, summed in another order
K2_ATOL = 1e-5
# K2b: dx = rstd * (gy - E[gy] - xhat E[gy xhat]) with |dx| ~ 1 here; the
# two sums over up to 65536 pixels are taken in another order
K2B_ATOL = 1e-5
# K2 + K2b against float64 autograd and fp32 autograd through the plain
# version, on the function the forward computed (with ReLU, the upstream
# gradient masked by K2's output: kernel_bench.k2_gradient_errors), as
# fractions of the largest |dx|
K2B_F64_RTOL = 1e-5
K2B_PLAIN_RTOL = 1e-5
# every InstanceNorm shape of the Module2 training step at the bench
# configuration (batch 4, ngf = ndf = 64): the generator's planes, and the
# discriminators' planes of 4 (coherence D in the G pass), 8 (two stacked
# inputs) and 12 (three) images, 31 x 31 with hw % 4 != 0
TRAIN_IN_SHAPES = [
    (4, 32, 256, 256), (4, 64, 256, 256), (4, 8, 256, 256),
    (4, 128, 128, 128), (4, 64, 128, 128), (4, 16, 128, 128),
    (4, 256, 64, 64), (4, 128, 64, 64), (4, 16, 64, 64),
    (4, 128, 64, 64), (8, 128, 64, 64), (12, 128, 64, 64),
    (4, 256, 32, 32), (8, 256, 32, 32), (12, 256, 32, 32),
    (4, 512, 31, 31), (8, 512, 31, 31), (12, 512, 31, 31)]


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
        stats = instnorm.instance_norm_stats_plain(x)
        with pytest.raises(ValueError, match="stats"):
            instnorm.instance_norm_backward(x, x, stats[:4])
        with pytest.raises(ValueError, match="not x's"):
            instnorm.instance_norm_backward(x, x[:1], stats)
        with pytest.raises(ValueError, match="contiguous"):
            instnorm.instance_norm_backward(x, x.transpose(2, 3).contiguous()
                                            .transpose(2, 3), stats)


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


def _k2_grad_case(shape, relu, device, seed=0):
    """Activations, an upstream gradient and K2's saved statistics."""
    x = k2_input(shape, device, seed=seed)
    g = torch.randn(shape, generator=torch.Generator(device=device)
                    .manual_seed(seed + 1), device=device)
    stats = instnorm.empty_stats(x)
    instnorm._launch(x, torch.empty_like(x), 1e-5, relu,
                     instnorm.cluster_size(shape[2] * shape[3]), stats)
    return x, g, stats


@pytest.mark.parametrize("shape", TRAIN_IN_SHAPES)
@pytest.mark.parametrize("relu", [False, True])
def test_k2b_kernel_matches_plain(cuda_device, shape, relu):
    x, g, stats = _k2_grad_case(shape, relu, cuda_device)
    # K2's statistics are the plain version's
    assert maxdiff(stats.cpu(), instnorm.instance_norm_stats_plain(x).cpu()) \
        <= 1e-5 * float(stats.abs().max())
    got = instnorm.instance_norm_backward(x, g, stats, relu)
    want = instnorm.instance_norm_backward_plain(x, g, stats, relu)
    assert maxdiff(got.cpu(), want.cpu()) <= K2B_ATOL


@pytest.mark.parametrize("shape", TRAIN_IN_SHAPES)
@pytest.mark.parametrize("relu", [False, True])
def test_k2_gradient_path_matches_plain_autograd(cuda_device, shape, relu):
    x, g, _ = _k2_grad_case(shape, relu, cuda_device, seed=2)
    e = k2_gradient_errors(x, g, relu)
    assert e["fwd"] <= K2_ATOL
    assert e["vs_f64"] <= K2B_F64_RTOL and e["vs_plain"] <= K2B_PLAIN_RTOL


# one shape for each number of CTAs per plane K2b's dispatcher picks at the
# default budget (8 bytes an element; 0: streaming), and planes with
# hw % 4 != 0 on one CTA and split over a cluster (scalar loads)
@pytest.mark.parametrize("shape,cluster", [
    ((2, 3, 64, 64), 1), ((2, 4, 128, 128), 2), ((2, 4, 128, 256), 4),
    ((2, 4, 256, 256), 8), ((1, 2, 512, 512), 0), ((3, 5, 31, 31), 1),
    ((1, 2, 257, 255), 8)])
@pytest.mark.parametrize("relu", [False, True])
def test_k2b_every_cluster_size(cuda_device, shape, cluster, relu):
    assert instnorm.cluster_size(shape[2] * shape[3], elem_bytes=8) == cluster
    x, g, stats = _k2_grad_case(shape, relu, cuda_device, seed=3)
    got = instnorm.instance_norm_backward(x, g, stats, relu)
    want = instnorm.instance_norm_backward_plain(x, g, stats, relu)
    assert maxdiff(got.cpu(), want.cpu()) <= K2B_ATOL
    e = k2_gradient_errors(x, g, relu)
    assert e["vs_f64"] <= K2B_F64_RTOL and e["vs_plain"] <= K2B_PLAIN_RTOL


# 3 CTAs, and slices over a CTA's shared memory (2 CTAs for 512^2)
@pytest.mark.parametrize("cluster", [3, 16, -1, 2])
def test_k2b_refuses_a_cluster_it_cannot_run(cuda_device, cluster):
    x, g, stats = _k2_grad_case((1, 2, 512, 512), False, cuda_device)
    before = instnorm.instance_norm_backward.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        instnorm._launch_backward(x, g, stats, torch.empty_like(x), False,
                                  cluster)
    assert instnorm.instance_norm_backward.launches == before


def test_k2_autograd_function_only_when_grad_is_needed(cuda_device):
    x = _act((2, 4, 16, 16)).to(cuda_device)
    k2, k2b = (instnorm.instance_norm.launches,
               instnorm.instance_norm_backward.launches)
    xg = x.clone().requires_grad_()
    with torch.inference_mode():
        y = instnorm.instance_norm(x, relu=True)
    with torch.no_grad():
        y2 = instnorm.instance_norm(xg, relu=True)
    assert y.grad_fn is None and y2.grad_fn is None
    assert instnorm.instance_norm.launches == k2 + 2
    y3 = instnorm.instance_norm(x, relu=True)          # needs no grad
    assert y3.grad_fn is None
    y4 = instnorm.instance_norm(xg, relu=True)
    assert type(y4.grad_fn).__name__ == "InstanceNormK2Backward"
    assert instnorm.instance_norm.launches == k2 + 4
    assert instnorm.instance_norm_backward.launches == k2b
    y4.sum().backward()
    assert instnorm.instance_norm_backward.launches == k2b + 1
    assert maxdiff(y4.detach().cpu(), y.cpu()) == 0.0


def test_full_width_training_step_on_the_card(cuda_device):
    """One step of the bench configuration (crop 256, ngf = ndf = 64,
    batch 4, stacked D passes): finite losses, both nets moved, every
    InstanceNorm forward through K2 and every backward through K2b."""
    from animateportrait_tpu_torch.train import module2 as m2

    cfg = m2.Module2Config(batch_d_passes=True)
    state = m2.init_state(cfg, torch.Generator().manual_seed(0), cuda_device)
    frozen = m2.init_frozen_random(torch.Generator().manual_seed(1),
                                   cuda_device)
    batch = m2.make_random_batch(cfg, 4, torch.Generator(
        device=cuda_device).manual_seed(2), cuda_device)
    g0 = next(state.g.parameters()).detach().clone()
    d0 = next(state.d.parameters()).detach().clone()
    k2, k2b = (instnorm.instance_norm.launches,
               instnorm.instance_norm_backward.launches)
    metrics = m2.build_train_step(cfg).step(state, batch, frozen,
                                            torch.Generator().manual_seed(3))
    assert all(np.isfinite(float(v)) for v in metrics.values())
    with torch.no_grad():
        assert float((next(state.g.parameters()) - g0).abs().max()) > 0
        assert float((next(state.d.parameters()) - d0).abs().max()) > 0
    assert state.pool_count == 8
    # G: 2 forwards of 38 INs; Ds: 5 stacked passes of 3 INs in the G pass
    # and 5 in the D pass; MODNet: 16 INs, inference only
    assert instnorm.instance_norm_backward.launches - k2b == 2 * 38 + 30
    assert instnorm.instance_norm.launches - k2 == 2 * 38 + 30 + 16


@pytest.fixture()
def tf32_off():
    """cuDNN's and matmul's TF32 off for the test, the caller's after."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags


def test_small_training_grads_card_match_host(cuda_device, tf32_off):
    from animateportrait_tpu_torch.train import module2 as m2

    cfg = m2.Module2Config(crop_size=64, ngf=8, ndf=8, steps_per_epoch=2,
                           pool_size=4)
    batch = m2.make_random_batch(cfg, 1, torch.Generator().manual_seed(2),
                                 "cpu")
    out = {}
    for where in (cuda_device, torch.device("cpu")):
        state = m2.init_state(cfg, torch.Generator().manual_seed(0), where)
        frozen = m2.init_frozen_random(torch.Generator().manual_seed(1),
                                       where)
        out[where.type] = m2.build_train_step(cfg).grads(
            state, {k: v.to(where) for k, v in batch.items()}, frozen,
            torch.Generator().manual_seed(3))
    c, h = out["cuda"], out["cpu"]
    for k, v in h.metrics.items():
        np.testing.assert_allclose(float(c.metrics[k]), float(v), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    for net in ("g", "d"):
        host, card = getattr(h, net), getattr(c, net)
        gscale = max(float(v.abs().max()) for v in host.values())
        errs = {k: float((card[k].cpu() - v).abs().max() / v.abs().max())
                for k, v in host.items() if float(v.abs().max()) > 1e-5 * gscale}
        over = {k: e for k, e in errs.items() if e > 1e-3}
        assert len(over) <= 2 and all(e <= 5e-2 for e in over.values()), over
    assert c.pool_count == h.pool_count == 2


# The graphed Module2 step against the eager step from the same state, with
# cuDNN deterministic and TF32 off (the forward is then the same bit for
# bit): each leaf's gap over the larger of its scale and the median leaf's,
# for both Adam moments and each parameter's update. What is left apart is
# the backward's atomic adds (reflection padding, grid sampling), which
# the eager step also shows against itself: on an H100, over the 30 steps
# below, up to 2.8e-4 eager against eager and 1.9e-4 to 6.7e-4 graphed
# against eager in five runs (a parameter's update), a heavy tail. A fault
# (a stale input, another learning rate, a moment updated twice) reads
# O(1); a stale batch or pool plan also breaks the bit-for-bit checks.
GRAPH_LEAF_RTOL = 1e-2


@pytest.fixture()
def deterministic_fp32():
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags


def _graph_setup(device, batch_sizes=(1,)):
    from animateportrait_tpu_torch.train import module2 as m2

    # two queries of one image a step fill the 50 slots at step 25
    cfg = m2.Module2Config(crop_size=64, ngf=8, ndf=8)
    state = m2.init_state(cfg, torch.Generator().manual_seed(0), device)
    frozen = m2.init_frozen_random(torch.Generator().manual_seed(1), device)
    batches = [m2.make_random_batch(cfg, n, torch.Generator(
        device=device).manual_seed(2 + i), device)
        for i, n in enumerate(batch_sizes)]
    return m2, cfg, state, frozen, batches


def _scaled_gaps(got: dict, want: dict) -> dict:
    """Each leaf's largest gap over max(its largest value, the median
    leaf's)."""
    scale = {k: float(v.abs().max()) for k, v in want.items()}
    median = float(np.median(list(scale.values())))
    return {k: float((got[k] - v).abs().max()) / max(scale[k], median, 1e-30)
            for k, v in want.items()}


def _check_step_against_eager(m2, cfg, before, after, batch, frozen,
                              draws, losses):
    """One eager step (``grads`` then ``apply_grads``) from ``before`` (a
    copy of the state the graphed step started from), on the graphed
    step's batch and pool draws, against the graphed step's ``losses``
    and the state it left, ``after``: the losses, the pool, its count and
    the step counts bit for bit; returns the worst scaled gap of each
    net's moments and updates. The biases an InstanceNorm follows carry
    no gradient in exact arithmetic, and Adam turns their rounding noise
    into steps of up to lr either way: their updates are left out."""
    gen = torch.Generator()
    gen.set_state(draws)
    start = {(key, k): p.detach().clone() for key in ("g", "d")
             for k, p in getattr(before, key).named_parameters()}
    eager = m2.build_train_step(cfg)
    grads = eager.grads(before, batch, frozen, gen)
    eager.apply_grads(before, grads)
    for k, v in grads.metrics.items():
        assert torch.equal(v, losses[k]), (k, float(v), float(losses[k]))
    assert torch.equal(before.pool, after.pool)
    assert (before.pool_count, before.step) == (after.pool_count,
                                                after.step)
    gaps = {}
    for key in ("g", "d"):
        net_e, net_g = getattr(before, key), getattr(after, key)
        opt_e, opt_g = (getattr(before, f"{key}_opt"),
                        getattr(after, f"{key}_opt"))
        params_g = dict(net_g.named_parameters())
        for m in ("exp_avg", "exp_avg_sq"):
            got, want = {}, {}
            for name, p in net_e.named_parameters():
                st_e, st_g = opt_e.state[p], opt_g.state[params_g[name]]
                assert float(st_e["step"]) == float(st_g["step"]) \
                    == after.step
                got[name], want[name] = st_g[m], st_e[m]
            gaps[f"{key}.{m}"] = max(_scaled_gaps(got, want).values())
        noise = in_cancelled_biases(net_e)
        upd_e = {n: p.detach() - start[(key, n)]
                 for n, p in net_e.named_parameters() if n not in noise}
        upd_g = {n: params_g[n].detach() - start[(key, n)] for n in upd_e}
        gaps[f"{key}.update"] = max(_scaled_gaps(upd_g, upd_e).values())
    return gaps


def test_graphed_module2_step_matches_the_eager_step(cuda_device,
                                                     deterministic_fp32):
    """30 single-card steps replayed from one CUDA graph with no
    synchronize between them, across the pool's fill at step 25. Each is
    held against the eager step from a copy of the state it started from,
    on its batch and pool draws: the losses, the pool, its count and the
    step count bit for bit (with cuDNN deterministic the forward is the
    same), both Adams' moments and each parameter's update within
    GRAPH_LEAF_RTOL. The eager step's backward is not repeatable bit for
    bit on the card, and 30 steps of Adam make that tens of percent of a
    leaf between two eager runs, so the comparison is made step by step.
    The first step is the graph's eager warm-up, held against the step as
    it was before (Adam not yet capturable)."""
    import copy

    m2, cfg, state, frozen, batches = _graph_setup(
        cuda_device, batch_sizes=(1, 1, 1))
    step = m2.build_train_step(cfg)
    gen = torch.Generator().manual_seed(3)
    before, draws, losses = [], [], []
    for k in range(30):
        before.append(copy.deepcopy(state))
        draws.append(gen.get_state())
        losses.append(step.step(state, batches[k % 3], frozen, gen))
    after = before[1:] + [state]
    assert state.pool_count == cfg.pool_size == 50 and state.step == 30
    assert before[25].pool_count == 50 and before[24].pool_count == 48
    worst = {}
    for k in range(30):
        gaps = _check_step_against_eager(m2, cfg, before[k], after[k],
                                         batches[k % 3], frozen, draws[k],
                                         losses[k])
        worst = {n: max(g, worst.get(n, 0.0)) for n, g in gaps.items()}
    print("graphed against eager, worst scaled gaps:", worst)
    assert max(worst.values()) <= GRAPH_LEAF_RTOL, worst


def test_graphed_module2_step_takes_a_graph_per_batch_layout(
        cuda_device, deterministic_fp32):
    """A second batch shape captures its own graph, which replays the step
    (its losses and pool bit for bit those of the eager step from the
    same state); a third, past ``MAX_GRAPHS``, steps eagerly."""
    import copy

    from animateportrait_tpu_torch.utils import observe

    m2, cfg, state, frozen, (b1, b2, b3) = _graph_setup(
        cuda_device, batch_sizes=(1, 2, 3))
    assert m2.MAX_GRAPHS == 2
    step = m2.build_train_step(cfg)
    gen = torch.Generator().manual_seed(3)
    with observe.profile_trace():
        for b in (b1, b1, b1, b2, b2):
            step.step(state, b, frozen, gen)
        copied, draws = copy.deepcopy(state), gen.get_state()
        losses = step.step(state, b2, frozen, gen)
        stepped = copy.deepcopy(state)
        for b in (b1, b3, b3):
            step.step(state, b, frozen, gen)
        counts = observe.counters()
    assert counts["m2.graph_capture"] == 2
    assert counts["m2.graph_replay"] == 2 + 2 + 1
    # each layout's warm-up and capture, and the two eager steps
    assert counts["m2.conv_autotune"] == 2 + 2 + 2
    assert state.step == 9
    assert state.pool_count == 2 * (4 * 1 + 3 * 2 + 2 * 3)
    gaps = _check_step_against_eager(m2, cfg, copied, stepped, b2, frozen,
                                     draws, losses)
    assert max(gaps.values()) <= GRAPH_LEAF_RTOL, gaps


def test_graphed_module2_step_counts_under_profile_trace(cuda_device,
                                                         tmp_path):
    """Inside ``profile_trace``: one capture and a replay for every later
    step, the convolutions measured in the warm-up and the capture and in
    no replay, a ``m2.step`` and a ``m2.pool_fetch`` span a step, and the
    replays' kernels in the trace, K2 and K2b among them."""
    import json

    from animateportrait_tpu_torch.utils import observe

    m2, cfg, state, frozen, (b1,) = _graph_setup(cuda_device)
    step = m2.build_train_step(cfg)
    gen = torch.Generator().manual_seed(3)
    with observe.profile_trace(str(tmp_path)) as path:
        for _ in range(6):
            metrics = step.step(state, b1, frozen, gen)
        counts = observe.counters()
        names = [s[0] for s in observe.spans()]
    assert counts == {"m2.graph_capture": 1, "m2.graph_replay": 5,
                      "m2.conv_autotune": 2}
    assert names.count("m2.step") == names.count("m2.pool_fetch") == 6
    assert all(np.isfinite(float(v)) for v in metrics.values())
    with open(path) as f:
        kernels = [e["name"] for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel"]
    assert any("instance_norm_bwd" in k for k in kernels)
    assert sum("instance_norm" in k and "bwd" not in k
               for k in kernels) >= 6 * (2 * 38 + 16)


def test_checkpoint_of_a_graphed_state_resumes_anywhere(
        cuda_device, deterministic_fp32, tmp_path):
    """A checkpoint written after graphed steps (Adam ``capturable``, its
    ``step`` counts on the card) resumes on the host, where Adam refuses
    a capturable group, and on the card, where the restored state takes a
    graph of its own: its next step's losses are the live state's, bit for
    bit."""
    from animateportrait_tpu_torch.io.checkpoint import CheckpointManager

    m2, cfg, state, frozen, (b1,) = _graph_setup(cuda_device)
    step = m2.build_train_step(cfg)
    gen = torch.Generator().manual_seed(3)
    for _ in range(3):
        step.step(state, b1, frozen, gen)
    assert all(g["capturable"] for g in state.g_opt.param_groups)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.save(state.step, state, force=True)
    host = mgr.restore(None, m2.init_state(
        cfg, torch.Generator().manual_seed(9), "cpu"))
    assert host.step == 3 and not any(
        g["capturable"] for opt in (host.g_opt, host.d_opt)
        for g in opt.param_groups)
    host_frozen = m2.init_frozen_random(torch.Generator().manual_seed(1),
                                        "cpu")
    draws = gen.get_state()
    metrics = m2.build_train_step(cfg).step(
        host, {k: v.cpu() for k, v in b1.items()}, host_frozen,
        torch.Generator().manual_seed(4))
    assert host.step == 4
    assert all(np.isfinite(float(v)) for v in metrics.values())
    card = mgr.restore(None, m2.init_state(
        cfg, torch.Generator().manual_seed(9), cuda_device))
    outs = []
    for s in (state, card):
        gen.set_state(draws)
        outs.append(step.step(s, b1, frozen, gen))
    for k, v in outs[0].items():
        assert torch.equal(v, outs[1][k]), k
    assert card.step == state.step == 4


def test_train_cli_one_step_on_the_card(cuda_device, tmp_path):
    """``train_cli.main`` on ``cuda`` for one step over a small synthetic
    UMLVD-IFW tree, with two loader worker processes: K2 and K2b launch,
    the loss log and the step-1 checkpoint are written."""
    from animateportrait_tpu_torch import train_cli
    from animateportrait_tpu_torch.utils.smoke import write_umlvd_tree

    root = write_umlvd_tree(str(tmp_path / "data"), size=96, seed=0,
                            png_filter=4)
    k2, k2b = (instnorm.instance_norm.launches,
               instnorm.instance_norm_backward.launches)
    res = train_cli.main([
        "--dataroot", root, "--checkpoints_dir", str(tmp_path / "ck"),
        "--name", "smoke", "--output_nc", "1", "--ngf", "8", "--ndf", "8",
        "--load_size", "72", "--crop_size", "64", "--batch_size", "2",
        "--num_threads", "2", "--max_steps", "1", "--print_freq", "1",
        "--display_freq", "1", "--frozen_dir", str(tmp_path / "none"),
        "--device", "cuda"])
    assert res.state.step == 1 and next(res.state.g.parameters()).is_cuda
    assert instnorm.instance_norm.launches > k2
    assert instnorm.instance_norm_backward.launches > k2b
    exp = tmp_path / "ck" / "smoke"
    assert "iters: 1," in (exp / "loss_log.txt").read_text()
    assert (exp / "checkpoints" / "1.pt").exists()
    assert len(list((exp / "web" / "images").iterdir())) == 11


def test_remat_grads_match_on_the_card(cuda_device):
    """``remat`` recomputes the generator forwards (K2 launches again) and
    gives the gradients of the plain step: with cuDNN's deterministic
    algorithms, each leaf within 1e-5 of its largest |g| (of the tree's for
    a bias an InstanceNorm cancels), or within twice the plain step's own
    run-to-run spread there (``F.grid_sample``'s backward adds with
    atomics)."""
    import dataclasses

    from animateportrait_tpu_torch.train import module2 as m2

    cfg = m2.Module2Config(crop_size=64, ngf=8, ndf=8, pool_size=4,
                           batch_d_passes=True)
    state = m2.init_state(cfg, torch.Generator().manual_seed(0), cuda_device)
    frozen = m2.init_frozen_random(torch.Generator().manual_seed(1),
                                   cuda_device)
    batch = m2.make_random_batch(cfg, 2, torch.Generator(
        device=cuda_device).manual_seed(2), cuda_device)

    def grads(remat):
        k2 = instnorm.instance_norm.launches
        g = m2.build_train_step(dataclasses.replace(cfg, remat=remat)).grads(
            state, batch, frozen,
            torch.Generator(device=cuda_device).manual_seed(3))
        return g, instnorm.instance_norm.launches - k2

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        (plain, n0), (again, _), (remat, n1) = (grads(False), grads(False),
                                                grads(True))
    finally:
        torch.backends.cudnn.deterministic = det
    assert n1 > n0
    for net in ("g", "d"):
        ref = getattr(plain, net)
        gscale = max(float(v.abs().max()) for v in ref.values())
        cancelled = in_cancelled_biases(getattr(state, net))
        for k, v in ref.items():
            scale = gscale if k in cancelled else float(v.abs().max())
            spread = float((getattr(again, net)[k] - v).abs().max())
            err = float((getattr(remat, net)[k] - v).abs().max())
            assert err <= max(1e-5 * scale, 2 * spread), (k, err, spread)


# --- bf16: K2 and K2b on bf16 tensors -----------------------------------------

# every bf16 InstanceNorm shape of the two bf16 paths that the fp32 lists do
# not hold already: the render decode's and the training step's planes; the
# 31 x 31 planes (hw odd), a plane of hw % 8 == 4 (14 x 14: 16-byte slices
# impossible, scalar loads), an odd plane and the streaming branch
BF16_SHAPES = sorted(set(
    [(8, 128, 128, 128), (8, 256, 64, 64), (8, 8, 256, 256),
     (8, 64, 256, 256), (1, 64, 512, 512), (1, 128, 256, 256),
     (2, 6, 14, 14), (2, 3, 5, 7), (1, 4, 1024, 1024)] + TRAIN_IN_SHAPES))


# K2b-bf16: one bf16 ulp of the largest |dx|
K2B_BF16_RTOL = 2.0 ** -7


def dx_within_bf16_ulp(got: torch.Tensor, want: torch.Tensor) -> bool:
    """|got - want| within one bf16 ulp of the largest |want|."""
    return maxdiff(got.float().cpu(), want.float().cpu()) <= \
        K2B_BF16_RTOL * float(want.float().abs().max())


def within_bf16_ulp(got: torch.Tensor, want: torch.Tensor,
                    atol: float = K2_ATOL) -> bool:
    """Every element of ``got`` within one bf16 ulp of ``want`` at its
    magnitude (the spacing of 8-bit significands), or within ``atol`` where
    that ulp is smaller than the fp32 statistics' own error (|y| < ~1e-3:
    two fp32 summation orders put y ~1e-6 apart before the rounding)."""
    w = want.detach().double().cpu()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126)))
                     - 7)
    diff = (got.detach().double().cpu() - w).abs()
    return bool((diff <= torch.clamp(ulp, min=atol)).all())


def _k2_bf16_case(shape, relu, device, seed=0):
    """bf16 activations (means up to tens of standard deviations), a bf16
    upstream gradient and K2-bf16's saved statistics."""
    x = k2_input(shape, device, seed=seed).bfloat16()
    g = torch.randn(shape, generator=torch.Generator(device=device)
                    .manual_seed(seed + 1), device=device).bfloat16()
    stats = instnorm.empty_stats(x)
    instnorm._launch(x, torch.empty_like(x), 1e-5, relu,
                     instnorm.k2_cluster(x), stats)
    return x, g, stats


@pytest.mark.parametrize("shape", BF16_SHAPES)
@pytest.mark.parametrize("relu", [False, True])
def test_k2_bf16_kernel_matches_plain(cuda_device, shape, relu):
    """Within one bf16 ulp of the plain version at every element (both
    round the same fp32 value, up to the order of the fp32 sums)."""
    x = k2_input(shape, cuda_device, seed=5).bfloat16()
    n = instnorm.instance_norm.launches_bf16
    with torch.inference_mode():
        got = instnorm.instance_norm(x, relu=relu)
        want = instnorm.instance_norm_plain(x, relu=relu)
    assert got.dtype == torch.bfloat16
    assert instnorm.instance_norm.launches_bf16 == n + 1
    assert within_bf16_ulp(got, want)


@pytest.mark.parametrize("shape", BF16_SHAPES)
@pytest.mark.parametrize("relu", [False, True])
def test_k2b_bf16_kernel_matches_plain(cuda_device, shape, relu):
    """K2-bf16's statistics are the plain version's; K2b-bf16 within one bf16
    ulp of the largest |dx| of the plain version on the same statistics."""
    x, g, stats = _k2_bf16_case(shape, relu, cuda_device)
    assert maxdiff(stats.cpu(), instnorm.instance_norm_stats_plain(x).cpu()) \
        <= 1e-5 * float(stats.abs().max())
    n = instnorm.instance_norm_backward.launches_bf16
    got = instnorm.instance_norm_backward(x, g, stats, relu)
    want = instnorm.instance_norm_backward_plain(x, g, stats, relu)
    assert got.dtype == want.dtype == torch.bfloat16
    assert instnorm.instance_norm_backward.launches_bf16 == n + 1
    assert dx_within_bf16_ulp(got, want)


# the bf16 slices: 2 bytes an element for K2 (so the 512^2 fp32 plane's 8
# CTAs become 8 of 64 KB and 256^2 takes 2), 4 for K2b; scalar paths
@pytest.mark.parametrize("shape,k2,k2b", [
    ((2, 3, 64, 64), 1, 1), ((2, 4, 256, 256), 2, 4),
    ((1, 4, 512, 512), 8, 8), ((1, 2, 1024, 1024), 0, 0),
    ((1, 2, 257, 255), 2, 4), ((3, 5, 31, 31), 1, 1)])
@pytest.mark.parametrize("relu", [False, True])
def test_bf16_every_cluster_size(cuda_device, shape, k2, k2b, relu):
    x, g, stats = _k2_bf16_case(shape, relu, cuda_device, seed=3)
    assert (instnorm.k2_cluster(x), instnorm.k2b_cluster(x)) == (k2, k2b)
    with torch.inference_mode():
        y = instnorm.instance_norm(x, relu=relu)
    want = instnorm.instance_norm_plain(x, relu=relu)
    assert within_bf16_ulp(y, want)
    got = instnorm.instance_norm_backward(x, g, stats, relu)
    want = instnorm.instance_norm_backward_plain(x, g, stats, relu)
    assert dx_within_bf16_ulp(got, want)


def test_bf16_unaligned_input_takes_scalar_loads(cuda_device):
    # a contiguous view 2 bytes into its buffer: no 16-byte bulk copies
    # and no 8-byte vectors
    buf = k2_input((1, 1, 1, 1 + 4 * 64 * 64), cuda_device).bfloat16() \
        .reshape(-1)
    x = buf[1:].view(4, 1, 64, 64)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    with torch.inference_mode():
        got = instnorm.instance_norm(x, relu=True)
    want = instnorm.instance_norm_plain(x, relu=True)
    assert within_bf16_ulp(got, want)
    gbuf = torch.randn(buf.shape, device=cuda_device).bfloat16()
    g = gbuf[1:].view(4, 1, 64, 64)
    stats = instnorm.instance_norm_stats_plain(x)
    got = instnorm.instance_norm_backward(x, g, stats, True)
    want = instnorm.instance_norm_backward_plain(x, g, stats, True)
    assert dx_within_bf16_ulp(got, want)


@pytest.mark.parametrize("relu", [False, True])
def test_k2_bf16_gradient_path_matches_plain_autograd(cuda_device, relu):
    """Autograd through K2-bf16 (K2b-bf16 in the backward) against autograd
    through the plain version: the same function in fp32, rounded once."""
    x, g, _ = _k2_bf16_case((4, 64, 128, 128), relu, cuda_device, seed=6)
    xk = x.clone().requires_grad_()
    xp = x.clone().requires_grad_()
    dk = torch.autograd.grad(instnorm.instance_norm(xk, relu=relu), xk, g)[0]
    dp = torch.autograd.grad(instnorm.instance_norm_plain(xp, relu=relu), xp,
                             g)[0]
    assert dk.dtype == dp.dtype == torch.bfloat16
    assert dx_within_bf16_ulp(dk, dp)


def test_bf16_counters_and_dtype_checks(cuda_device):
    x = _act((2, 4, 8, 8)).to(cuda_device)
    f32, b16 = (instnorm.instance_norm.launches,
                instnorm.instance_norm.launches_bf16)
    with torch.inference_mode():
        instnorm.instance_norm(x)
        instnorm.instance_norm(x.bfloat16(), relu=True)
        instnorm.instance_norm_plain(x.bfloat16())
        with pytest.raises(TypeError, match="bfloat16"):
            instnorm.instance_norm(x.half())
        stats = instnorm.instance_norm_stats_plain(x)
        with pytest.raises(ValueError, match="not x's"):
            instnorm.instance_norm_backward(x.bfloat16(), x, stats)
    assert instnorm.instance_norm.launches == f32 + 1
    assert instnorm.instance_norm.launches_bf16 == b16 + 1


def test_small_bf16_renderer_card_matches_host(cuda_device):
    """``use_bf16`` on the card (K2-bf16) and on the CPU (its plain
    version): two bf16 renders of the same nets, each ~39 dB from fp32 on
    the CPU at these widths (tests/test_torch_bf16_render.py), so held to
    30 dB of each other; K2-bf16 launches, and fp32 K2 for MODNet."""
    import copy

    from animateportrait_tpu_torch.models.flowunet import FlowUnet
    from animateportrait_tpu_torch.models.gan import (
        ResnetStyle2Generator, TridentGeneratorFullIFW)
    from animateportrait_tpu_torch.models.modnet import MODNet
    from animateportrait_tpu_torch.pipeline.render import Module2Renderer
    from animateportrait_tpu_torch.utils.smoke import init_random_

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
    f32, b16 = (instnorm.instance_norm.launches,
                instnorm.instance_norm.launches_bf16)
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        r = Module2Renderer(*copy.deepcopy(nets), frame_batch=2, device=dev,
                            use_bf16=True)
        with torch.inference_mode():
            outs.append(r(photo, a68, tb68))
    assert instnorm.instance_norm.launches > f32
    assert instnorm.instance_norm.launches_bf16 > b16
    assert outs[0].dtype == np.float32 and np.isfinite(outs[0]).all()
    assert psnr(outs[0], outs[1]) >= 30.0


def test_bf16_training_step_on_the_card(cuda_device):
    """One bf16 step at the small configuration: every InstanceNorm forward
    through K2-bf16 and every backward through K2b-bf16, finite losses
    within 2e-2 of the host's bf16 step, fp32 masters that move."""
    from animateportrait_tpu_torch.train import module2 as m2

    cfg = m2.Module2Config(crop_size=64, ngf=8, ndf=8, pool_size=4,
                           compute_dtype="bfloat16")
    batch = m2.make_random_batch(cfg, 1, torch.Generator().manual_seed(2),
                                 "cpu")
    out = {}
    counts = (instnorm.instance_norm.launches,
              instnorm.instance_norm_backward.launches,
              instnorm.instance_norm.launches_bf16,
              instnorm.instance_norm_backward.launches_bf16)
    for where in (cuda_device, torch.device("cpu")):
        state = m2.init_state(cfg, torch.Generator().manual_seed(0), where)
        frozen = m2.init_frozen_random(torch.Generator().manual_seed(1),
                                       where)
        g0 = next(state.g.parameters()).detach().clone()
        out[where.type] = m2.build_train_step(cfg).step(
            state, {k: v.to(where) for k, v in batch.items()}, frozen,
            torch.Generator().manual_seed(3))
        assert {p.dtype for p in state.g.parameters()} == {torch.float32}
        assert float((next(state.g.parameters()) - g0).abs().max()) > 0
    now = (instnorm.instance_norm.launches,
           instnorm.instance_norm_backward.launches,
           instnorm.instance_norm.launches_bf16,
           instnorm.instance_norm_backward.launches_bf16)
    assert now[:2] == counts[:2]                  # no fp32 InstanceNorm
    assert now[2] > counts[2] and now[3] > counts[3]
    for k, v in out["cpu"].items():
        assert np.isfinite(float(out["cuda"][k])), k
        np.testing.assert_allclose(float(out["cuda"][k]), float(v),
                                   rtol=2e-2, err_msg=k)


# --- the rest of the inference surface: test_cli, --video, the batched
# front end --------------------------------------------------------------


def _small_renderer_nets():
    from animateportrait_tpu_torch.models.flowunet import FlowUnet
    from animateportrait_tpu_torch.models.gan import (
        ResnetStyle2Generator, TridentGeneratorFullIFW)
    from animateportrait_tpu_torch.models.modnet import MODNet
    from animateportrait_tpu_torch.utils.smoke import init_random_

    g = torch.Generator().manual_seed(0)
    return [init_random_(n, g) for n in (
        TridentGeneratorFullIFW(output_nc=1, ngf=8, n_blocks=3, div=3,
                                disp=3),
        FlowUnet(nf=4, num_scale=3, max_nf=64), MODNet(),
        ResnetStyle2Generator(ngf=8, n_blocks=2))]


def test_render_visuals_card_matches_host(cuda_device):
    """Every float visual of a 3-frame render_visuals batch at PSNR >= 40
    dB between the card (K2) and the CPU (its plain version)."""
    import copy

    from animateportrait_tpu_torch.pipeline.render import Module2Renderer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nets = _small_renderer_nets()
    rng = np.random.default_rng(0)
    photo = rng.uniform(-1, 1, (256, 256, 3)).astype(np.float32)
    a68 = rng.uniform(70, 190, (68, 2)).astype(np.float32)
    tb68 = a68 + rng.uniform(-2, 2, (3, 68, 2)).astype(np.float32)
    launches = instnorm.instance_norm.launches
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        r = Module2Renderer(*copy.deepcopy(nets), frame_batch=2, device=dev)
        with torch.inference_mode():
            outs.append(r.render_visuals(photo, a68, tb68))
    assert instnorm.instance_norm.launches > launches
    card, host = outs
    assert set(card) == set(host) and card["fake_B"].shape == (3, 256, 256, 1)
    for k in card:
        if k in ("warp_motion", "iw_flow"):
            assert maxdiff(card[k], host[k]) <= 1e-3, k
        else:
            assert psnr(card[k], host[k]) >= 40.0, k


def test_test_cli_on_the_card(cuda_device, tmp_path, monkeypatch):
    """test_cli.main with --device cuda (the default) over a seeded driver
    layout at generator ngf 8: the nine visuals of each frame, the index,
    K2 launches."""
    import os

    from animateportrait_tpu_torch import test_cli
    from animateportrait_tpu_torch.utils.smoke import write_test_layout

    db = write_test_layout(str(tmp_path), n_frames=3, size=256)
    monkeypatch.chdir(tmp_path)
    launches = instnorm.instance_norm.launches
    res = test_cli.main(
        f"--dataroot {db} --name formal/drawing --netg_resb_disp 3 "
        f"--output_nc 1 --ngf 8 --epoch 70 --num_test 3 --serial_batches "
        f"--imagefolder {db} --frame_batch 2 --checkpoints_dir none "
        f"--results_dir {tmp_path / 'res'}".split())
    assert instnorm.instance_norm.launches > launches
    assert len(os.listdir(res.image_dir)) == 3 * 9
    assert os.path.exists(res.index)


def test_video_cli_on_the_card(cuda_device, tmp_path):
    """cli.main --video (no --audio: the clip's 16 kHz track) on the card at
    small widths: K1 once, K2, the AVI under frame-audio/."""
    from animateportrait_tpu_torch import cli
    from animateportrait_tpu_torch.utils import video
    from animateportrait_tpu_torch.utils.smoke import (
        make_wav, write_mtcnn_weights)

    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (70, 160, 144, 3), np.uint8)
    avi = video.mux_avi(str(tmp_path / "clip.avi"), frames,
                        make_wav(1.2, seed=2))
    write_mtcnn_weights(str(tmp_path / "ckpt" / "mtcnn"))
    k1, k2 = stft.stft_magnitude.launches, instnorm.instance_norm.launches
    res = cli.main(["--video", avi, "--ckpt_dir", str(tmp_path / "ckpt"),
                    "--output", str(tmp_path / "out"), "--ngf", "8",
                    "--flow_nf", "4", "--static_ngf", "8", "--frame_batch",
                    "4"])
    assert stft.stft_magnitude.launches == k1 + 1
    assert instnorm.instance_norm.launches > k2
    assert res.path.endswith("frame-audio/output_formal_drawing.avi")
    assert video.read_avi(res.path)["frames"].shape[0] == res.frames > 0


def test_batched_front_end_matches_single_calls_on_the_card(cuda_device,
                                                            tmp_path):
    """detect_faces_batch against single calls (the same faces; boxes,
    five points and scores within 1e-3) and the batched landmark predictor
    against the single one (max |diff| <= 1e-4), on the card."""
    import os

    from animateportrait_tpu_torch.models import mtcnn
    from animateportrait_tpu_torch.models.audio2landmark import (
        Audio2landmarkContent, Audio2landmarkPos)
    from animateportrait_tpu_torch.pipeline.batch import (
        BatchedLandmarkPredictor, detect_faces_batch)
    from animateportrait_tpu_torch.pipeline.landmark import LandmarkPredictor
    from animateportrait_tpu_torch.utils.smoke import (
        init_random_, write_mtcnn_weights)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    d = write_mtcnn_weights(str(tmp_path / "mtcnn"))
    det = mtcnn.MTCNNDetector(*(getattr(mtcnn, f"load_{n}")(
        os.path.join(d, f"{n}.npy")) for n in ("pnet", "rnet", "onet")),
        device=cuda_device)
    imgs = np.random.default_rng(6).uniform(0, 255, (3, 200, 180, 3)).astype(
        np.float32)
    for (bb, bl), img in zip(detect_faces_batch(det, imgs), imgs):
        sb, sl = det(img)
        assert bb.shape == sb.shape
        if len(sb):
            assert maxdiff(bb[:, :4], sb[:, :4]) <= 1e-3
            assert maxdiff(bl, sl) <= 1e-3
            assert maxdiff(bb[:, 4], sb[:, 4]) <= 1e-3
    g = torch.Generator().manual_seed(0)
    pred = LandmarkPredictor(init_random_(Audio2landmarkPos(), g),
                             init_random_(Audio2landmarkContent(), g),
                             device=cuda_device)
    rng = np.random.default_rng(2)
    wins = [rng.standard_normal((T, 18, 80)).astype(np.float32)
            for T in (60, 60, 33)]
    embs = [rng.standard_normal(256).astype(np.float32) for _ in wins]
    fids = [rng.normal(0, 0.1, (1, 204)).astype(np.float32) for _ in wins]
    got = BatchedLandmarkPredictor(pred)(wins, embs, fids)
    with torch.inference_mode():
        for w, e, f, out in zip(wins, embs, fids, got):
            assert maxdiff(out, pred(w, e, f)) <= 1e-4


@pytest.mark.parametrize("name", ["content", "speaker", "flow", "imtrans",
                                  "pose", "fan", "foa"])
def test_module1_trainer_step_card_vs_host(cuda_device, name):
    """One step at the small width on the card and on the host from the
    same weights and batch: the metrics within rtol 1e-4 (PSNR within 0.01
    dB) in fp32 and in float64; every gradient leaf of the float64 step
    within 1e-3 of its scale of the host's, with no fallback (fp32
    gradients can differ by a kink flip at random weights:
    chip_smoke.py:phase13_parity); and no launch of the port's kernels."""
    from animateportrait_tpu_torch.ops.instnorm import (
        instance_norm, instance_norm_backward)
    from animateportrait_tpu_torch.ops.stft import stft_magnitude
    from animateportrait_tpu_torch.utils.smoke import (
        cancelled_biases, grad_parity, trainer_smoke)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    before = (stft_magnitude.launches, instance_norm.launches,
              instance_norm_backward.launches)
    card, host, card64, host64 = (
        trainer_smoke(name, d, small=True, dtype=dt)
        for d, dt in ((cuda_device, torch.float32), ("cpu", torch.float32),
                      (cuda_device, torch.float64), ("cpu", torch.float64)))
    for got, want in ((card, host), (card64, host64)):
        mc, mh = got.step(), want.step()
        for k, v in mh.items():
            bar = 0.01 if k == "PSNR" else 1e-4 * abs(v)
            assert abs(mc[k] - v) <= bar, k
    noise = {f"{n}.{b}" for n, net in host.nets.items()
             for b in cancelled_biases(net)}
    errs = grad_parity(card64.grads(), host64.grads(), None, noise)
    assert max(errs.values()) <= 1e-3
    assert (stft_magnitude.launches, instance_norm.launches,
            instance_norm_backward.launches) == before


def test_module1_convergence_runs_fall_on_the_card(cuda_device):
    """``train.convergence`` on the card for 20 steps: every metric falls."""
    from animateportrait_tpu_torch.train import convergence

    rows = convergence.run_all(20, cuda_device, say=lambda m: None)
    assert len(rows) == 8
    assert all(last < first for _, first, last in rows), rows


@pytest.mark.parametrize("name", ["resnet_9blocks",
                                  "resnet_9blocks_rcatland32_ifw",
                                  "resnet_9blocks_rcatland32_full_ifw2",
                                  "unet_256", "cls"])
def test_gan_extra_card_vs_host(cuda_device, name):
    """A ``define_g`` / ``define_d`` net at a small width on the card and
    on the host: K2 and K2b both launch on the card; the outputs within
    1e-4 of their scale, the loss (mean square) within rtol 1e-4 and every
    gradient leaf by ``grad_parity`` with a float64 host run
    (chip_smoke.py phase 14 runs every name)."""
    import chip_smoke as cs
    from animateportrait_tpu_torch.utils.smoke import (
        cancelled_biases, grad_parity)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = "d" if name == "cls" else "g"
    size = {"unet_256": 256, "cls": 512}.get(name, 64)
    runs = []
    for dev, dt in ((cuda_device, torch.float32), ("cpu", torch.float32),
                    ("cpu", torch.float64)):
        before = (instnorm.instance_norm.launches,
                  instnorm.instance_norm_backward.launches)
        net = cs.gan_net(kind, name, 4 if name == "unet_256" else 8).to(
            dev, dt).train()
        out = net(*cs.gan_inputs(name, size, 1 if name == "cls" else 2, dev,
                                 dt))
        loss = cs._mean_square(out)
        loss.backward()
        after = (instnorm.instance_norm.launches,
                 instnorm.instance_norm_backward.launches)
        if dev == cuda_device:
            assert after[0] > before[0] and after[1] > before[1]
        outs = out if isinstance(out, tuple) else (out,)
        runs.append(([o.detach().double().cpu() for o in outs],
                     float(loss.detach()),
                     {k: p.grad for k, p in net.named_parameters()}))
    (oc, lc, gc), (oh, lh, gh), (_, _, g64) = runs
    for a, b in zip(oc, oh):
        assert maxdiff(a, b) <= 1e-4 * float(b.abs().max())
    assert abs(lc - lh) <= 1e-4 * abs(lh)
    errs = grad_parity(gc, gh, g64, cancelled_biases(net))
    assert max(errs.values()) <= 1e-3, max(errs, key=errs.get)


@pytest.mark.parametrize("pnet", ["vgg", "alex", "squeeze"])
def test_lpips_card_vs_host(cuda_device, pnet):
    """LPIPS with seeded weights on the card and on the host: within 1e-4
    of the distance's scale, no kernel of the port launched."""
    from animateportrait_tpu_torch.models.lpips import PNetLin

    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    net = PNetLin(pnet).eval()
    a, b = (torch.rand(2, 3, 64, 64) * 2 - 1 for _ in range(2))
    before = instnorm.instance_norm.launches
    with torch.no_grad():
        want = net(a, b)
        got = net.to(cuda_device)(a.to(cuda_device), b.to(cuda_device)).cpu()
    assert maxdiff(got, want) <= 1e-4 * float(want.abs().max())
    assert instnorm.instance_norm.launches == before


def test_postalign_card_vs_host(cuda_device):
    """``postalign_video`` on the card (one frame's LK as a CUDA graph)
    against the host on a drifting 64-frame clip: tracked points within
    1e-3 px, uint8 frames within one level on at most 0.1% of the values,
    and the clip stabilized; no kernel of the port launched."""
    from animateportrait_tpu_torch.pipeline.postalign import (
        postalign_video, shift_reflect)

    rng = np.random.default_rng(0)
    base = torch.as_tensor(np.kron(rng.uniform(0, 255, (16, 16)),
                                   np.ones((8, 8))), dtype=torch.float32)
    offs = np.cumsum(rng.uniform(-1.5, 1.5, (64, 2)), axis=0)
    clip = np.stack([shift_reflect(base, torch.as_tensor(
        o, dtype=torch.float32)).numpy() for o in offs])
    clip = np.repeat(np.clip(np.round(clip), 0, 255).astype(np.uint8)[
        ..., None], 3, -1)
    before = instnorm.instance_norm.launches
    out, pts = postalign_video(clip, mask_region=(20, 20),
                               device=cuda_device, return_points=True)
    ref, ref_pts = postalign_video(clip, mask_region=(20, 20), device="cpu",
                                   return_points=True)
    assert instnorm.instance_norm.launches == before
    assert np.abs(pts - ref_pts).max() <= 1e-3
    d = np.abs(out.astype(np.int16) - ref.astype(np.int16))
    assert d.max() <= 1 and np.count_nonzero(d) <= 1e-3 * d.size
    sl = np.s_[:, 20:-20, 20:-20, :]
    drift = np.mean(np.abs(np.diff(clip[2:][sl].astype(float), axis=0)))
    stab = np.mean(np.abs(np.diff(out[sl].astype(float), axis=0)))
    assert stab < 0.5 * drift


# --- the multi-card paths on one card (several ranks over gloo) -----------


# The 2 ranks' gradients against one process's, of a leaf's scale
# (grad_parity): the ranks' batch-2 passes round otherwise than one batch-4
# pass on the card, and kinks flip, so they have read up to 5.4e-3 (G) and
# 1.23e-2 (D) on an H100. The fault the bar is for, rank 0's own half-batch
# gradients (the all-reduce left out), reads 1.92 (G) and 1.38 (D) there
# and on the CPU; the test holds it beyond the bar in the same run.
DP_LEAF_BAR = 5e-2


def test_dp_step_two_ranks_on_the_card_match_one_process(cuda_device,
                                                         tmp_path):
    """The data-parallel step of 2 ranks on this card (gloo) against the
    single-process step on the global batch of 4, at crop 64, ngf = ndf = 8,
    for 2 steps (``chip_smoke.py`` phase 16 (a) at a small width): the
    losses within rtol 1e-4, the first step's gradients by ``grad_parity``
    within ``DP_LEAF_BAR`` of each leaf's scale, and rank 0's own
    half-batch gradients (the all-reduce left out) beyond it; the ranks'
    parameters bit-equal after both steps, the first Adam update on its
    decisive elements, the pool after the first step (it only fills), K2
    and K2b launched on each rank and K2 against its plain version on its
    InstanceNorm inputs."""
    from animateportrait_tpu_torch.train import module2 as m2
    from animateportrait_tpu_torch.utils import distributed as ddp
    from animateportrait_tpu_torch.utils.smoke import (
        adam_update_parity, dp_step_rank, dp_step_run, grad_parity)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = m2.Module2Config(crop_size=64, ngf=8, ndf=8, pool_size=8,
                           steps_per_epoch=2)
    batch = {k: v.numpy() for k, v in m2.make_random_batch(
        cfg, 4, torch.Generator().manual_seed(2), "cpu").items()}
    ddp.spawn(dp_step_rank, [cuda_device] * 2, cfg, batch, 2, str(tmp_path),
              timeout=600)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    single = dp_step_run(cfg, batch, 2, cuda_device)
    half = dp_step_run(cfg, {k: v[:2] for k, v in batch.items()}, 1,
                       cuda_device)
    state = m2.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    for rec in ranks:
        assert rec["backend"] == "gloo"
        assert min(rec["launches"].values()) > 0, rec["launches"]
        assert rec["k2_err"] <= K2_ATOL
        for s in range(2):
            for k, v in single["metrics"][s].items():
                np.testing.assert_allclose(rec["metrics"][s][k], v,
                                           rtol=1e-4, err_msg=k)
        assert rec["pool_counts"] == single["pool_counts"] == [8, 8]
        assert maxdiff(rec["pools"][0], single["pools"][0]) <= 1e-4
    for net in ("g", "d"):
        noise = in_cancelled_biases(getattr(state, net))
        ref = single["grads"][0][net]
        dp = grad_parity(ranks[0]["grads"][0][net], ref, None, noise)
        fault = grad_parity(half["grads"][0][net], ref, None, noise)
        assert max(dp.values()) <= DP_LEAF_BAR < max(fault.values()), (
            net, max(dp.values()), max(fault.values()))
        for k, v in ranks[0]["params"][-1][net].items():
            assert torch.equal(v, ranks[1]["params"][-1][net][k]), k
        bound, decided = adam_update_parity(
            ranks[0]["params"][1][net], single["params"][1][net],
            single["params"][0][net], single["grads"][0][net], cfg.lr)
        assert bound <= 1.0 and decided <= 1.0, (net, bound, decided)


def test_render_dp_two_replicas_on_the_card(cuda_device):
    """Two renderer replicas on this card (``devices=[card, card]``) against
    one, 10 frames: uint8 frames at PSNR >= 40 dB (cuDNN may take other
    algorithms at 4 frames a replica than at 8), K2 launched (``chip_smoke.py``
    phase 16 (c) at a small width)."""
    import copy

    from animateportrait_tpu_torch.pipeline.render import Module2Renderer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nets = _small_renderer_nets()
    rng = np.random.default_rng(0)
    photo = rng.uniform(-1, 1, (256, 256, 3)).astype(np.float32)
    a68 = rng.uniform(70, 190, (68, 2)).astype(np.float32)
    tb68 = a68 + rng.uniform(-2, 2, (10, 68, 2)).astype(np.float32)
    frames = []
    for devices in (None, [cuda_device, cuda_device]):
        r = Module2Renderer(*copy.deepcopy(nets), frame_batch=8,
                            device=cuda_device, output_uint8=True,
                            data_parallel=devices is not None,
                            devices=devices)
        assert len(r.replicas) == (1 if devices is None else 2)
        launches = instnorm.instance_norm.launches
        with torch.inference_mode():
            frames.append(r(photo, a68, tb68))
        assert instnorm.instance_norm.launches > launches
    assert frames[0].shape == frames[1].shape == (10, 256, 256, 1)
    assert psnr(frames[1], frames[0], peak=255.0) >= 40.0
    # without devices: one replica on each visible card, "cuda" the
    # current one
    r = Module2Renderer(*copy.deepcopy(nets), frame_batch=7, device="cuda",
                        data_parallel=True)
    assert [d for _, _, d in r.replicas] == [
        torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    assert r.replicas[0][0] is r.g


# --- the multi-card paths one rank a card (NCCL) ---------------------------


def _cards(cuda_device, even: bool = False) -> list:
    """The visible cards, up to 4 (an even count with ``even``); skips
    with fewer than 2."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs 2 or more CUDA cards, one rank a card ({n} "
                    f"visible)")
    n = min(n, 4)
    if even or 4 % n:
        n -= n % 2
    return [torch.device("cuda", i) for i in range(n)]


def test_fsdp_step_one_rank_a_card_matches_dp(cuda_device, tmp_path):
    """The FSDP-sharded step (``train/fsdp.py``) and the data-parallel step
    at crop 64, ngf = ndf = 8 on a global batch of 4, one rank a card over
    NCCL, 2 steps: the same losses (rtol 1e-4) and first-step gradients
    within ``DP_LEAF_BAR`` of a leaf's scale (the card's default cuDNN
    algorithms are not bit-repeatable, and kinks flip: 1.6e-3 on four
    H100s), and rank 0's own slice of the batch alone (the fault the
    gather and reduce-scatter prevent) beyond it; each rank's sharded
    bytes 1/n of the unsharded ones, K2 and K2b launched and K2 against
    its plain version on every rank."""
    from animateportrait_tpu_torch.train import module2 as m2
    from animateportrait_tpu_torch.utils import distributed as ddp
    from animateportrait_tpu_torch.utils.smoke import (
        dp_step_run, fsdp_steps, grad_parity, jobs_rank)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    devices = _cards(cuda_device)
    n = len(devices)
    cfg = m2.Module2Config(crop_size=64, ngf=8, ndf=8, pool_size=16,
                           steps_per_epoch=2)
    batch = {k: v.numpy() for k, v in m2.make_random_batch(
        cfg, 4, torch.Generator().manual_seed(2), "cpu").items()}
    ddp.spawn(jobs_rank, devices,
              {"steps": (fsdp_steps, (cfg, batch, 2, 2 ** 10))},
              str(tmp_path), timeout=600)
    ranks = [torch.load(tmp_path / f"rank{r}.pt")["steps"] for r in range(n)]
    state = m2.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    alone = dp_step_run(cfg, {k: v[:4 // n] for k, v in batch.items()}, 1,
                        cuda_device)
    for net in ("g", "d"):
        fault = grad_parity(alone["grads"][0][net],
                            ranks[0]["dp"]["grads"][0][net], None,
                            in_cancelled_biases(getattr(state, net)))
        assert max(fault.values()) > DP_LEAF_BAR, (net, max(fault.values()))
    for rec in ranks:
        assert rec["backend"] == "nccl"
        dp, fs = rec["dp"], rec["fsdp"]
        for run in (dp, fs):
            assert min(run["launches"].values()) > 0, run["launches"]
            assert run["k2_err"] <= K2_ATOL
        b = fs["fsdp_bytes"]
        assert b["sharded"] * n == b["unsharded"] > 0
        for s in range(2):
            for k, v in dp["metrics"][s].items():
                np.testing.assert_allclose(fs["metrics"][s][k], v,
                                           rtol=1e-4, err_msg=k)
        for net in ("g", "d"):
            errs = grad_parity(fs["grads"][0][net], dp["grads"][0][net],
                               None, in_cancelled_biases(getattr(state, net)))
            assert max(errs.values()) <= DP_LEAF_BAR, (
                net, max(errs.values()))


def test_tp_generator_one_rank_a_card_matches_one_card(cuda_device,
                                                       tmp_path):
    """``tensor_parallel_generator`` of a trident generator (ngf 8, 3
    blocks) on a (n/2, 2) grid of cards against the generator on one card,
    4 frames at 64^2: within 1e-4, K2 launched on every rank on the channel
    slices and held to its plain version."""
    from animateportrait_tpu_torch.models.gan import TridentGeneratorFullIFW
    from animateportrait_tpu_torch.multichip import tp_run
    from animateportrait_tpu_torch.utils import distributed as ddp
    from animateportrait_tpu_torch.utils.smoke import init_random_, jobs_rank

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    devices = _cards(cuda_device, even=True)
    kw = dict(output_nc=1, ngf=8, n_blocks=3, div=3, disp=3)
    g = init_random_(TridentGeneratorFullIFW(**kw),
                     torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    h = 64
    inputs = [rng.uniform(-1, 1, (4, c, h, h)).astype(np.float32)
              for c in (3, 1, 1)]
    inputs += [rng.uniform(-1, 1, (4, h, h, 2)).astype(np.float32),
               rng.standard_normal((4, 2, h, h)).astype(np.float32),
               np.ones((4, 1, h, h), np.float32)]
    ddp.spawn(jobs_rank, devices, {"tp": (tp_run, (
        (len(devices) // 2, 2), kw, g.state_dict(), inputs))},
        str(tmp_path), timeout=600)
    with torch.inference_mode():
        want = g.to(cuda_device).eval()(
            *(torch.as_tensor(a, device=cuda_device) for a in inputs)).cpu()
    for r in range(len(devices)):
        rec = torch.load(tmp_path / f"rank{r}.pt")["tp"]
        assert rec["backend"] == "nccl" and rec["sliced"] > 0
        assert rec["launches"]["instance_norm"] > 0
        assert rec["k2_err"] <= K2_ATOL
        assert maxdiff(rec["y"], want) <= 1e-4


def test_sp_pos_one_rank_a_card_matches_one_card(cuda_device, tmp_path):
    """``sequence_parallel_pos`` over the cards on a 64-frame segment
    against ``Audio2landmarkPos`` on one card, the attention's output
    projections scaled by ``multichip.ATTN_GAIN``: within 1e-4, and the
    first rank's frames as a sequence of their own (the fault that
    gathering keys and values across the cards prevents) beyond it."""
    from animateportrait_tpu_torch.models.audio2landmark import (
        Audio2landmarkPos)
    from animateportrait_tpu_torch.multichip import (
        SP_ATOL, first_rank_alone, gain_attention, pos_inputs, sp_run)
    from animateportrait_tpu_torch.utils import distributed as ddp
    from animateportrait_tpu_torch.utils.smoke import init_random_, jobs_rank

    torch.backends.cuda.matmul.allow_tf32 = False
    devices = _cards(cuda_device)
    sd = gain_attention(init_random_(
        Audio2landmarkPos(), torch.Generator().manual_seed(1)).state_dict())
    inputs = pos_inputs(np.random.default_rng(1), 64)
    ddp.spawn(jobs_rank, devices, {"sp": (sp_run, (sd, inputs))},
              str(tmp_path), timeout=600)
    pos = Audio2landmarkPos()
    pos.load_state_dict(sd)
    pos = pos.to(cuda_device).eval()
    args = [torch.as_tensor(a, device=cuda_device) for a in inputs]
    with torch.inference_mode():
        want = pos(*args)[0].cpu()
        alone = first_rank_alone(pos, args, len(devices)).cpu()
    assert maxdiff(alone, want[:alone.shape[0]]) > SP_ATOL
    for r in range(len(devices)):
        rec = torch.load(tmp_path / f"rank{r}.pt")["sp"]
        assert rec["backend"] == "nccl"
        assert maxdiff(rec["y"], want) <= SP_ATOL


def test_render_dp_one_replica_a_card_is_bit_equal(cuda_device):
    """A renderer with a replica on each visible card (8 frames a replica)
    against one replica on one card (frame batch 8), 20 frames, under
    cuDNN's deterministic algorithms: the same frames bit for bit, K2
    launched on each card with that card current."""
    import copy

    from animateportrait_tpu_torch.pipeline.render import Module2Renderer

    devices = _cards(cuda_device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nets = _small_renderer_nets()
    rng = np.random.default_rng(0)
    photo = rng.uniform(-1, 1, (256, 256, 3)).astype(np.float32)
    a68 = rng.uniform(70, 190, (68, 2)).astype(np.float32)
    tb68 = a68 + rng.uniform(-2, 2, (20, 68, 2)).astype(np.float32)
    frames = []
    torch.backends.cudnn.deterministic = True
    try:
        for devs in (None, devices):
            r = Module2Renderer(*copy.deepcopy(nets),
                                frame_batch=8 * (1 if devs is None
                                                 else len(devs)),
                                device=cuda_device, output_uint8=True,
                                data_parallel=devs is not None, devices=devs)
            with torch.inference_mode():
                frames.append(r(photo, a68, tb68))
    finally:
        torch.backends.cudnn.deterministic = False
    assert [d for _, _, d in r.replicas] == devices
    assert np.array_equal(frames[0], frames[1])
