"""Card-only tests of the port's CUDA kernels: each kernel against its plain
PyTorch version, the wrappers' checks and launch counters, K2's gradient
path (K2 forward, K2b backward) against autograd through the plain version,
and small runs on the card against the CPU: the renderer (drawing and
cartoon, ``render_visuals`` too), the MTCNN cascade, Photo2Cartoon, the
speaker embedding and the Module2 training step; ``test_cli.main`` and
``cli.main --video`` on the card, and the batched front end against
single calls. They skip without a CUDA device.

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


def test_small_training_grads_card_match_host(cuda_device):
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
