"""Card-only tests of the port's CUDA kernels: each kernel against its plain
PyTorch version, the wrappers' checks and launch counters, K2's gradient
path (K2 forward, K2b backward) against autograd through the plain version,
K2 and K2b on the activations the main paths feed their InstanceNorms, and
small runs on the card against the CPU: the renderer (drawing, cartoon and
TPS grids, ``render_visuals`` too), the MTCNN cascade, Photo2Cartoon, the
speaker embedding, the mel front end, FAN3D, the av2flau converter, the
fakeB_static builder and the Module2 training step; ``cli.main`` (a photo,
``--render_bf16``, ``--warp_mode tps`` with FAN, ``--video``,
``--render_dp``), ``test_cli.main`` and ``train_cli.main`` (resumed, bf16,
JPEG photos, ``--multihost``) on the card, the batched front end against
single calls, and one step of each Module1-side trainer (content,
speaker-aware, flow regression, image translation, pose transfer, FAN,
face_of_art) on the card against the host and a float64 host run, the
face_of_art driver, and the convergence runs; every ``define_g`` /
``define_d`` net (K2 and K2b on the card), ``entry()``, Module1's
discriminators and LPIPS card against host; ``postalign_video`` card
against host; the data-parallel step of two ranks, GPipe over three ranks,
a renderer of two replicas and the multi-card dry run, all on one card;
and, one rank a card over NCCL, the FSDP step against the data-parallel
step and one process, the data-parallel and ``--multihost`` trainers,
GPipe, the tensor-parallel generator and the sequence-parallel pos branch
against one card. They skip without a CUDA device, the one-rank-a-card
ones with fewer than 2 cards.

This file imports neither JAX nor the JAX package, so it runs where JAX is
not installed; the repo's conftest imports JAX, so on such a machine run

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""
import copy
import functools
import os

import numpy as np
import pytest
import torch

from animateportrait_tpu_torch.models import gan_extra
from animateportrait_tpu_torch.ops import instnorm, stft
from animateportrait_tpu_torch.ops.spectral import stft_magnitude as stft_plain
from animateportrait_tpu_torch.utils.kernel_bench import (
    K2_BATCH_MIX, K2_BF16_RENDER_SHAPES, K2_SHAPES, K2_STREAM_SHAPE,
    k2_gradient_errors, k2_input)
from animateportrait_tpu_torch.utils.smoke import (
    _kept_instance_norm_inputs, init_random_, make_wav, write_mtcnn_weights)
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
# K2b against its plain version on the same statistics, of the largest |dx|
# (the discriminators' flat planes give |dx| up to ~100)
K2B_RTOL = 1e-5
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


def _count_instance_norms(nets) -> tuple[dict, list]:
    """Forward pre-hooks counting the InstanceNorm2d calls of ``nets`` by
    (shape, relu, recorded for the backward); remove the hooks after."""
    from animateportrait_tpu_torch.nn import InstanceNorm2d

    counts, hooks = {}, []

    def count(mod, args):
        x = args[0]
        key = (tuple(x.shape), mod.relu,
               bool(x.requires_grad and torch.is_grad_enabled()))
        counts[key] = counts.get(key, 0) + 1

    for net in nets:
        hooks += [m.register_forward_pre_hook(count) for m in net.modules()
                  if isinstance(m, InstanceNorm2d)]
    return counts, hooks


def _hold_k2_on(kept: dict, grads: bool = False) -> None:
    """K2 against its plain version on the activations a path fed its
    InstanceNorms (``kept``: (shape, relu) -> the first input of each,
    ``utils/smoke.py:_kept_instance_norm_inputs``): within K2_ATOL in fp32,
    one bf16 ulp at each element in bf16. With ``grads``, also K2's
    gradient path against float64 and plain autograd and K2b against its
    plain version on K2's statistics, of the largest |dx|, with a seeded
    upstream gradient in the inputs' dtype."""
    assert kept
    for i, ((shape, relu), x) in enumerate(sorted(kept.items())):
        bf16 = x.dtype == torch.bfloat16
        with torch.inference_mode():
            got = instnorm.instance_norm(x, relu=relu)
            want = instnorm.instance_norm_plain(x, relu=relu)
        assert (within_bf16_ulp(got, want) if bf16 else
                maxdiff(got.cpu(), want.cpu()) <= K2_ATOL), (shape, relu)
        if not grads:
            continue
        x = x.clone()
        g = torch.randn(shape, generator=torch.Generator(
            device=x.device).manual_seed(i), device=x.device).to(x.dtype)
        stats = instnorm.empty_stats(x)
        instnorm._launch(x, torch.empty_like(x), 1e-5, relu,
                         instnorm.k2_cluster(x), stats)
        dx = instnorm.instance_norm_backward(x, g, stats, relu)
        want = instnorm.instance_norm_backward_plain(x, g, stats, relu)
        e = k2_gradient_errors(x, g, relu)
        if bf16:
            assert dx_within_bf16_ulp(dx, want), (shape, relu)
            assert e["vs_f64"] <= K2B_BF16_F64_RTOL, (shape, relu, e)
            assert e["vs_plain"] <= K2B_BF16_RTOL, (shape, relu, e)
        else:
            assert maxdiff(dx.cpu(), want.cpu()) <= K2B_RTOL * float(
                want.abs().max()), (shape, relu)
            assert e["vs_f64"] <= K2B_F64_RTOL, (shape, relu, e)
            assert e["vs_plain"] <= K2B_PLAIN_RTOL, (shape, relu, e)


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


def _small_renderer(device, style: str = "drawing", **kw):
    """A ``Module2Renderer`` on ``device`` of seeded small nets, the same
    weights at every call: the trident generator at ngf 8 with 3 blocks,
    FlowUnet nf 4, MODNet, and the style's static net (the drawing net at
    ngf 8 with 2 blocks, Photo2Cartoon at ngf 8)."""
    from animateportrait_tpu_torch.models.flowunet import FlowUnet
    from animateportrait_tpu_torch.models.gan import (
        ResnetStyle2Generator, TridentGeneratorFullIFW)
    from animateportrait_tpu_torch.models.modnet import MODNet
    from animateportrait_tpu_torch.models.photo2cartoon import (
        Photo2CartoonGenerator)
    from animateportrait_tpu_torch.pipeline.render import Module2Renderer

    g = torch.Generator().manual_seed(0)
    nets = [init_random_(n, g) for n in (
        TridentGeneratorFullIFW(output_nc=1 if style == "drawing" else 3,
                                ngf=8, n_blocks=3, div=3, disp=3),
        FlowUnet(nf=4, num_scale=3, max_nf=64), MODNet())]
    if style == "drawing":
        static = init_random_(ResnetStyle2Generator(ngf=8, n_blocks=2), g)
        return Module2Renderer(*nets, static, device=device, **kw)
    static = init_random_(Photo2CartoonGenerator(ngf=8), g)
    return Module2Renderer(*nets, style=style, cartoon_g=static,
                           device=device, **kw)


def _render_inputs(frames: int, seed: int = 0):
    """A photo (256^2, [-1, 1]), its 68 points and ``frames`` targets."""
    rng = np.random.default_rng(seed)
    photo = rng.uniform(-1, 1, (256, 256, 3)).astype(np.float32)
    a68 = rng.uniform(70, 190, (68, 2)).astype(np.float32)
    tb68 = a68 + rng.uniform(-2, 2, (frames, 68, 2)).astype(np.float32)
    return photo, a68, tb68


@pytest.mark.parametrize("style,motion", [
    ("drawing", "linear"), ("cartoon", "linear"), ("drawing", "tps")])
def test_small_renderer_card_matches_host(cuda_device, style, motion):
    """3 frames at a frame batch of 2 on the card (K2) and on the CPU (its
    plain version) at PSNR >= 40 dB; on the card one K2 launch for each
    InstanceNorm call of the four nets."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    photo, a68, tb68 = _render_inputs(3)
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        r = _small_renderer(dev, style, frame_batch=2, motion_mode=motion)
        calls, hooks = _count_instance_norms(
            [r.g, r.flowunet, r.modnet, r.static_net])
        launches = instnorm.instance_norm.launches
        with torch.inference_mode():
            outs.append(r(photo, a68, tb68))
        for h in hooks:
            h.remove()
        if dev.type == "cuda":
            assert instnorm.instance_norm.launches - launches == sum(
                calls.values()) > 0
    assert psnr(outs[0], outs[1]) >= 40.0


def test_full_width_render_batch_launches_and_trace(cuda_device, tmp_path):
    """One 8-frame batch of the full-width drawing renderer (``entry()``'s
    generator, seeded nets): one K2 launch for each InstanceNorm call, by
    shape ``kernel_bench.K2_BATCH_MIX`` (the batch ``kernel_bench.py``
    times), and inside ``profile_trace`` one K2 kernel event in the Chrome
    trace for each launch."""
    import json

    from animateportrait_tpu_torch.entry import entry
    from animateportrait_tpu_torch.models.flowunet import FlowUnet
    from animateportrait_tpu_torch.models.gan import ResnetStyle2Generator
    from animateportrait_tpu_torch.models.modnet import MODNet
    from animateportrait_tpu_torch.ops.tps import triangulate_frames
    from animateportrait_tpu_torch.pipeline.render import (
        CROP_SIZE, Module2Renderer)
    from animateportrait_tpu_torch.utils.observe import profile_trace

    gen = torch.Generator().manual_seed(1)
    r = Module2Renderer(entry(cuda_device)[0], init_random_(FlowUnet(), gen),
                        init_random_(MODNet(), gen),
                        init_random_(ResnetStyle2Generator(), gen),
                        frame_batch=8, device=cuda_device)
    photo, a68, tb68 = _render_inputs(8)
    tris = torch.as_tensor(triangulate_frames(tb68, CROP_SIZE),
                           device=cuda_device)
    photo, a68, tb68 = (torch.as_tensor(v, device=cuda_device)
                        for v in (photo, a68, tb68))
    photo, a68 = photo.permute(2, 0, 1)[None].contiguous(), a68[None]
    with torch.inference_mode():
        fore, mask, static = r.prepare(photo)
        cache = r.encode(fore, a68)
        r.frames(cache, mask, static, a68, tb68, None, tris)      # warm
        calls, hooks = _count_instance_norms(
            [r.g, r.flowunet, r.modnet, r.static_net])
        launches = instnorm.instance_norm.launches
        with profile_trace(str(tmp_path)) as path:
            r.frames(cache, mask, static, a68, tb68, None, tris)
        launches = instnorm.instance_norm.launches - launches
    for h in hooks:
        h.remove()
    mix = {}
    for (shape, _, _), n in calls.items():
        mix[shape] = mix.get(shape, 0) + n
    assert mix == K2_BATCH_MIX
    assert launches == sum(K2_BATCH_MIX.values())
    with open(path) as f:
        k2 = [e for e in json.load(f)["traceEvents"]
              if e.get("cat") == "kernel"
              and "instance_norm" in e.get("name", "")]
    assert len(k2) == launches


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
    from animateportrait_tpu_torch.models import mtcnn

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


@pytest.mark.parametrize("light", [True, False])
def test_photo2cartoon_and_speaker_card_match_host(cuda_device, light):
    """Photo2Cartoon (the light head, and ``light=False``, the full head)
    at ngf 8 on a 64^2 photo at PSNR >= 40 dB, and the speaker embedding
    within 1e-4, card against host."""
    from animateportrait_tpu_torch.models.photo2cartoon import (
        Photo2CartoonGenerator)
    from animateportrait_tpu_torch.models.speaker_encoder import (
        VoiceEncoder, get_spk_emb)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    p2c = init_random_(Photo2CartoonGenerator(ngf=8, light=light,
                                              img_size=64), g).eval()
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


@pytest.mark.parametrize("path", ["render", "render_cartoon", "render_bf16",
                                  "photo2cartoon", "train_step",
                                  "train_step_bf16"])
def test_k2_matches_plain_on_path_activations(cuda_device, path):
    """K2 against its plain version on the activations a path feeds its
    InstanceNorms (the first input of each shape), at small widths: the
    renderer (drawing, cartoon, and drawing with ``use_bf16``: K2-bf16),
    Photo2Cartoon with the full head, and the Module2 training step's G
    and Ds in fp32
    and bf16 with stacked D passes, where K2's gradient path and K2b are
    held too (``_hold_k2_on``)."""
    from animateportrait_tpu_torch.train import module2 as m2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if path.startswith("render"):
        r = _small_renderer(cuda_device, "cartoon" if path.endswith(
            "cartoon") else "drawing", frame_batch=2,
            use_bf16=path == "render_bf16")
        kept, hooks = _kept_instance_norm_inputs(
            [r.g, r.flowunet, r.modnet, r.static_net])
        with torch.inference_mode():
            r(*_render_inputs(2))
    elif path == "photo2cartoon":
        from animateportrait_tpu_torch.models.photo2cartoon import (
            Photo2CartoonGenerator)

        net = init_random_(Photo2CartoonGenerator(ngf=8, light=False,
                                                  img_size=64),
                           torch.Generator().manual_seed(0)).eval()
        net = net.to(cuda_device)
        kept, hooks = _kept_instance_norm_inputs([net])
        with torch.inference_mode():
            net(torch.rand(1, 3, 64, 64, device=cuda_device) * 2 - 1)
    else:
        dtype = "bfloat16" if path.endswith("bf16") else "float32"
        cfg = m2.Module2Config(crop_size=64, ngf=8, ndf=8, pool_size=4,
                               batch_d_passes=True, compute_dtype=dtype)
        state = m2.init_state(cfg, torch.Generator().manual_seed(0),
                              cuda_device)
        frozen = m2.init_frozen_random(torch.Generator().manual_seed(1),
                                       cuda_device)
        batch = m2.make_random_batch(cfg, 2, torch.Generator(
            device=cuda_device).manual_seed(2), cuda_device)
        kept, hooks = _kept_instance_norm_inputs([state.g, state.d])
        m2.build_train_step(cfg).grads(state, batch, frozen,
                                       torch.Generator().manual_seed(3))
    for h in hooks:
        h.remove()
    dtypes = {x.dtype for x in kept.values()}
    if path == "train_step_bf16":
        assert dtypes == {torch.bfloat16}
    elif path == "render_bf16":           # the once-per-photo nets in fp32
        assert dtypes == {torch.bfloat16, torch.float32}
    _hold_k2_on(kept, grads=path.startswith("train"))


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
    assert bool(state.pool[:8].abs().sum((1, 2, 3)).gt(0).all())
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
        assert abs(float(c.metrics[k]) - float(v)) <= 1e-4 * max(
            abs(float(v)), 1e-5), k
    for net in ("g", "d"):
        host, card = getattr(h, net), getattr(c, net)
        gscale = max(float(v.abs().max()) for v in host.values())
        errs = {}
        for k, v in host.items():
            if float(v.abs().max()) > 1e-5 * gscale:
                errs[k] = float((card[k].cpu() - v).abs().max()
                                / v.abs().max())
            else:          # rounding noise on the host: so on the card
                assert float(card[k].abs().max()) <= 1e-5 * gscale, k
        over = {k: e for k, e in errs.items() if e > 1e-3}
        assert len(over) <= 2 and all(e <= 5e-2 for e in over.values()), over
    assert c.pool_count == h.pool_count == 2
    assert maxdiff(c.pool.cpu(), h.pool) <= 1e-4


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


def test_graphed_step_replays_every_instance_norm(cuda_device):
    """At the bench layout (stacked D passes, batch 4) at crop 64: the
    eager warm-up step launches K2 once for each InstanceNorm call of G,
    the Ds and MODNet and K2b once for each recorded one (counted by
    hooks), and the trace of a replayed step of the CUDA graph, in which
    no wrapper counts, holds as many K2 and K2b kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from animateportrait_tpu_torch.train import module2 as m2

    cfg = m2.Module2Config(crop_size=64, ngf=8, ndf=8, batch_d_passes=True)
    state = m2.init_state(cfg, torch.Generator().manual_seed(0), cuda_device)
    frozen = m2.init_frozen_random(torch.Generator().manual_seed(1),
                                   cuda_device)
    batch = m2.make_random_batch(cfg, 4, torch.Generator(
        device=cuda_device).manual_seed(2), cuda_device)
    step, gen = m2.build_train_step(cfg), torch.Generator().manual_seed(3)
    calls, hooks = _count_instance_norms([state.g, state.d, frozen.modnet])
    k2, k2b = (instnorm.instance_norm.launches,
               instnorm.instance_norm_backward.launches)
    step.step(state, batch, frozen, gen)                  # eager warm-up
    for h in hooks:
        h.remove()
    n_fwd = sum(calls.values())
    n_bwd = sum(n for (_, _, rec), n in calls.items() if rec)
    assert instnorm.instance_norm.launches - k2 == n_fwd
    assert instnorm.instance_norm_backward.launches - k2b == n_bwd > 0
    step.step(state, batch, frozen, gen)                  # the capture
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step.step(state, batch, frozen, gen)
        torch.cuda.synchronize()
    kernels = {"fwd": 0, "bwd": 0}
    for e in prof.key_averages():
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and "instance_norm" in e.key):
            kernels["bwd" if "instance_norm_bwd" in e.key else "fwd"] += \
                e.count
    assert kernels == {"fwd": n_fwd, "bwd": n_bwd}


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


# The graphed pose-transfer step against the eager step of a twin copied
# from the state it started from, on the same batch, with cuDNN
# deterministic and TF32 off: the losses, the BatchNorm statistics and
# their update counts bit for bit (the forward is the same); each
# parameter's gradient, both Adams' moments and each parameter's update as
# their largest gap over the larger of their scale and the median leaf's.
# What is left apart is the backward's atomic adds (the skip warps' grid
# sampling), which the eager step also shows against itself. On an H100
# over 12 steps (five runs): gradients and moments up to 5.8e-6 graphed
# against eager and 2.4e-6 eager against eager; updates up to 1.65e-4 from
# the second step on. At Adam's first step (the graph's warm-up, itself
# the eager step) an update is lr g / (|g| + eps), and an element whose
# gradient is near eps (1e-8) moves by a share of lr that its rounding
# decides: 3.2e-2 and 8.4e-2 against the twin, 9.9e-3 to 4.3e-2 eager
# against eager, on one conv weight; that step's updates are not compared.
# A fault reads O(1): a stale input or a moment updated twice in the
# moments, another learning rate or a lost update in the updates; a stale
# batch or statistic also breaks the bit-for-bit checks.
POSE_GRAPH_GRAD_RTOL = 1e-4
POSE_GRAPH_UPDATE_RTOL = 1e-2


@functools.lru_cache(maxsize=None)
def _pose_nought_leaves() -> frozenset:
    """The smoke pose trainer's leaves whose gradient is 0 in exact
    arithmetic: under 1e-9 of their net's largest in a float64 step on
    the host (the deepest downsample's BatchNorm shift, which the next
    BatchNorm on batch statistics removes; the ``conv_a`` branches of the
    two finest scales' visibility blocks, which take no gradient at these
    weights and batch). In fp32 their gradients are rounding noise, which
    Adam turns into steps of up to lr either way."""
    from animateportrait_tpu_torch.utils.smoke import trainer_smoke

    smoke = trainer_smoke("pose", "cpu", small=True, dtype=torch.float64)
    smoke.run()
    out = set()
    for key in ("g", "d"):
        grads = {n: float(p.grad.abs().max())
                 for n, p in getattr(smoke.trainer, key).named_parameters()}
        top = max(grads.values())
        out |= {f"{key}.{n}" for n, v in grads.items() if v < 1e-9 * top}
    return frozenset(out)


def _pose_setup(device, sizes):
    """The smoke pose trainer (``trainer_smoke("pose", small=True)``) and
    a seeded batch of each size: noise images, the target the source
    rolled down by 2 rows, and its keypoints moved with it."""
    from animateportrait_tpu_torch.utils.smoke import trainer_smoke

    tr = trainer_smoke("pose", device, small=True).trainer
    size, joints = tr.cfg.size, tr.cfg.joint_nc
    gen = torch.Generator().manual_seed(7)
    batches = []
    for n in sizes:
        img = torch.rand((n, 3, size, size), generator=gen) * 2 - 1
        kp = torch.rand((n, joints, 2), generator=gen) * (size - 16) + 8
        batches.append({k: v.to(device) for k, v in (
            ("img_1", img), ("img_2", img.roll(2, 2)), ("kp_1", kp),
            ("kp_2", kp + torch.tensor([0.0, 2.0])))})
    return tr, batches


def _pose_twin(tr):
    """An eager stand-in for ``tr``: its nets and optimizers deep-copied
    together (the copies' groups hold the copied parameters), stepped by
    ``_step``."""
    twin = copy.copy(tr)
    twin.g, twin.d, twin.opt_g, twin.opt_d = copy.deepcopy(
        (tr.g, tr.d, tr.opt_g, tr.opt_d))
    twin._graphs = None
    return twin


def _pose_norms(tr) -> list:
    from animateportrait_tpu_torch.nn import BatchNorm2d

    return [(f"{n}.{k}", m) for n in ("g", "d")
            for k, m in getattr(tr, n).named_modules()
            if isinstance(m, BatchNorm2d)]


def _check_pose_step_against_twin(tr, twin, start, got, want) -> dict:
    """The graphed step's losses ``got`` and the state it left in ``tr``
    against the twin's eager step from ``start`` (the parameters both
    began at): losses and BatchNorm statistics bit for bit; the worst
    scaled gap of each net's updates, gradients and moments, with its
    leaf. The biases a
    BatchNorm on batch statistics follows carry no gradient in exact
    arithmetic, and Adam turns their rounding noise into steps of up to
    lr either way: they are left out, as are the other leaves whose
    gradient is 0 in exact arithmetic (``_pose_nought_leaves``)."""
    from animateportrait_tpu_torch.utils.smoke import cancelled_biases

    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), (k, float(got[k]),
                                              float(want[k]))
    for (name, m), (_, w) in zip(_pose_norms(tr), _pose_norms(twin)):
        for k in ("running_mean", "running_var", "num_batches_tracked"):
            assert torch.equal(getattr(m, k), getattr(w, k)), (name, k)
    gaps = {}
    for key, opt_t, opt_w in (("g", tr.opt_g, twin.opt_g),
                              ("d", tr.opt_d, twin.opt_d)):
        noise = cancelled_biases(getattr(tr, key)) | {
            n.split(".", 1)[1] for n in _pose_nought_leaves()
            if n.startswith(f"{key}.")}
        ps_t = dict(getattr(tr, key).named_parameters())
        ps_w = dict(getattr(twin, key).named_parameters())
        names = [n for n in ps_t if n not in noise]
        pairs = {
            "update": ({n: ps_t[n].detach() - start[key][n] for n in names},
                       {n: ps_w[n].detach() - start[key][n] for n in names}),
            "grad": ({n: ps_t[n].grad for n in names},
                     {n: ps_w[n].grad for n in names})}
        for mom in ("exp_avg", "exp_avg_sq"):
            pairs[mom] = ({n: opt_t.state[ps_t[n]][mom] for n in names},
                          {n: opt_w.state[ps_w[n]][mom] for n in names})
        for n in ps_t:
            assert float(opt_t.state[ps_t[n]]["step"]) \
                == float(opt_w.state[ps_w[n]]["step"])
        for what, (a, b) in pairs.items():
            leaf_gaps = _scaled_gaps(a, b)
            leaf = max(leaf_gaps, key=leaf_gaps.get)
            gaps[f"{key}.{what}"] = (leaf_gaps[leaf], leaf)
    return gaps


def _worse(worst: dict, gaps: dict) -> dict:
    """The larger (gap, leaf) of each quantity."""
    return {n: max(g, worst.get(n, (0.0, None)), key=lambda t: t[0])
            for n, g in gaps.items()}


def _assert_pose_gaps(gaps: dict) -> None:
    for n, (gap, leaf) in gaps.items():
        bar = POSE_GRAPH_UPDATE_RTOL if n.endswith(".update") \
            else POSE_GRAPH_GRAD_RTOL
        assert gap <= bar, (n, gap, leaf)


def _pose_start(tr) -> dict:
    return {key: {n: p.detach().clone()
                  for n, p in getattr(tr, key).named_parameters()}
            for key in ("g", "d")}


def test_graphed_pose_step_matches_the_eager_step(cuda_device,
                                                  deterministic_fp32):
    """12 pose-transfer steps at the small width, batch 2, over three
    batches with no synchronize between them: one warm-up, one capture,
    then replays. Each is held against the eager step of a twin copied
    from the state it started from, on its batch: the losses and every
    BatchNorm statistic and update count bit for bit, the gradients and
    Adam moments within POSE_GRAPH_GRAD_RTOL, the updates from the second
    step on within POSE_GRAPH_UPDATE_RTOL. Every BatchNorm keeps its
    statistics' tensors
    from the warm-up on. A second eager twin of each step gives the eager
    step's own spread."""
    from animateportrait_tpu_torch.utils import observe

    tr, batches = _pose_setup(cuda_device, (2, 2, 2))
    worst, spread, held = {}, {}, None
    with observe.profile_trace():
        for k in range(12):
            b = batches[k % 3]
            twin, again = _pose_twin(tr), _pose_twin(tr)
            start = _pose_start(tr)
            got = tr.step(b)
            want = twin._step(b)
            gaps = _check_pose_step_against_twin(tr, twin, start, got, want)
            if k == 0:      # Adam's first step: see POSE_GRAPH_GRAD_RTOL
                gaps = {n: g for n, g in gaps.items()
                        if not n.endswith(".update")}
            worst = _worse(worst, gaps)
            # the eager step against itself, from the same state
            gaps = _check_pose_step_against_twin(again, twin, start,
                                                 again._step(b), want)
            spread = _worse(spread, gaps)
            now = [[getattr(m, s) for s in ("running_mean", "running_var",
                                             "num_batches_tracked")]
                   for _, m in _pose_norms(tr)]
            if held is not None:
                assert all(t is u for x, y in zip(now, held)
                           for t, u in zip(x, y))
            held = now
        counts = observe.counters()
    print("graphed against eager, worst scaled gaps:", worst)
    print("eager against eager, worst scaled gaps:", spread)
    assert counts["pt.graph_capture"] == 1
    assert counts["pt.graph_replay"] == 11
    assert tr.steps == 12
    _assert_pose_gaps(worst)


def test_graphed_pose_step_takes_a_graph_per_batch_layout(
        cuda_device, deterministic_fp32):
    """Batches of 2 and 3 each capture a graph of their own; a batch of 4,
    past ``MAX_GRAPHS``, steps eagerly and binds the BatchNorms to new
    statistics. The next replay of the batch of 2 starts from those
    statistics and leaves them in the tensors the graphs hold; it and the
    replay of the batch of 3 are the eager step's from the same state,
    their gradients left in ``.grad``."""
    from animateportrait_tpu_torch.train import pose_transfer as pt
    from animateportrait_tpu_torch.utils import observe

    assert pt.MAX_GRAPHS == 2
    tr, (b2, b3, b4) = _pose_setup(cuda_device, (2, 3, 4))

    def stats():
        return [getattr(m, s) for _, m in _pose_norms(tr)
                for s in ("running_mean", "running_var",
                          "num_batches_tracked")]

    def replay_against_eager(b):
        twin, start = _pose_twin(tr), _pose_start(tr)
        got = tr.step(b)
        gaps = _check_pose_step_against_twin(tr, twin, start, got,
                                             twin._step(b))
        _assert_pose_gaps(gaps)

    with observe.profile_trace():
        tr.step(b2)                                   # warm-up
        held = stats()
        for b in (b2, b2, b2, b3, b3):
            tr.step(b)
        assert all(t is u for t, u in zip(stats(), held))
        replay_against_eager(b3)
        for b in (b2, b4, b4):
            tr.step(b)
        assert not any(t is u for t, u in zip(stats(), held))
        replay_against_eager(b2)
        assert all(t is u for t, u in zip(stats(), held))
        counts = observe.counters()
    assert counts["pt.graph_capture"] == 2
    # b2: the capture's and 4 more; b3: the capture's and 1 more
    assert counts["pt.graph_replay"] == 5 + 2
    assert tr.steps == 11
    assert len(tr._graphs.graphs) == 2


def test_graphed_pose_step_drops_its_graphs_for_a_new_learning_rate(
        cuda_device, deterministic_fp32):
    """A learning rate set between steps drops the graphs (a capture holds
    the rate it saw): the next step is a warm-up at the new rate, the one
    after a new capture."""
    from animateportrait_tpu_torch.utils import observe

    tr, (b2,) = _pose_setup(cuda_device, (2,))
    with observe.profile_trace():
        for _ in range(3):
            tr.step(b2)
        first = tr._graphs
        for group in tr.opt_g.param_groups:
            group["lr"] *= 0.5
        twin, start = _pose_twin(tr), _pose_start(tr)
        got = tr.step(b2)
        assert tr._graphs is not first
        gaps = _check_pose_step_against_twin(tr, twin, start, got,
                                             twin._step(b2))
        _assert_pose_gaps(gaps)
        tr.step(b2)
        counts = observe.counters()
    assert counts["pt.graph_capture"] == 2
    assert counts["pt.graph_replay"] == 2 + 1


# train_cli's small configuration
TRAIN_CLI_SMALL = ["--output_nc", "1", "--ngf", "8", "--ndf", "8",
                   "--load_size", "72", "--crop_size", "64",
                   "--batch_size", "2", "--num_threads", "2",
                   "--print_freq", "1"]
# one process on one card: the default --data_parallel 0 takes every
# visible card
ONE_CARD = ["--data_parallel", "1"]


def _launch_counts() -> tuple:
    """K2's, K2b's, K2-bf16's and K2b-bf16's launch counters."""
    fwd, bwd = instnorm.instance_norm, instnorm.instance_norm_backward
    return fwd.launches, bwd.launches, fwd.launches_bf16, bwd.launches_bf16


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
        "--name", "smoke", *TRAIN_CLI_SMALL, *ONE_CARD, "--max_steps", "1",
        "--display_freq", "1", "--frozen_dir", str(tmp_path / "none"),
        "--device", "cuda"])
    assert res.state.step == 1 and next(res.state.g.parameters()).is_cuda
    assert instnorm.instance_norm.launches > k2
    assert instnorm.instance_norm_backward.launches > k2b
    exp = tmp_path / "ck" / "smoke"
    assert "iters: 1," in (exp / "loss_log.txt").read_text()
    assert (exp / "checkpoints" / "1.pt").exists()
    assert len(list((exp / "web" / "images").iterdir())) == 11


def _jpeg_photos(root: str) -> None:
    """The photos of the UMLVD-IFW tree ``root`` replaced by copies of the
    committed JPEG fixture, ``Photo/<name>.jpg`` for each ``<name>.png``,
    and the files found by the photo's path (its dot image, masks and
    static stylization) renamed to ``.jpg`` beside it, their bytes still
    PNG (the readers go by the bytes, not the name)."""
    import glob
    import shutil

    from animateportrait_tpu_torch.utils.assets import ASSET_DIR

    fixture = os.path.join(ASSET_DIR, "portrait_420_rst_exif6.jpg")
    for photo in glob.glob(os.path.join(root, "Photo", "**", "*.png"),
                           recursive=True):
        stem = os.path.splitext(photo)[0]
        os.remove(photo)
        shutil.copyfile(fixture, stem + ".jpg")
        for sub in ("/Alm/MTCNN/", "/Amask/nose/", "/Amask/eyes/",
                    "/Amask/lips/", "/fakeB_static/"):
            twin = stem.replace("/Photo/", sub) + ".png"
            os.rename(twin, os.path.splitext(twin)[0] + ".jpg")


def _state_diff(a, b) -> list:
    """The names of the parts of two TrainStates' checkpoint trees that
    differ in any bit."""
    from animateportrait_tpu_torch.io.checkpoint import train_state_dict

    diff = []

    def walk(x, y, name):
        if torch.is_tensor(x):
            if not (torch.is_tensor(y) and x.shape == y.shape
                    and x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())):
                diff.append(name)
        elif isinstance(x, dict):
            if not isinstance(y, dict) or set(x) != set(y):
                diff.append(name)
            else:
                for k in x:
                    walk(x[k], y[k], f"{name}.{k}")
        elif isinstance(x, (list, tuple)):
            if not isinstance(y, (list, tuple)) or len(x) != len(y):
                diff.append(name)
            else:
                for i, (u, v) in enumerate(zip(x, y)):
                    walk(u, v, f"{name}[{i}]")
        elif x != y:
            diff.append(name)

    walk(train_state_dict(a), train_state_dict(b), "state")
    return diff


def _child_processes() -> list[str]:
    """The processes whose parent is this one, as "pid command"."""
    out = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:       # it exited while we looked
            continue
        # the parent is the second field after the command in parentheses
        if int(stat.rsplit(")", 1)[1].split()[1]) == os.getpid():
            out.append(f"{pid} {cmd.strip()[:120]}")
    return out


@pytest.mark.parametrize("mode", ["resume", "bf16", "jpeg", "multihost"])
def test_train_cli_modes_on_the_card(cuda_device, tmp_path, mode):
    """``train_cli.main`` on the card for 2 steps over a small synthetic
    UMLVD-IFW tree, K2 and K2b (or K2-bf16 and K2b-bf16) launched:

    - resume: the state restored from the step-2 checkpoint equals the
      run's, bit for bit, and ``--continue_train`` resumes there to step
      3; after ``stop_worker_servers`` no process this one started runs;
    - bf16: ``--compute_dtype bfloat16``, and the checkpoint holds a bf16
      run's fp32 masters;
    - jpeg: the tree's photos replaced by the committed JPEG fixture;
    - multihost: ``--multihost 1 --num_processes 1`` (NCCL at world size
      1): one loss log of both steps, one checkpoint tree."""
    from animateportrait_tpu_torch import train_cli
    from animateportrait_tpu_torch.data.umlvd_ifw import stop_worker_servers
    from animateportrait_tpu_torch.io.checkpoint import CheckpointManager
    from animateportrait_tpu_torch.train import module2 as m2
    from animateportrait_tpu_torch.utils.distributed import free_port
    from animateportrait_tpu_torch.utils.options import to_configs
    from animateportrait_tpu_torch.utils.smoke import write_umlvd_tree

    # the fixture is 512^2: so is the tree it goes into
    root = write_umlvd_tree(str(tmp_path / "data"),
                            size=512 if mode == "jpeg" else 96, seed=0,
                            png_filter=4)
    if mode == "jpeg":
        _jpeg_photos(root)
    ck = str(tmp_path / "ck")
    argv = ["--dataroot", root, "--checkpoints_dir", ck, "--name", "run",
            *TRAIN_CLI_SMALL, *ONE_CARD, "--max_steps", "2", "--frozen_dir",
            str(tmp_path / "none"), "--device", "cuda"]
    if mode == "bf16":
        argv += ["--compute_dtype", "bfloat16"]
    if mode == "multihost":
        argv += ["--multihost", "1", "--num_processes", "1", "--process_id",
                 "0", "--coordinator_address", f"127.0.0.1:{free_port()}"]
    before = _launch_counts()
    run = train_cli.main(argv)
    launches = [a - b for a, b in zip(_launch_counts(), before)]
    assert run.state.step == 2
    assert min(launches[2:] if mode == "bf16" else launches[:2]) > 0, \
        launches
    exp = os.path.join(ck, "run")
    mgr = CheckpointManager(os.path.join(exp, "checkpoints"))
    assert mgr.all_steps()[-1] == 2
    with open(os.path.join(exp, "loss_log.txt")) as f:
        log = f.read()
    assert "iters: 2," in log
    if mode == "bf16":
        saved = mgr.restore(2, None)
        assert saved["compute_dtype"] == "bfloat16"
        assert {v.dtype for v in saved["g"].values()} == {torch.float32}
    if mode == "multihost":
        assert log.count("Training Loss") == 1 and log.count("(epoch") == 2
        assert sorted(os.listdir(ck)) == ["run"]
    if mode == "resume":
        cfg, _ = to_configs(train_cli.build_argparser().parse_args(argv))
        fresh = mgr.restore(2, m2.init_state(
            cfg, torch.Generator().manual_seed(5), cuda_device))
        assert not _state_diff(run.state, fresh)
        run2 = train_cli.main(argv + ["--max_steps", "3",
                                      "--continue_train"])
        assert run2.resumed_from == 2 and run2.state.step == 3
        with open(os.path.join(exp, "loss_log.txt")) as f:
            assert "iters: 3," in f.read()
        del run, run2, fresh
        stop_worker_servers()
        assert not _child_processes()


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

# every bf16 InstanceNorm shape of the two bf16 paths: the render decode's
# and encode_static's (kernel_bench.K2_BF16_RENDER_SHAPES) and the training
# step's planes; the 31 x 31 planes (hw odd), a plane of hw % 8 == 4
# (14 x 14: 16-byte slices impossible, scalar loads), an odd plane and the
# streaming branch
BF16_SHAPES = sorted(set(
    [(8, 128, 128, 128), (8, 256, 64, 64), (8, 8, 256, 256),
     (8, 64, 256, 256), (1, 64, 512, 512), (1, 128, 256, 256),
     (2, 6, 14, 14), (2, 3, 5, 7), (1, 4, 1024, 1024)] + TRAIN_IN_SHAPES
    + K2_BF16_RENDER_SHAPES))


# K2b-bf16: one bf16 ulp of the largest |dx|
K2B_BF16_RTOL = 2.0 ** -7
# K2 + K2b in bf16 against float64 autograd on the same bf16 inputs, of the
# largest |dx|: two bf16 ulps (each side rounds once)
K2B_BF16_F64_RTOL = 2.0 ** -6


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
    30 dB of each other and of the card's fp32 render; K2-bf16 launches,
    and fp32 K2 for MODNet, one launch for each InstanceNorm call."""
    photo, a68, tb68 = _render_inputs(3)
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        r = _small_renderer(dev, frame_batch=2, use_bf16=True)
        calls, hooks = _count_instance_norms(
            [r.g, r.flowunet, r.modnet, r.static_net])
        before = _launch_counts()
        with torch.inference_mode():
            outs.append(r(photo, a68, tb68))
        launches = [a - b for a, b in zip(_launch_counts(), before)]
        for h in hooks:
            h.remove()
        if dev.type == "cuda":
            assert launches[0] > 0 and launches[2] > 0
            assert launches[0] + launches[2] == sum(calls.values())
    assert outs[0].dtype == np.float32 and np.isfinite(outs[0]).all()
    assert psnr(outs[0], outs[1]) >= 30.0
    with torch.inference_mode():
        fp32 = _small_renderer(cuda_device, frame_batch=2)(photo, a68, tb68)
    assert psnr(outs[0], fp32) >= 30.0


def test_bf16_training_step_on_the_card(cuda_device):
    """One bf16 step at the small configuration: one K2-bf16 launch for
    each InstanceNorm call of G, the Ds and MODNet and one K2b-bf16 launch
    for each recorded one, no fp32 K2 or K2b, finite losses within 2e-2 of
    the host's bf16 step, fp32 masters that move."""
    from animateportrait_tpu_torch.train import module2 as m2

    cfg = m2.Module2Config(crop_size=64, ngf=8, ndf=8, pool_size=4,
                           compute_dtype="bfloat16")
    batch = m2.make_random_batch(cfg, 1, torch.Generator().manual_seed(2),
                                 "cpu")
    out = {}
    for where in (cuda_device, torch.device("cpu")):
        state = m2.init_state(cfg, torch.Generator().manual_seed(0), where)
        frozen = m2.init_frozen_random(torch.Generator().manual_seed(1),
                                       where)
        step = m2.build_train_step(cfg)
        calls, hooks = _count_instance_norms(
            [state.g, state.d, step.frozen_nets(frozen).modnet])
        g0 = next(state.g.parameters()).detach().clone()
        before = _launch_counts()
        out[where.type] = step.step(
            state, {k: v.to(where) for k, v in batch.items()}, frozen,
            torch.Generator().manual_seed(3))
        launches = [a - b for a, b in zip(_launch_counts(), before)]
        for h in hooks:
            h.remove()
        assert {p.dtype for p in state.g.parameters()} == {torch.float32}
        assert float((next(state.g.parameters()) - g0).abs().max()) > 0
        if where.type == "cuda":
            n_bwd = sum(n for (_, _, rec), n in calls.items() if rec)
            assert launches == [0, 0, sum(calls.values()), n_bwd], launches
            assert n_bwd > 0
    for k, v in out["cpu"].items():
        assert np.isfinite(float(out["cuda"][k])), k
        np.testing.assert_allclose(float(out["cuda"][k]), float(v),
                                   rtol=2e-2, err_msg=k)


# --- the rest of the inference surface: test_cli, --video, the batched
# front end --------------------------------------------------------------


def test_render_visuals_card_matches_host(cuda_device):
    """Every float visual of a 3-frame render_visuals batch at PSNR >= 40
    dB between the card (K2) and the CPU (its plain version)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    photo, a68, tb68 = _render_inputs(3)
    launches = instnorm.instance_norm.launches
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        r = _small_renderer(dev, frame_batch=2)
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
    layout at generator ngf 8: the nine visuals of each frame by name, the
    index, K2 launches; the landmark drawings of the first two frames equal
    ``draw_landmarks``' on the host."""
    from animateportrait_tpu_torch import test_cli
    from animateportrait_tpu_torch.utils.image import (
        draw_landmarks, read_image)
    from animateportrait_tpu_torch.utils.smoke import write_test_layout

    db = write_test_layout(str(tmp_path), n_frames=3, size=256)
    monkeypatch.chdir(tmp_path)
    argv = (f"--dataroot {db} --name formal/drawing --netg_resb_disp 3 "
            f"--output_nc 1 --ngf 8 --epoch 70 --num_test 3 --serial_batches "
            f"--imagefolder {db} --frame_batch 2 --checkpoints_dir none "
            f"--results_dir {tmp_path / 'res'}").split()
    launches = instnorm.instance_norm.launches
    res = test_cli.main(argv)
    assert instnorm.instance_norm.launches > launches
    lists = test_cli.resolve_lists(db, "test", float("inf"))
    _, a68, tb68, _, names = test_cli.load_group(
        test_cli.build_test_argparser().parse_args(argv), lists[0][0],
        lists[1][:3])
    assert sorted(os.listdir(res.image_dir)) == sorted(
        f"{n}_{label}.png" for n in names for label in test_cli.LABELS)
    assert len(names) == 3 and os.path.exists(res.index)
    for t in range(2):
        for label, lm in (("real_A_lm", a68), ("target_B_lm", tb68[t])):
            got = read_image(os.path.join(res.image_dir,
                                          f"{names[t]}_{label}.png"))
            np.testing.assert_array_equal(got[:, :, ::-1], test_cli.tensor2im(
                draw_landmarks(256, 256, lm, 3, 2, op=0)))


class _PhotoRecorder:
    """A pipeline that records the photo of each call."""

    def __init__(self, pipe, seen: list):
        self.pipe, self.seen = pipe, seen

    def __getattr__(self, name):
        return getattr(self.pipe, name)

    def __call__(self, img, *args, **kwargs):
        self.seen.append(np.array(img))
        return self.pipe(img, *args, **kwargs)


# cli.main's nets at small widths
CLI_SMALL = ["--ngf", "8", "--flow_nf", "4", "--static_ngf", "8",
             "--cartoon_ngf", "8", "--frame_batch", "4"]


@pytest.mark.parametrize("speech", ["track", "audio"])
def test_video_cli_on_the_card(cuda_device, tmp_path, monkeypatch, speech):
    """cli.main --video on the card at small widths, its speech the clip's
    16 kHz track (the AVI under frame-audio/, its PCM the track's) or
    ``--audio`` (under frame-speech/): K1 once, K2, the photo the pipeline
    gets the decode of the first frame's JPEG."""
    from animateportrait_tpu_torch import cli
    from animateportrait_tpu_torch.utils import jpeg, video

    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (70, 160, 144, 3), np.uint8)
    avi = video.mux_avi(str(tmp_path / "clip.avi"), frames,
                        make_wav(1.2, seed=2))
    write_mtcnn_weights(str(tmp_path / "ckpt" / "mtcnn"))
    extra = [] if speech == "track" else [
        "--audio", video.write_wav(str(tmp_path / "speech.wav"),
                                   make_wav(1.2, seed=3))]
    seen = []
    build = cli.build_pipeline
    monkeypatch.setattr(cli, "build_pipeline",
                        lambda a: _PhotoRecorder(build(a), seen))
    k1, k2 = stft.stft_magnitude.launches, instnorm.instance_norm.launches
    res = cli.main(["--video", avi, *extra, "--ckpt_dir",
                    str(tmp_path / "ckpt"), "--output", str(tmp_path / "out"),
                    *CLI_SMALL])
    assert stft.stft_magnitude.launches == k1 + 1
    assert instnorm.instance_norm.launches > k2
    name = "frame-audio" if speech == "track" else "frame-speech"
    assert res.path.endswith(f"{name}/output_formal_drawing.avi")
    out = video.read_avi(res.path)
    assert out["frames"].shape[0] == res.frames > 0
    assert len(seen) == 1 and np.array_equal(seen[0], jpeg.decode_jpeg(
        jpeg.encode_jpeg(np.ascontiguousarray(frames[0][:, :, ::-1]))))
    if speech == "track":
        track = (video.read_pcm_track(avi) * 32768.0).astype(np.int16)
        assert out["pcm"] == track[:len(out["pcm"]) // 2].tobytes()


@pytest.mark.parametrize("case", ["cartoon", "cartoon_bf16", "tps_fan"])
def test_photo_cli_on_the_card(cuda_device, tmp_path, case):
    """cli.main on the committed JPEG and a 2 s WAV at small widths, on the
    card: ``--exp formal/cartoon``, that with ``--render_bf16`` (K2-bf16
    launches too), and ``--exp formal/drawing --warp_mode tps`` with
    seeded face_alignment FAN and depth checkpoints (the FAN stage runs).
    K1 and K2 launch; the AVI holds the frames at 62.5 fps and an audio
    stream whose PCM is the WAV's."""
    import wave

    from animateportrait_tpu_torch import cli
    from animateportrait_tpu_torch.utils.assets import ASSET_DIR
    from animateportrait_tpu_torch.utils.smoke import write_fan_checkpoints
    from animateportrait_tpu_torch.utils.video import read_avi, write_wav

    ckpt = str(tmp_path / "ckpt")
    write_mtcnn_weights(os.path.join(ckpt, "mtcnn"))
    wav = write_wav(str(tmp_path / "speech.wav"), make_wav(2.0, seed=3))
    argv = ["--jpg", os.path.join(ASSET_DIR, "portrait_420_rst_exif6.jpg"),
            "--audio", wav, "--ckpt_dir", ckpt, "--output",
            str(tmp_path / "out"), "--device", "cuda", *CLI_SMALL]
    if case == "tps_fan":
        write_fan_checkpoints(os.path.join(ckpt, "face_alignment"))
        argv += ["--exp", "formal/drawing", "--warp_mode", "tps"]
    else:
        argv += ["--exp", "formal/cartoon"]
    if case == "cartoon_bf16":
        argv += ["--render_bf16"]
    before = (stft.stft_magnitude.launches, instnorm.instance_norm.launches,
              instnorm.instance_norm.launches_bf16)
    res = cli.main(argv)
    k1, k2, k2_bf16 = (a - b for a, b in zip(
        (stft.stft_magnitude.launches, instnorm.instance_norm.launches,
         instnorm.instance_norm.launches_bf16), before))
    assert k1 > 0 and k2 > 0 and (k2_bf16 > 0 or case != "cartoon_bf16")
    assert ("fan" in res.stage_seconds) == (case == "tps_fan")
    avi = read_avi(res.path)
    T = res.frames
    assert avi["frames"].shape == (T, 256, 256, 3) and avi["fps"] == 62.5
    assert b"auds" in avi["streams"]
    with wave.open(wav, "rb") as w:
        pcm = w.readframes(w.getnframes())
    assert len(avi["pcm"]) == min(len(pcm), T * 512)
    assert avi["pcm"] == pcm[:len(avi["pcm"])]


def test_committed_fixtures_on_the_card_machine(cuda_device):
    """The committed fixtures where the card is, which has neither PIL nor
    OpenCV: each JPEG decoded by both readers to the SHA-256 that PIL and
    OpenCV gave (``jpeg_fixtures.json``), the quality-95 encoder's file and
    its round trip to OpenCV's, and every frame of the Motion-JPEG clip to
    OpenCV's decode, at its fps (``video_fixtures.json``)."""
    import hashlib
    import json

    from animateportrait_tpu_torch.data.av2flau import read_video_frames
    from animateportrait_tpu_torch.utils import image, jpeg
    from animateportrait_tpu_torch.utils.assets import ASSET_DIR

    def digest(px):
        px = np.ascontiguousarray(px)
        return {"sha256": hashlib.sha256(px.tobytes()).hexdigest(),
                "shape": list(px.shape)}

    with open(os.path.join(ASSET_DIR, "jpeg_fixtures.json")) as f:
        table = json.load(f)
    for name in ("portrait_420_rst_exif6.jpg", "portrait_gray.jpg"):
        path, want = os.path.join(ASSET_DIR, name), table[name]
        assert digest(image.load_image(path)) == want["pil_rgb"]
        assert digest(image.load_image(path, grayscale=True)) == want["pil_l"]
        img = image.read_image(path)
        assert digest(img) == want["cv2_bgr"]
        data = jpeg.encode_jpeg(img)
        assert {"sha256": hashlib.sha256(data).hexdigest(),
                "size": len(data)} == want["cv2_q95_file"]
        assert digest(jpeg.decode_jpeg(data)) == want["cv2_q95"]
    with open(os.path.join(ASSET_DIR, "video_fixtures.json")) as f:
        want = json.load(f)["face_clip_mjpg.avi"]
    frames, fps = read_video_frames(os.path.join(ASSET_DIR,
                                                 "face_clip_mjpg.avi"))
    assert fps == want["fps"]
    assert [digest(f)["sha256"] for f in frames] == [
        h["sha256"] for h in want["frames"]]


def test_write_video_round_trip_on_the_card_machine(cuda_device, tmp_path):
    """``write_video`` of 16 gray frames to a ``.mp4`` name where the card
    is: an ``.avi`` at 62.5 fps that ``read_video_frames`` reads back as
    the frames' RGB, each the decode of its quality-95 JPEG."""
    from animateportrait_tpu_torch.utils.jpeg import (
        decode_mjpeg_frame, encode_jpeg)
    from animateportrait_tpu_torch.utils.video import (
        read_video_frames, write_video)

    clip = np.random.default_rng(3).integers(0, 256, (16, 64, 48, 1),
                                            dtype=np.uint8)
    path = write_video(str(tmp_path / "clip.mp4"), clip, fps=62.5)
    got, fps = read_video_frames(path)
    assert path.endswith(".avi") and fps == 62.5
    rgb = np.repeat(clip, 3, axis=-1)
    assert got.shape == rgb.shape
    for g, f in zip(got, rgb):
        np.testing.assert_array_equal(g, decode_mjpeg_frame(encode_jpeg(
            np.ascontiguousarray(f[:, :, ::-1]))))


def test_render_dp_cli_matches_the_plain_cli(cuda_device, tmp_path):
    """cli.main --render_dp (a replica on each visible card, 8 frames a
    replica) against the same call without it, twice, under cuDNN's
    deterministic algorithms: the same frames bit for bit, K1 and K2
    launched; on one card, one replica, the launches of the call without
    the flag."""
    from animateportrait_tpu_torch import cli
    from animateportrait_tpu_torch.utils.assets import ASSET_DIR
    from animateportrait_tpu_torch.utils.video import read_avi, write_wav

    n = torch.cuda.device_count()
    ckpt = str(tmp_path / "ckpt")
    write_mtcnn_weights(os.path.join(ckpt, "mtcnn"))
    argv = ["--jpg", os.path.join(ASSET_DIR, "portrait_420_rst_exif6.jpg"),
            "--audio", write_wav(str(tmp_path / "speech.wav"),
                                 make_wav(2.0, seed=3)),
            "--exp", "formal/cartoon", "--ckpt_dir", ckpt, *CLI_SMALL,
            "--frame_batch", "8"]
    runs = []
    torch.backends.cudnn.deterministic = True
    try:
        for i, flags in enumerate(([], [], ["--render_dp", "--frame_batch",
                                            str(8 * n)])):
            before = (stft.stft_magnitude.launches,
                      instnorm.instance_norm.launches)
            res = cli.main(argv + flags + ["--output",
                                           str(tmp_path / f"out{i}")])
            launches = (stft.stft_magnitude.launches - before[0],
                        instnorm.instance_norm.launches - before[1])
            runs.append((read_avi(res.path)["frames"], launches))
    finally:
        torch.backends.cudnn.deterministic = False
    for frames, launches in runs:
        assert min(launches) > 0
        assert np.array_equal(frames, runs[0][0])
    if n == 1:
        assert runs[2][1] == runs[0][1]


def test_batched_front_end_matches_single_calls_on_the_card(cuda_device,
                                                            tmp_path):
    """detect_faces_batch against single calls (the same faces; boxes,
    five points and scores within 1e-3) and the batched landmark predictor
    against the single one (max |diff| <= 1e-4), on the card."""
    from animateportrait_tpu_torch.models import mtcnn
    from animateportrait_tpu_torch.models.audio2landmark import (
        Audio2landmarkContent, Audio2landmarkPos)
    from animateportrait_tpu_torch.pipeline.batch import (
        BatchedLandmarkPredictor, detect_faces_batch)
    from animateportrait_tpu_torch.pipeline.landmark import LandmarkPredictor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    d = write_mtcnn_weights(str(tmp_path / "mtcnn"))
    det = mtcnn.MTCNNDetector(*(getattr(mtcnn, f"load_{n}")(
        os.path.join(d, f"{n}.npy")) for n in ("pnet", "rnet", "onet")),
        device=cuda_device)
    imgs = np.random.default_rng(6).uniform(0, 255, (3, 200, 180, 3)).astype(
        np.float32)
    batched = detect_faces_batch(det, imgs)
    assert sum(len(bb) for bb, _ in batched) > 0
    for (bb, bl), img in zip(batched, imgs):
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
    gradients can differ by a kink flip at random weights: an input of an
    L1 term or a ReLU within ~1e-5 of its tensor's largest value from the
    kink lands on either side, and one such flip moves most leaves by
    percent); and no launch of the port's kernels."""
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
    """``train.convergence`` on the card for 20 steps: every metric falls,
    and no kernel of the port launches."""
    from animateportrait_tpu_torch.train import convergence

    before = _launch_counts() + (stft.stft_magnitude.launches,)
    rows = convergence.run_all(20, cuda_device, say=lambda m: None)
    assert len(rows) == 8
    assert all(last < first for _, first, last in rows), rows
    assert _launch_counts() + (stft.stft_magnitude.launches,) == before


def _write_foa_tree(root: str, n: int, size: int = 320) -> str:
    """A seeded ibug-style directory: ``n`` photos (every other one a
    baseline JPEG, the rest PNG) of a shaded face with dark strokes at its
    68 landmarks, each with its 1-based ``.pts`` file."""
    from animateportrait_tpu_torch.train.convergence import render_face
    from animateportrait_tpu_torch.utils.assets import std_face_landmarks
    from animateportrait_tpu_torch.utils.image import write_png
    from animateportrait_tpu_torch.utils.jpeg import encode_jpeg

    rng = np.random.default_rng(14)
    base = std_face_landmarks().reshape(68, 3)[:, :2]
    base = base - base.min(0)
    base = base / base.max() * (0.5 * size) + 0.25 * size
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        lm = base[:, ::-1] + rng.uniform(-4, 4, (68, 2))
        img = render_face(lm, size)
        img = np.clip(img * rng.uniform(0.6, 1.0, 3) * 255 + rng.normal(
            0, 6, img.shape), 0, 255).astype(np.uint8)
        stem = os.path.join(root, f"face{i:02d}")
        if i % 2:
            with open(stem + ".jpg", "wb") as f:
                f.write(encode_jpeg(img[:, :, ::-1]))
        else:
            write_png(stem + ".png", img)
        with open(stem + ".pts", "w") as f:
            f.write("version: 1\nn_points: 68\n{\n")
            f.writelines(f"{x + 1:.3f} {y + 1:.3f}\n" for y, x in lm)
            f.write("}\n")
    return root


def test_train_foa_driver_on_the_card(cuda_device, tmp_path):
    """``train_foa`` on the card for 4 steps at 64^2, batch 2, with
    augmentation on (geometric p 0.5: the TPS warps on the card) over a
    seeded ibug-style tree of PNG and JPEG photos: every item loads, the
    steps and their log lines run, no kernel of the port launches; then
    ``predict_artistic_landmarks`` with ``train_pdm`` PDMs gives 68 finite
    points for each photo."""
    from animateportrait_tpu_torch.data import face_of_art as fdata
    from animateportrait_tpu_torch.models.face_of_art import (
        PART_INDS, predict_artistic_landmarks, train_pdm)
    from animateportrait_tpu_torch.train import face_of_art as ftrain

    items = fdata.load_foa_image_list(
        _write_foa_tree(str(tmp_path / "ibug"), 4), image_size=64)
    assert len(items) == 4
    logs = []
    before = _launch_counts() + (stft.stft_magnitude.launches,)
    tr = ftrain.train_foa(items, train_iter=4, batch_size=2, image_size=64,
                          p_geom=0.5, augment=True, print_every=2, seed=0,
                          log_fn=logs.append, device=cuda_device)
    assert _launch_counts() + (stft.stft_magnitude.launches,) == before
    assert tr.steps == 4 and len(logs) == 2
    faces = items[0].lms[None] + np.random.default_rng(15).normal(
        0, 2.0, (40, 68, 2))
    pdms = {part: train_pdm(faces[:, inds], 3)
            for part, inds in PART_INDS.items()}
    model = tr.model.eval()
    for it in items:
        lms = predict_artistic_landmarks(it.image, model, pdms)
        assert lms.shape == (68, 2) and np.isfinite(lms).all()


def _gan_net(kind: str, name: str, ngf: int, seed: int = 0):
    """``define_g(name)`` (output_nc 1, the Regressor at arch 2, the one
    with InstanceNorms) or ``define_d(name)`` with seeded N(0, 0.02)
    weights (the reference's init)."""
    from animateportrait_tpu_torch.models.gan import init_weights

    if kind == "d":
        net = gan_extra.define_d(name, 3, ndf=ngf)
    else:
        kw = {"arch": 2} if name == "regressor" else {}
        net = gan_extra.define_g(name, 3, 1, ngf=ngf, **kw)
    return init_weights(net, generator=torch.Generator().manual_seed(seed))


def _gan_inputs(name: str, size: int, batch: int, dev, dtype=torch.float32,
                seed: int = 0) -> list:
    """Seeded inputs of ``define_g(name)``'s forward: the photo, landmark
    images, motion grids (N, H, W, 2), flow (N, 2, H, W) and mask as the
    net's mode takes them."""
    g = torch.Generator().manual_seed(seed)

    def u(*shape, lo=-1.0, hi=1.0):
        return (lo + (hi - lo) * torch.rand(*shape, generator=g)).to(
            dev, dtype)

    def land(c=1):
        return torch.where(u(batch, c, size, size) > 0.8, 1.0, -1.0).to(dtype)

    x = u(batch, 3, size, size)
    motion, motion2 = u(batch, size, size, 2), u(batch, size, size, 2)
    flow, mask = u(batch, 2, size, size, lo=-3, hi=3), u(batch, 1, size,
                                                         size, lo=0)
    if name in gan_extra.CONDITIONAL:
        mode = gan_extra.CONDITIONAL[name][1]
        return {"none": [x, land(), land()],
                "fw": [x, land(), land(), motion],
                "fw2": [x, land(), land(), motion],
                "ifw": [x, land(), land(), motion, flow, mask]}[mode]
    if name in gan_extra.TRIDENT_VARIANTS:
        v = gan_extra.TRIDENT_VARIANTS[name]
        lc = v.get("land_nc", 1)
        return {"both": [x, land(lc), land(lc), motion, flow, mask],
                "dual_motion": [x, land(), land(), motion, None, None,
                                motion2],
                "motion": [x, land(), land(), motion],
                "flow": [x, land(), land(), None, flow, mask]}[v["warp"]]
    if name == "resnet_9blocks_rcatland32_full_ifw":
        return [x, land(), land(), motion, flow, mask]
    if name == "resnet_9blocks_rcatland4":
        return [x, land(), land()]
    if name == "resnet_9blocks_rcatland2":
        return [x, x.roll(7, 2)]
    if name == "resnet_style2_9blocks":
        return [x, u(batch, 3, size // 4, size // 4)]
    if name == "regressor":
        return [u(batch, 3, 11, 11)]
    return [x]


def _mean_square(out) -> torch.Tensor:
    outs = out if isinstance(out, tuple) else (out,)
    return sum(torch.mean(torch.square(o)) for o in outs)


@pytest.mark.parametrize("kind,name", [
    ("g", n) for n in sorted(gan_extra.NETG)] + [
    ("d", n) for n in sorted(gan_extra.NETD)], ids=lambda v: v)
def test_gan_extra_card_vs_host(cuda_device, kind, name):
    """Every ``define_g`` / ``define_d`` net at a small width (ngf 8 at
    64^2, batch 2; unet_128 at 128^2, unet_256 at ngf 4 and 256^2, the
    class discriminator at 512^2 and batch 1, the Regressor on 11^2
    patches) on the card and on the host, cuDNN's deterministic
    algorithms: the outputs within 1e-4 of their scale, the loss (mean
    square) within rtol 1e-4 and every gradient leaf by ``grad_parity``
    with a float64 host run. On the card K2 and K2b both launch where the
    net has InstanceNorms, and hold to their plain versions on its
    InstanceNorm inputs (``_hold_k2_on``); unet_256's reach 2x2 planes."""
    from animateportrait_tpu_torch.utils.smoke import (
        cancelled_biases, grad_parity)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    size = {"unet_128": 128, "unet_256": 256, "cls": 512,
            "regressor": 11}.get(name, 64)
    runs = []
    torch.backends.cudnn.deterministic = True
    try:
        for dev, dt in ((cuda_device, torch.float32), ("cpu", torch.float32),
                        ("cpu", torch.float64)):
            before = (instnorm.instance_norm.launches,
                      instnorm.instance_norm_backward.launches)
            net = _gan_net(kind, name, 4 if name == "unet_256" else 8).to(
                dev, dt).train()
            kept, hooks = _kept_instance_norm_inputs([net])
            out = net(*_gan_inputs(name, size, 1 if name == "cls" else 2,
                                   dev, dt))
            for h in hooks:
                h.remove()
            loss = _mean_square(out)
            loss.backward()
            after = (instnorm.instance_norm.launches,
                     instnorm.instance_norm_backward.launches)
            if dev == cuda_device and kept:
                assert after[0] > before[0] and after[1] > before[1]
                _hold_k2_on(kept, grads=True)
                if name == "unet_256":
                    assert (2, 2) in {s[2:] for s, _ in kept}
            outs = out if isinstance(out, tuple) else (out,)
            runs.append(([o.detach().double().cpu() for o in outs],
                         float(loss.detach()),
                         {k: p.grad for k, p in net.named_parameters()}))
    finally:
        torch.backends.cudnn.deterministic = False
    (oc, lc, gc), (oh, lh, gh), (_, _, g64) = runs
    for a, b in zip(oc, oh):
        assert maxdiff(a, b) <= 1e-4 * float(b.abs().max())
    assert abs(lc - lh) <= 1e-4 * abs(lh)
    errs = grad_parity(gc, gh, g64, cancelled_biases(net))
    assert max(errs.values()) <= 1e-3, max(errs, key=errs.get)


@pytest.mark.parametrize("spatial", [False, True])
@pytest.mark.parametrize("pnet", ["vgg", "alex", "squeeze"])
def test_lpips_card_vs_host(cuda_device, pnet, spatial):
    """LPIPS with seeded weights, the distance and its spatial map, on the
    card and on the host: within 1e-4 of the distance's scale, finite, no
    kernel of the port launched."""
    from animateportrait_tpu_torch.models.lpips import PNetLin

    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    net = PNetLin(pnet, spatial=spatial).eval()
    a, b = (torch.rand(2, 3, 64, 64) * 2 - 1 for _ in range(2))
    before = _launch_counts()
    with torch.no_grad():
        want = net(a, b)
        got = net.to(cuda_device)(a.to(cuda_device), b.to(cuda_device)).cpu()
    assert maxdiff(got, want) <= 1e-4 * float(want.abs().max())
    assert torch.isfinite(got).all()
    assert _launch_counts() == before


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


# the front end's mel through K1, card against its plain version on the
# card and against the host (fp32 sums of 1024-term FFTs in other orders)
MEL_ATOL = 2e-3


def test_mel_card_matches_plain_and_host(cuda_device):
    """``mel_spectrogram`` of a conditioned 6 s WAV through K1 (one launch)
    within ``MEL_ATOL`` of its plain version on the card and of the host;
    ``AudioPipeline``'s raw mel, card against host, too."""
    from animateportrait_tpu_torch.models.autovc import AutoVCGenerator
    from animateportrait_tpu_torch.ops.spectral import (
        mel_scale, mel_spectrogram)
    from animateportrait_tpu_torch.pipeline.audio import (
        AudioPipeline, condition_signal, normalize_dbfs)

    wav = make_wav(6.0, seed=2)
    x = torch.as_tensor(condition_signal(normalize_dbfs(wav)),
                        dtype=torch.float32)
    k1 = stft.stft_magnitude.launches
    with torch.inference_mode():
        got = mel_spectrogram(x.to(cuda_device))
        assert stft.stft_magnitude.launches == k1 + 1
        plain = mel_scale(stft_plain(x.to(cuda_device)))
        host = mel_spectrogram(x)
    assert maxdiff(got.cpu(), plain.cpu()) <= MEL_ATOL
    assert maxdiff(got.cpu(), host) <= MEL_ATOL
    autovc = init_random_(AutoVCGenerator(), torch.Generator().manual_seed(0))
    with torch.inference_mode():
        card, cpu = (AudioPipeline(copy.deepcopy(autovc), chunk=512,
                                   device=d)(wav)
                     for d in (cuda_device, torch.device("cpu")))
    assert maxdiff(card.mel_raw, cpu.mel_raw) <= MEL_ATOL


def _full_fan_nets():
    """FAN3D (4 modules) and ResNetDepth ((3, 8, 36, 3)) at their full
    widths with torch's default init from seed 0, as
    ``utils/smoke.py:write_fan_checkpoints`` writes them: the bars below
    were set on these."""
    from animateportrait_tpu_torch.models import fan3d

    torch.manual_seed(0)
    return fan3d.FAN3D(), fan3d.ResNetDepth()


def _near_tie(host: np.ndarray, card: np.ndarray, err: float) -> bool:
    """Whether the card's decode of one (64, 64) heatmap may differ from
    the host's only because the two differ by ``err``: its peak is within
    2 err of the host's peak value, and where the peaks agree, a
    neighbour pair whose order sets the quarter-pixel shift is within
    2 err."""
    h, w = host.shape
    hy, hx = np.unravel_index(np.argmax(host), host.shape)
    cy, cx = np.unravel_index(np.argmax(card), card.shape)
    if (hy, hx) != (cy, cx):
        return bool(host[cy, cx] >= host[hy, hx] - 2 * err)
    pairs = [(host[hy, min(hx + 1, w - 1)], host[hy, max(hx - 1, 0)]),
             (host[min(hy + 1, h - 1), hx], host[max(hy - 1, 0), hx])]
    return any(abs(a - b) <= 2 * err for a, b in pairs)


def test_fan3d_card_vs_host(cuda_device):
    """FAN3D and the depth net on one crop of the committed JPEG, card
    against host: the heatmaps within 1e-3, z and the landmarks finite,
    and a landmark whose x or y differs only at a near-tie of the host's
    heatmap (``_near_tie``)."""
    from animateportrait_tpu_torch.models import fan3d
    from animateportrait_tpu_torch.utils.assets import ASSET_DIR
    from animateportrait_tpu_torch.utils.image import read_image

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rgb = np.ascontiguousarray(read_image(os.path.join(
        ASSET_DIR, "portrait_420_rst_exif6.jpg"))[:, :, ::-1])
    h, w = rgb.shape[:2]
    box = (w * 0.25, h * 0.2, w * 0.75, h * 0.8)
    crop = fan3d.fa_crop(rgb, *fan3d.bbox_to_center_scale(box))
    fan, depth = _full_fan_nets()
    out = []
    for where in (cuda_device, torch.device("cpu")):
        fa = fan3d.FaceAlignment3D(copy.deepcopy(fan), copy.deepcopy(depth),
                                   device=where)
        hm, _, z = fa.heatmaps_and_depth(crop)
        out.append((hm.cpu().numpy(), z.cpu().numpy(),
                    fa.landmarks_from_box(rgb, box)))
    (hc, zc, lc), (hh, _, lh) = out
    err = float(np.abs(hc - hh).max())
    assert err <= 1e-3
    assert np.isfinite(zc).all() and np.isfinite(lc).all()
    differ = np.flatnonzero((lc[:, :2] != lh[:, :2]).any(1))
    assert all(_near_tie(hh[0, c], hc[0, c], err) for c in differ), differ


def test_av2flau_card_vs_host(cuda_device, tmp_path):
    """``Av2FlauConverter`` over the committed Motion-JPEG fixture with
    FAN3D + depth and ``AudioPipeline`` (K1 once), card against host: the
    same frame indices, finite rows, at most 5% of the (x, y) landmarks
    moved, and the registered rows within 1e-3 on the frames whose (x, y)
    landmarks agree."""
    from animateportrait_tpu_torch.data.av2flau import Av2FlauConverter
    from animateportrait_tpu_torch.models import fan3d
    from animateportrait_tpu_torch.models.autovc import AutoVCGenerator
    from animateportrait_tpu_torch.pipeline.audio import AudioPipeline
    from animateportrait_tpu_torch.utils.assets import ASSET_DIR
    from animateportrait_tpu_torch.utils.video import write_wav

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    path = os.path.join(ASSET_DIR, "face_clip_mjpg.avi")
    fan, depth = _full_fan_nets()
    autovc = init_random_(AutoVCGenerator(), torch.Generator().manual_seed(0))
    wav = write_wav(str(tmp_path / "speech.wav"), make_wav(2.0, seed=3))

    def detector(rgb):
        h, w = rgb.shape[:2]
        return np.array([[w * 0.25, h * 0.2, w * 0.75, h * 0.8, 1.0]]), None

    runs = []
    for where in (cuda_device, torch.device("cpu")):
        hook = fan3d.make_fan_landmark_fn(fan3d.FaceAlignment3D(
            copy.deepcopy(fan), copy.deepcopy(depth), where), detector)
        raw = []

        def landmarks(frame, hook=hook, raw=raw):
            raw.append(hook(frame))
            return raw[-1]

        k1 = stft.stft_magnitude.launches
        fl3d, _, _ = Av2FlauConverter(landmarks, AudioPipeline(
            copy.deepcopy(autovc), device=where)).convert(
                path, wav, out_dir=str(tmp_path / where.type), register=True)
        runs.append((fl3d, np.stack(raw), stft.stft_magnitude.launches - k1))
    (c, c_raw, k1), (h, h_raw, _) = runs
    assert k1 == 1
    np.testing.assert_array_equal(c[:, 0], h[:, 0])
    assert np.isfinite(c).all()
    moved = np.abs(c_raw[..., :2] - h_raw[..., :2]).max(-1)     # (T, 68)
    assert (moved > 0).mean() <= 0.05
    same = ~(moved > 0).any(-1)
    if same.any():
        assert maxdiff(c[same], h[same]) <= 1e-3


@pytest.mark.parametrize("style", ["drawing", "cartoon"])
def test_fakeb_static_card_vs_host(cuda_device, tmp_path, style):
    """The fakeB_static builder on the card over 2 photos with its
    full-width static net (seeded): a file for each photo, K2 launched and
    held to its plain version on the net's InstanceNorm inputs, each
    stylization at PSNR >= 40 dB of the host's."""
    import shutil

    from animateportrait_tpu_torch.data import fakeb_static as fb
    from animateportrait_tpu_torch.utils.image import read_image
    from animateportrait_tpu_torch.utils.smoke import write_umlvd_tree

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tree = write_umlvd_tree(str(tmp_path / "tree"), n_photos=2, n_styles=1,
                            frames=1, size=128)
    root = str(tmp_path / "root")
    shutil.copytree(os.path.join(tree, "Photo"), os.path.join(root, "Photo"))
    photos = fb.photos_of(root)
    net = fb.build_static_net(style, None, cuda_device)
    kept, hooks = _kept_instance_norm_inputs([net])
    k2 = instnorm.instance_norm.launches
    written = fb.make_fakeb_static(root, style=style, device=cuda_device,
                                   net=net)
    for h in hooks:
        h.remove()
    assert instnorm.instance_norm.launches > k2
    _hold_k2_on(kept)
    assert len(written) == len(photos) == 2
    host = fb.build_static_net(style, None, "cpu")
    for p, src in zip(written, photos):
        assert psnr(read_image(p)[:, :, ::-1], fb.stylize(
            host, style, read_image(src)), 255.0) >= 40.0


def test_gan_convergence_run_on_the_card(cuda_device, tmp_path):
    """The GAN convergence tool on the card at crop 64, ngf 8, with its
    stand-in frozen nets (2 + 2 steps): 4 steps, then resumed to 6, in
    this process; the loss log runs 1..6 and is finite, and K2 and K2b
    launch."""
    from animateportrait_tpu_torch.train import gan_convergence as gc
    from animateportrait_tpu_torch.train import standin_frozen as sf

    frozen = str(tmp_path / "frozen")
    sf.main([frozen, "--steps", "2", "--sphere_steps", "2", "--n_faces", "8",
             "--ids", "2", "--per_id", "4", "--device", str(cuda_device)])
    root, ckpt = str(tmp_path / "drawing"), str(tmp_path / "ckpt")
    gc.build_dataset(root)
    before = _launch_counts()
    gc.run_training(root, ckpt, 64, 4, 6, 4, 8, print_freq=1,
                    frozen_dir=frozen, device=str(cuda_device),
                    in_process=True)
    launches = [a - b for a, b in zip(_launch_counts(), before)]
    assert min(launches[:2]) > 0, launches
    rows = gc.read_metrics(ckpt)
    assert [r["iters"] for r in rows] == list(range(1, 7))
    for r in rows:
        assert np.isfinite([v for v in r.values()]).all()


def test_entry_card_vs_host(cuda_device):
    """``entry()`` at ngf 8 (the trident generator at 256^2) on the card
    against the same forward on the host at PSNR >= 40 dB, K2 launched and
    held to its plain version on the forward's InstanceNorm inputs."""
    from animateportrait_tpu_torch.entry import entry

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fn, args = entry(cuda_device, ngf=8)
    kept, hooks = _kept_instance_norm_inputs([fn])
    k2 = instnorm.instance_norm.launches
    with torch.inference_mode():
        got = fn(*args).cpu()
        for h in hooks:
            h.remove()
        assert instnorm.instance_norm.launches > k2
        hfn, hargs = entry("cpu", ngf=8)
        want = hfn(*hargs)
    assert psnr(got, want) >= 40.0
    _hold_k2_on(kept)


@pytest.mark.parametrize("name", ["mlp", "transformer_dt", "gru"])
def test_a2l_discriminators_card_vs_host(cuda_device, name):
    """Module1's discriminators at the reference's widths on 100 frames,
    forward and backward, on the card and on the host from the same
    weights and inputs: the outputs within 1e-4 of their scale, every
    parameter's and input's gradient by ``grad_parity`` with a float64
    host run."""
    from animateportrait_tpu_torch.models import audio2landmark as a2l
    from animateportrait_tpu_torch.utils.smoke import (
        cancelled_biases, grad_parity)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cls, widths = {"mlp": (a2l.DiscriminatorMLP, (204,)),
                   "transformer_dt": (a2l.TransformerDT, (204, 128)),
                   "gru": (a2l.DiscriminatorGRU, (256, 204))}[name]
    rng = np.random.default_rng(len(name))
    xs = [rng.standard_normal((100, w)) for w in widths]
    runs = []
    for where, dt in ((cuda_device, torch.float32), ("cpu", torch.float32),
                      ("cpu", torch.float64)):
        net = init_random_(cls(), torch.Generator().manual_seed(0)).to(
            device=where, dtype=dt)
        inp = [torch.tensor(x, dtype=dt, device=where, requires_grad=True)
               for x in xs]
        y = net(*inp)
        names = [k for k, _ in net.named_parameters()]
        grads = torch.autograd.grad(
            y.square().sum(), [p for _, p in net.named_parameters()] + inp)
        runs.append((y.detach().double().cpu(), {
            k: g.detach().cpu() for k, g in zip(
                names + [f"input{i}" for i in range(len(inp))], grads)}))
    (yc, gc), (yh, gh), (_, g64) = runs
    assert maxdiff(yc, yh) <= 1e-4 * float(yh.abs().max())
    errs = grad_parity(gc, gh, g64, cancelled_biases(cls()))
    assert max(errs.values()) <= 1e-3, max(errs, key=errs.get)


# --- the multi-card paths on one card (several ranks over gloo) -----------


# The 2 ranks' gradients against one process's, of a leaf's scale
# (grad_parity): the ranks' batch-2 passes round otherwise than one batch-4
# pass on the card, and kinks flip, so they have read up to 5.4e-3 (G) and
# 1.23e-2 (D) on an H100. The fault the bar is for, rank 0's own half-batch
# gradients (the all-reduce left out), reads 1.92 (G) and 1.38 (D) there
# and on the CPU; the test holds it beyond the bar in the same run.
DP_LEAF_BAR = 5e-2


def _loss_gaps(run: list, ref: list) -> list:
    """Each step's largest |loss - ref's| over max(|ref's|, 1e-5)."""
    return [max(abs(got[k] - v) / max(abs(v), 1e-5) for k, v in want.items())
            for got, want in zip(run, ref)]


def _spread_bars(runs: list, ref: dict, noise: dict) -> dict:
    """Bars for a comparison with the ``dp_step_run`` record ``ref`` of one
    process, from that process's own spread (``runs``: the same steps
    called again, and under cuDNN's deterministic algorithms): the larger
    of each quantity's bar and 3x the widest spread. At random weights a
    rounding-level change of the forward moves fp32 gradients past ReLU
    kinks by percent, and Adam turns the noise elements' gradients into
    steps of lr: a smaller batch a rank is such a change."""
    from animateportrait_tpu_torch.utils.smoke import grad_parity

    def widest(gaps):
        return [max(v) for v in zip(*(gaps(o) for o in runs))]

    bars = {"loss": [max(1e-4, 3 * w) for w in widest(
                lambda o: _loss_gaps(o["metrics"], ref["metrics"]))],
            "pool": [max(bar, 3 * w) for w, bar in zip(widest(
                lambda o: [maxdiff(a, b) for a, b in zip(
                    o["pools"], ref["pools"])]), (1e-4, 1e-3))]}
    for net in ("g", "d"):
        bars[net] = max(1e-3, 3 * max(max(grad_parity(
            o["grads"][0][net], ref["grads"][0][net], None,
            noise[net]).values()) for o in runs))
    return bars


def _hold_against(rec: dict, ref: dict, bars: dict, noise: dict,
                  lr: float) -> None:
    """A ``dp_step_run`` record of 2 steps against ``ref``'s: the losses and
    the pool after each step and the first step's gradients within
    ``bars``; the pool counts equal; Adam's first update on its decisive
    elements and both steps' updates within 1.5 lr a step
    (``adam_update_parity``)."""
    from animateportrait_tpu_torch.utils.smoke import (
        adam_update_parity, grad_parity)

    assert rec["pool_counts"] == ref["pool_counts"]
    for gap, bar in zip(_loss_gaps(rec["metrics"], ref["metrics"]),
                        bars["loss"]):
        assert gap <= bar, (gap, bar)
    for a, b, bar in zip(rec["pools"], ref["pools"], bars["pool"]):
        assert maxdiff(a, b) <= bar
    for net in ("g", "d"):
        errs = grad_parity(rec["grads"][0][net], ref["grads"][0][net], None,
                           noise[net])
        assert max(errs.values()) <= bars[net], (net, max(errs.values()))
        bound, decided = adam_update_parity(
            rec["params"][1][net], ref["params"][1][net],
            ref["params"][0][net], ref["grads"][0][net], lr)
        assert decided <= 1.0, (net, decided)
        bound = max(bound, adam_update_parity(
            rec["params"][2][net], ref["params"][2][net],
            ref["params"][0][net], ref["grads"][0][net], lr, 2)[0])
        assert bound <= 1.0, (net, bound)


def test_dp_step_two_ranks_on_the_card_match_one_process(cuda_device,
                                                         tmp_path):
    """The data-parallel step of 2 ranks on this card (gloo) against the
    single-process step on the global batch of 4, at crop 64, ngf = ndf = 8,
    for 2 steps: the losses within rtol 1e-4, the first step's gradients by
    ``grad_parity`` within ``DP_LEAF_BAR`` of each leaf's scale, and rank
    0's own half-batch gradients (the all-reduce left out) beyond it; the
    ranks' parameters bit-equal after both steps, the first Adam update on
    its decisive elements and both steps' updates within 1.5 lr a step,
    the pool after the first step, K2 and K2b launched on each rank and K2
    against its plain version on its InstanceNorm inputs."""
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
        bound = adam_update_parity(
            ranks[0]["params"][2][net], single["params"][2][net],
            single["params"][0][net], single["grads"][0][net], cfg.lr, 2)[0]
        assert bound <= 1.0, (net, bound)


def test_dp_step_two_ranks_at_full_width_within_the_spread(cuda_device,
                                                           tmp_path):
    """The data-parallel step of 2 ranks on this card (gloo) at the bench
    configuration (crop 256, ngf = ndf = 64, batch 4, stacked D passes)
    against one process on the global batch, 2 steps, by
    ``_hold_against`` at bars from that process's own spread
    (``_spread_bars``: at full width a rounding-level change of the
    forward moves fp32 gradients past kinks by percent, and the spread
    shows it; at crop 64 the ranks' batch of 2 rounds otherwise than one
    batch of 4 by more than the one process's own spread, and
    ``DP_LEAF_BAR`` holds that case); rank 0's half batch alone beyond
    the gradient bars; the ranks' parameters bit-equal; K2 and K2b
    launched on each rank and K2 against its plain version."""
    from animateportrait_tpu_torch.train import module2 as m2
    from animateportrait_tpu_torch.utils import distributed as ddp
    from animateportrait_tpu_torch.utils.smoke import (
        dp_step_rank, dp_step_run, grad_parity)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = m2.Module2Config(batch_d_passes=True)
    batch = {k: v.numpy() for k, v in m2.make_random_batch(
        cfg, 4, torch.Generator().manual_seed(2), "cpu").items()}
    ddp.spawn(dp_step_rank, [cuda_device] * 2, cfg, batch, 2, str(tmp_path),
              timeout=600)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    single = dp_step_run(cfg, batch, 2, cuda_device)
    again = [dp_step_run(cfg, batch, 2, cuda_device)]
    torch.backends.cudnn.deterministic = True
    try:
        again.append(dp_step_run(cfg, batch, 2, cuda_device))
    finally:
        torch.backends.cudnn.deterministic = False
    half = dp_step_run(cfg, {k: v[:2] for k, v in batch.items()}, 1,
                       cuda_device)
    state = m2.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    noise = {net: in_cancelled_biases(getattr(state, net))
             for net in ("g", "d")}
    bars = _spread_bars(again, single, noise)
    _hold_against(ranks[0], single, bars, noise, cfg.lr)
    for rec in ranks:
        assert rec["backend"] == "gloo"
        assert min(rec["launches"].values()) > 0, rec["launches"]
        assert rec["k2_err"] <= K2_ATOL
    for net in ("g", "d"):
        fault = grad_parity(half["grads"][0][net], single["grads"][0][net],
                            None, noise[net])
        assert max(fault.values()) > bars[net], (net, bars[net])
        for k, v in ranks[0]["params"][-1][net].items():
            assert torch.equal(v, ranks[1]["params"][-1][net][k]), k


def test_render_dp_two_replicas_on_the_card(cuda_device):
    """Two renderer replicas on this card (``devices=[card, card]``), the
    second a copy of the nets, against one, 10 frames: uint8 frames at
    PSNR >= 40 dB (cuDNN may take other algorithms at 4 frames a replica
    than at 8), K2 launched and held to its plain version on the second
    replica's InstanceNorm inputs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    photo, a68, tb68 = _render_inputs(10)
    frames = []
    for devices in (None, [cuda_device, cuda_device]):
        r = _small_renderer(cuda_device, frame_batch=8, output_uint8=True,
                            data_parallel=devices is not None,
                            devices=devices)
        assert len(r.replicas) == (1 if devices is None else 2)
        kept, hooks = _kept_instance_norm_inputs(r.replicas[-1][:2])
        launches = instnorm.instance_norm.launches
        with torch.inference_mode():
            frames.append(r(photo, a68, tb68))
        for h in hooks:
            h.remove()
        assert instnorm.instance_norm.launches > launches
    assert r.replicas[1][0] is not r.g
    _hold_k2_on(kept)
    assert frames[0].shape == frames[1].shape == (10, 256, 256, 1)
    assert psnr(frames[1], frames[0], peak=255.0) >= 40.0
    # without devices: one replica on each visible card, "cuda" the
    # current one
    r = _small_renderer("cuda", frame_batch=7, data_parallel=True)
    assert [d for _, _, d in r.replicas] == [
        torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    assert r.replicas[0][0] is r.g


# GPipe of ResNet blocks against the blocks in sequence on the same
# microbatches, over gloo (tests/test_torch_parallel.py's tolerance)
GPIPE_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("spread", ["one_card", "one_rank_a_card"])
def test_gpipe_on_the_card(cuda_device, tmp_path, spread):
    """``parallel.gpipe_apply`` of 9 ResNet blocks (16 channels at 32^2,
    batch 6) as 3 stages of 3, at M = 3 and 6 microbatches, against the
    blocks in sequence on the same microbatches: three gloo ranks on this
    card within ``GPIPE_TOL``, or one rank a card over NCCL (up to 3
    stages) bit for bit; each stage launches K2 twice a block a
    microbatch, holds it to its plain version, and refuses a batch that
    does not divide into its microbatches."""
    from animateportrait_tpu_torch.models.gan import ResnetBlock
    from animateportrait_tpu_torch.parallel import seq_apply
    from animateportrait_tpu_torch.utils import distributed as ddp
    from animateportrait_tpu_torch.utils.smoke import (
        gpipe_run, jobs_rank, resnet_blocks)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if spread == "one_card":
        devices = [cuda_device] * 3
    else:
        devices = _cards(cuda_device)
    stages = min(3, len(devices))
    blocks = resnet_blocks(16, 3 * stages, seed=5)
    x = np.random.default_rng(6).standard_normal(
        (6, 16, 32, 32)).astype(np.float32)
    ddp.spawn(jobs_rank, devices, {"gpipe": (gpipe_run, (
        blocks, x, [3, 6], stages))}, str(tmp_path), timeout=600)
    ranks = [torch.load(tmp_path / f"rank{r}.pt")["gpipe"]
             for r in range(stages)]
    mods = []
    for sd in blocks:
        b = ResnetBlock(x.shape[1])
        b.load_state_dict(sd)
        mods.append(b.to(cuda_device).eval())
    xt = torch.as_tensor(x, device=cuda_device)
    for m in (3, 6):
        with torch.inference_mode():
            want = torch.cat([seq_apply(mods, c) for c in xt.chunk(m)]).cpu()
        for rec in ranks:
            if spread == "one_card":
                torch.testing.assert_close(rec["y"][m], want, **GPIPE_TOL)
            else:
                assert torch.equal(rec["y"][m], want)
    for rec in ranks:
        assert rec["backend"] == ("gloo" if spread == "one_card" else "nccl")
        assert rec["launches"] == {3: 6 * 3, 6: 6 * 6}
        assert rec["k2_err"] <= K2_ATOL
        assert "not divisible" in (rec["indivisible"] or "")


def test_dryrun_multichip_on_the_card(cuda_device):
    """``multichip.dryrun_multichip``: a rank a card where there are two or
    more (up to 4), else 2 ranks over gloo that share this card; each
    rank's step launches K2 and K2b and holds K2 to its plain version."""
    from animateportrait_tpu_torch.multichip import dryrun_multichip

    n = min(torch.cuda.device_count(), 4)
    n = n if n >= 2 else 2
    for rec in dryrun_multichip(n):
        st = rec["step"]
        assert min(st["launches"].values()) > 0, st["launches"]
        assert st["k2_err"] <= K2_ATOL


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
    its plain version on every rank, every rank's parameters bit-equal
    after both steps. The data-parallel ranks are held against one process
    running the ranks' step (each rank's slice alone,
    ``utils/smoke.py:decomposed_grads``) and the FSDP ranks against them
    by ``_hold_against`` at bars from that process's own spread
    (``_spread_bars``), and the fault beyond the gradient bars."""
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
    noise = {net: in_cancelled_biases(getattr(state, net))
             for net in ("g", "d")}
    alone = dp_step_run(cfg, {k: v[:4 // n] for k, v in batch.items()}, 1,
                        cuda_device)
    single = dp_step_run(cfg, batch, 2, cuda_device, decompose=n)
    again = [dp_step_run(cfg, batch, 2, cuda_device, decompose=n)]
    torch.backends.cudnn.deterministic = True
    try:
        again.append(dp_step_run(cfg, batch, 2, cuda_device, decompose=n))
    finally:
        torch.backends.cudnn.deterministic = False
    bars = _spread_bars(again, single, noise)
    for net in ("g", "d"):
        fault = grad_parity(alone["grads"][0][net],
                            ranks[0]["dp"]["grads"][0][net], None, noise[net])
        assert max(fault.values()) > DP_LEAF_BAR, (net, max(fault.values()))
        fault = grad_parity(alone["grads"][0][net], single["grads"][0][net],
                            None, noise[net])
        assert max(fault.values()) > bars[net], (net, max(fault.values()))
    _hold_against(ranks[0]["dp"], single, bars, noise, cfg.lr)
    _hold_against(ranks[0]["fsdp"], ranks[0]["dp"], bars, noise, cfg.lr)
    for rec in ranks:
        assert rec["backend"] == "nccl"
        dp, fs = rec["dp"], rec["fsdp"]
        for run in (dp, fs):
            assert min(run["launches"].values()) > 0, run["launches"]
            assert run["k2_err"] <= K2_ATOL
            for net in ("g", "d"):
                mode = "dp" if run is dp else "fsdp"
                for k, v in run["params"][-1][net].items():
                    assert torch.equal(
                        v, ranks[0][mode]["params"][-1][net][k]), (net, k)
        b = fs["fsdp_bytes"]
        assert b["sharded"] * n == b["unsharded"] > 0
        for s in range(2):
            for k, v in dp["metrics"][s].items():
                np.testing.assert_allclose(fs["metrics"][s][k], v,
                                           rtol=1e-4, err_msg=k)
        for net in ("g", "d"):
            errs = grad_parity(fs["grads"][0][net], dp["grads"][0][net],
                               None, noise[net])
            assert max(errs.values()) <= DP_LEAF_BAR, (
                net, max(errs.values()))


def test_train_cli_data_parallel_and_multihost_one_rank_a_card(
        cuda_device, tmp_path):
    """``train_cli.main --data_parallel n`` and ``--multihost`` as n
    processes (``LOCAL_RANK`` picks each one's card), one rank a card over
    NCCL, 2 steps at the small configuration: each step's losses against
    one process running the ranks' step on the same global batches
    (``decomposed_grads``; ``--data_parallel``'s rank 0 loads them from
    ``default_rng(0)``, each ``--multihost`` process its slice from
    ``default_rng(process id)``) within the larger of rtol 1e-4 and 3x
    that process's own spread, and the first rank's share alone (the
    fault) beyond that bar."""
    import json
    import subprocess
    import sys

    from animateportrait_tpu_torch import train_cli
    from animateportrait_tpu_torch.data.umlvd_ifw import (
        UMLVDIFWDataset, loader)
    from animateportrait_tpu_torch.io.reference import load_frozen
    from animateportrait_tpu_torch.train import module2 as m2
    from animateportrait_tpu_torch.utils.distributed import free_port
    from animateportrait_tpu_torch.utils.options import to_configs
    from animateportrait_tpu_torch.utils.smoke import (
        decomposed_grads, write_umlvd_tree)

    devices = _cards(cuda_device)
    n = len(devices)
    tree = write_umlvd_tree(str(tmp_path / "data"), size=96, seed=0,
                            png_filter=4)
    base = ["--dataroot", tree, *TRAIN_CLI_SMALL, "--batch_size", "4",
            "--max_steps", "2", "--frozen_dir", str(tmp_path / "none"),
            "--name", "run"]

    def records(ck):
        with open(os.path.join(ck, "run", "metrics.jsonl")) as f:
            return [json.loads(line) for line in f]

    runs = {}
    ck = str(tmp_path / "ck_dp")
    assert train_cli.main([*base, "--data_parallel", str(n),
                           "--checkpoints_dir", ck]) is None
    runs["dp"] = records(ck)
    ck = str(tmp_path / "ck_mh")
    argv = [*base, "--checkpoints_dir", ck, "--multihost", "1",
            "--num_processes", str(n), "--coordinator_address",
            f"127.0.0.1:{free_port()}"]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "animateportrait_tpu_torch.train_cli", *argv,
         "--process_id", str(i)], cwd=repo, env=dict(
            os.environ, LOCAL_RANK=str(i), PYTHONPATH=os.pathsep.join(
                [repo, os.environ.get("PYTHONPATH", "")])),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i}:\n{out[-3000:]}"
    assert f"{n} ranks over nccl" in outs[0]
    runs["multihost"] = records(ck)

    args = train_cli.build_argparser().parse_args(argv + ["--process_id",
                                                          "0"])
    cfg, data_cfg = to_configs(args)
    ds = UMLVDIFWDataset(data_cfg)
    per = -(-max(4, n) // n)        # train_cli's slice a rank
    streams = {"dp": [loader(ds, per * n, np.random.default_rng(0), 0,
                             False)],
               "multihost": [loader(ds, per, np.random.default_rng(i), 0,
                                    False) for i in range(n)]}
    frozen = load_frozen(args.frozen_dir, cfg,
                         torch.Generator().manual_seed(1), cuda_device)
    step = m2.build_train_step(cfg)

    def losses(batches, fn):
        """The losses of ``fn(state, batch, gen)`` from the trainer's
        initial state over ``batches``, the pool drawn as train_cli draws
        it."""
        state = m2.init_state(cfg, torch.Generator().manual_seed(0),
                              cuda_device)
        return [{k: float(v) for k, v in fn(
            state, {k: v.to(cuda_device) for k, v in b.items()},
            torch.Generator(device=cuda_device).manual_seed(i)).items()}
            for i, b in enumerate(batches)]

    def ranks(state, b, gen):
        grads = decomposed_grads(step, state, b, frozen, gen, n)
        step.apply_grads(state, grads)
        return grads.metrics

    def first_alone(state, b, gen):
        return step.step(state, {k: v[:per] for k, v in b.items()}, frozen,
                         gen)

    for mode in ("dp", "multihost"):
        its = [iter(s) for s in streams[mode]]
        batches = []
        for _ in range(2):
            parts = [next(it) for it in its]
            batches.append({k: torch.cat([p[k] for p in parts])
                            for k in parts[0]})
        ref = losses(batches, ranks)
        again = [losses(batches, ranks)]
        torch.backends.cudnn.deterministic = True
        try:
            again.append(losses(batches, ranks))
        finally:
            torch.backends.cudnn.deterministic = False
        spread = [max(v) for v in zip(*(_loss_gaps(o, ref) for o in again))]
        fault = _loss_gaps(losses(batches, first_alone), ref)
        for got, bar, off in zip(_loss_gaps(runs[mode], ref), spread, fault):
            bar = max(1e-4, 3 * bar)
            assert got <= bar < off, (mode, got, bar, off)


def test_tp_generator_one_rank_a_card_matches_one_card(cuda_device,
                                                       tmp_path):
    """``tensor_parallel_generator`` of a trident generator (ngf 8, 3
    blocks) on a (n/2, 2) grid of cards against the generator on one card,
    4 frames at 64^2: within 1e-4, K2 launched on every rank on the channel
    slices and held to its plain version."""
    from animateportrait_tpu_torch.models.gan import TridentGeneratorFullIFW
    from animateportrait_tpu_torch.multichip import tp_run
    from animateportrait_tpu_torch.utils import distributed as ddp
    from animateportrait_tpu_torch.utils.smoke import jobs_rank

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
    from animateportrait_tpu_torch.utils.smoke import jobs_rank

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
    devices = _cards(cuda_device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    photo, a68, tb68 = _render_inputs(20)
    frames = []
    torch.backends.cudnn.deterministic = True
    try:
        for devs in (None, devices):
            r = _small_renderer(cuda_device, frame_batch=8 * (
                1 if devs is None else len(devs)), output_uint8=True,
                data_parallel=devs is not None, devices=devs)
            with torch.inference_mode():
                frames.append(r(photo, a68, tb68))
    finally:
        torch.backends.cudnn.deterministic = False
    assert [d for _, _, d in r.replicas] == devices
    assert np.array_equal(frames[0], frames[1])
