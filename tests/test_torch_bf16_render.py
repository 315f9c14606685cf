"""The port's bf16 renderer (``Module2Renderer(use_bf16=True)``, the CLI's
``--render_bf16``) against the JAX package's, on the CPU, in both styles, at
the small widths of ``tests/test_torch_render.py`` and
``tests/test_torch_cartoon.py`` (generator ngf 8 with 3 blocks, FlowUnet nf
4 with 3 scales), on the same weights, photo and landmarks.

bf16 rounds at other places in the two frameworks, so the bars are relative
to JAX's own bf16 error against its fp32 frames:
(a) PSNR(port bf16, JAX fp32) >= PSNR(JAX bf16, JAX fp32) - 1 dB;
(b) PSNR(port bf16, JAX bf16) >= PSNR(JAX bf16, JAX fp32) - 3.5 dB (two
independent roundings of equal power).
"""
import numpy as np
import pytest
import torch

from animateportrait_tpu_torch import cli
from animateportrait_tpu_torch.utils import video
from test_torch_cartoon import cartoon_renderers  # noqa: F401
from test_torch_cli import TINY, inputs  # noqa: F401
from test_torch_render import renderers, scene  # noqa: F401
from torch_port_helpers import psnr

BAR_A_DB = 1.0
BAR_B_DB = 3.5


def _bf16_twins(jr, tr):
    """bf16 renderers on the nets of the fp32 pair."""
    from animateportrait_tpu.pipeline.render import Module2Renderer as JR
    from animateportrait_tpu_torch.pipeline.render import Module2Renderer

    g = jr.g
    jb = JR(jr.v, style=jr.style, output_nc=g.output_nc, ngf=g.ngf,
            n_blocks=g.n_blocks, div=g.div, disp=g.disp,
            frame_batch=jr.frame_batch, flowunet=jr.flowunet,
            modnet=jr.modnet, static_g=jr.static_g, cartoon_g=jr.cartoon_g,
            use_bf16=True)
    static = {"static_g" if tr.style == "drawing" else "cartoon_g":
              tr.static_net}
    tb = Module2Renderer(tr.g, tr.flowunet, tr.modnet,
                         frame_batch=tr.frame_batch, device="cpu",
                         style=tr.style, use_bf16=True, **static)
    return jb, tb


@pytest.fixture(scope="module", params=["drawing", "cartoon"])
def frames(request, scene):  # noqa: F811 (the imported fixture)
    """JAX fp32, JAX bf16, port bf16 and port fp32 frames of 3 targets."""
    jr, tr = request.getfixturevalue(
        "renderers" if request.param == "drawing" else "cartoon_renderers")
    jb, tb = _bf16_twins(jr, tr)
    photo, a68, tb68 = scene
    with torch.no_grad():
        out = dict(j32=np.asarray(jr(photo, a68, tb68)),
                   jb=np.asarray(jb(photo, a68, tb68)),
                   pb=tb(photo, a68, tb68), p32=tr(photo, a68, tb68))
    return request.param, tr, tb, out


def test_bf16_render_is_as_close_to_fp32_as_jaxs(frames):
    """(a). Measured: drawing JAX bf16 vs fp32 39.09 dB, port bf16 vs JAX
    fp32 38.84 dB; cartoon 39.00 / 38.67 dB."""
    style, _, _, f = frames
    nc = 1 if style == "drawing" else 3
    assert f["pb"].shape == f["j32"].shape == (3, 256, 256, nc)
    assert f["pb"].dtype == np.float32
    assert psnr(f["pb"], f["j32"]) >= psnr(f["jb"], f["j32"]) - BAR_A_DB


def test_bf16_render_matches_jax_bf16(frames):
    """(b). Measured: port bf16 vs JAX bf16 39.91 dB (drawing), 40.13 dB
    (cartoon); JAX bf16 vs fp32 as in (a)."""
    _, _, _, f = frames
    assert psnr(f["pb"], f["jb"]) >= psnr(f["jb"], f["j32"]) - BAR_B_DB


def test_bf16_renderer_casts_copies_of_the_per_frame_nets(frames):
    """The generator and FlowUnet's parameters are bf16 copies (FlowUnet's
    BatchNorm statistics stay fp32); MODNet, the static net and the
    caller's nets stay fp32, so the fp32 renderer's frames are those of a
    renderer built before the bf16 one."""
    _, tr, tb, f = frames
    assert {p.dtype for p in tb.g.parameters()} == {torch.bfloat16}
    assert {p.dtype for p in tb.flowunet.parameters()} == {torch.bfloat16}
    assert {b.dtype for b in tb.flowunet.buffers()
            if b.is_floating_point()} == {torch.float32}
    for net in (tr.g, tr.flowunet, tb.modnet, tb.static_net):
        assert {p.dtype for p in net.parameters()} == {torch.float32}
    assert psnr(f["p32"], f["j32"]) >= 40.0


def test_cli_render_bf16_writes_an_avi(inputs):  # noqa: F811
    """``cli.main --render_bf16`` on the CPU, drawing style, at the tiny
    widths: an AVI of gray frames that differ from the fp32 run's, though
    little (measured: 39.08 dB over 20 frames)."""
    d, png, wav, ckpt = inputs
    base = ["--jpg", png, "--audio", wav, "--exp", "formal/drawing",
            "--ckpt_dir", ckpt, *TINY]
    res = cli.main(base + ["--render_bf16", "--output", str(d / "bf16")])
    ref = cli.main(base + ["--output", str(d / "fp32")])
    f = video.read_avi(res.path)["frames"]
    f32 = video.read_avi(ref.path)["frames"]
    assert f.shape == f32.shape == (res.frames, 256, 256, 3)
    np.testing.assert_array_equal(f[..., 0], f[..., 2])
    assert 30.0 <= psnr(f, f32, peak=255.0) < float("inf")
