"""The benchmark's own work counts (over the frozen nets) against
FlopCounterMode over the port's modules, at the configurations' widths
on the meta device."""
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import inputs
from portbench.counts import flops, k2_work


@pytest.fixture()
def plain_port_instance_norm(monkeypatch):
    """The port's InstanceNorm on meta tensors: its plain version (the
    kernel wrapper takes CPU and CUDA tensors only)."""
    from animateportrait_tpu_torch import nn as port_nn
    from animateportrait_tpu_torch.ops.instnorm import instance_norm_plain

    monkeypatch.setattr(port_nn, "instance_norm", instance_norm_plain)


def test_renderer_counts(plain_port_instance_norm):
    from animateportrait_tpu_torch.models.flowunet import FlowUnet
    from animateportrait_tpu_torch.models.gan import (
        ResnetStyle2Generator, TridentGeneratorFullIFW)
    from animateportrait_tpu_torch.models.modnet import MODNet
    from animateportrait_tpu_torch.ops.tps import triangulate_frames
    from animateportrait_tpu_torch.pipeline.render import Module2Renderer

    w = flops.renderer_work(64, 16, 64, 1, 32)
    assert w["frame_flops"] == pytest.approx(145.3e9, rel=1e-3)
    assert w["photo_flops"] == pytest.approx(428.5e9, rel=1e-3)
    assert len(w["photo_in_shapes"]) == 49
    assert len(w["batch_in_shapes"]) == 29
    meta = torch.device("meta")
    with meta:
        r = Module2Renderer(TridentGeneratorFullIFW(output_nc=1, ngf=64,
                                                    div=3, disp=3),
                            FlowUnet(nf=16), MODNet(),
                            ResnetStyle2Generator(ngf=64), frame_batch=32,
                            output_uint8=True, device=meta)
    a = inputs.face_landmarks(np.random.default_rng(0), 256)
    tb = torch.as_tensor(a[None].repeat(32, 0), device=meta)
    a68 = torch.as_tensor(a, device=meta)[None]
    with torch.no_grad():
        with FlopCounterMode(display=False) as fc:
            pf, mask, fs = r.prepare(torch.zeros(1, 3, 256, 256,
                                                 device=meta))
            cache = r.encode(pf, a68)
        assert fc.get_total_flops() == w["photo_flops"]
        tris = torch.as_tensor(triangulate_frames(a[None].repeat(32, 0)
                                                  + 0.1, 256), device=meta)
        with FlopCounterMode(display=False) as fc:
            r.frames(cache, mask, fs, a68, tb, None, tris)
        assert fc.get_total_flops() == w["batch_flops"]


def test_train_step_counts(plain_port_instance_norm):
    """At the configuration's batch of 1, D passes one by one, as
    ``utils/options.py`` sets them at batch 1."""
    import json
    import os

    from animateportrait_tpu_torch.train import module2 as m2

    with open(os.path.join(os.path.dirname(flops.__file__), os.pardir,
                           "configs", "module2_train.json")) as f:
        conf = json.load(f)
    n, passes = conf["batch_size"], conf["batch_d_passes"]
    assert (n, passes) == (1, False)
    w = flops.train_step_work(n, batch_d_passes=passes)
    assert w["step_flops"] / n == pytest.approx(1.274e12, rel=1e-3)
    assert len(w["in_shapes"]) == 164
    cfg = m2.Module2Config(batch_d_passes=passes)
    meta = torch.device("meta")
    with meta:
        state = m2.TrainState(
            step=0, g=m2.TridentGeneratorFullIFW(output_nc=1, ngf=64,
                                                 div=3, disp=3),
            d=torch.nn.ModuleDict({
                k: m2.NLayerDiscriminator(c, 64, 3)
                for k, c in m2.d_input_channels(cfg).items()}),
            g_opt=None, d_opt=None, pool=torch.zeros(50, 1, 256, 256),
            pool_count=0)
        frozen = m2.FrozenNets(m2.MODNet(), m2.MobileFaceNet(),
                               m2.Sphere20a(), m2.FlowUnet())
        for net in (frozen.modnet, frozen.mobilefacenet, frozen.sphere,
                    frozen.flowunet):
            net.eval().requires_grad_(False)
    batch = m2.make_example_batch(cfg, n, device=meta)
    with FlopCounterMode(display=False) as fc:
        m2.build_train_step(cfg).grads(state, batch, frozen,
                                       torch.Generator().manual_seed(0))
    assert fc.get_total_flops() == w["step_flops"]


def test_k2_work():
    assert k2_work((32, 256, 64, 64)) == (2 * 4 * 32 * 256 * 64 * 64,
                                          8 * 32 * 256 * 64 * 64)
