"""FLOPs and InstanceNorm shapes of the configurations' nets, counted by
``torch.utils.flop_counter.FlopCounterMode`` over the reference's frozen
nets on the ``meta`` device: shapes alone, no weights, no device, so the
count is the same whatever a later change does to the port."""
from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import inputs


@contextlib.contextmanager
def instance_norm_shapes():
    """Collect the shape of every InstanceNorm the frozen nets run."""
    from portbench.reference.frozen import nn as frozen_nn

    shapes: list[tuple[int, ...]] = []
    plain = frozen_nn.instance_norm

    def counted(x, *args, **kwargs):
        shapes.append(tuple(x.shape))
        return plain(x, *args, **kwargs)

    frozen_nn.instance_norm = counted
    try:
        yield shapes
    finally:
        frozen_nn.instance_norm = plain


def _flops(fn) -> tuple[int, list]:
    """(FLOPs, InstanceNorm shapes) of ``fn()`` on the meta device."""
    with instance_norm_shapes() as shapes, FlopCounterMode(
            display=False) as fc:
        fn()
    return fc.get_total_flops(), shapes


@functools.lru_cache(maxsize=None)
def renderer_work(ngf: int, flow_nf: int, static_ngf: int, output_nc: int,
                  frame_batch: int, crop: int = 256) -> dict:
    """The drawing renderer's work: per photo (MODNet, the static net at
    512 px, ``encode_static``) and per frame batch (the landmark dots,
    FlowUnet, the generator's ``decode``, the blend): FLOPs and
    InstanceNorm shapes of each."""
    from portbench.reference.frozen.models.flowunet import FlowUnet
    from portbench.reference.frozen.models.gan import (
        ResnetStyle2Generator, TridentGeneratorFullIFW)
    from portbench.reference.frozen.models.modnet import MODNet
    from portbench.reference.frozen.ops.tps import triangulate_frames
    from portbench.reference.frozen.pipeline.render import Module2Renderer

    meta = torch.device("meta")
    with meta:
        r = Module2Renderer(
            TridentGeneratorFullIFW(output_nc=output_nc, ngf=ngf, div=3,
                                    disp=3),
            FlowUnet(nf=flow_nf), MODNet(),
            ResnetStyle2Generator(ngf=static_ngf), frame_batch=frame_batch,
            output_uint8=True, device=meta, crop_size=crop)
    a = inputs.face_landmarks(np.random.default_rng(0), crop)
    tb = np.repeat(a[None], frame_batch, 0)
    tb = tb + np.random.default_rng(1).normal(0, 0.5, tb.shape).astype(
        np.float32)
    a68 = torch.as_tensor(a, device=meta)[None]
    cache = {}

    def photo():
        pf, mask, fs = r.prepare(torch.zeros(1, 3, crop, crop, device=meta))
        cache["per_photo"] = (r.encode(pf, a68), mask, fs)

    def batch():
        g_cache, mask, fs = cache["per_photo"]
        r.frames(g_cache, mask, fs, a68, torch.as_tensor(tb, device=meta),
                 None, torch.as_tensor(triangulate_frames(tb, crop),
                                       device=meta))

    with torch.no_grad():
        photo_flops, photo_in = _flops(photo)
        batch_flops, batch_in = _flops(batch)
    return {"photo_flops": photo_flops, "batch_flops": batch_flops,
            "frame_flops": batch_flops / frame_batch,
            "photo_in_shapes": photo_in, "batch_in_shapes": batch_in}


@functools.lru_cache(maxsize=None)
def train_step_work(batch: int, ngf: int = 64, ndf: int = 64,
                    crop: int = 256, output_nc: int = 1,
                    batch_d_passes: bool = True, pool_size: int = 50) -> dict:
    """FLOPs (forward and backward) and InstanceNorm shapes of one Module2
    gradient pass (``forward_shared``, G's and the Ds' losses and
    gradients) at ``batch``; Adam's elementwise update is left out."""
    from portbench.reference.frozen.train import module2 as m2

    cfg = m2.Module2Config(crop_size=crop, output_nc=output_nc, ngf=ngf,
                           ndf=ndf, batch_d_passes=batch_d_passes,
                           pool_size=pool_size)
    meta = torch.device("meta")
    cpu_gen = torch.Generator().manual_seed(0)
    with meta:
        state = m2.TrainState(
            step=0, g=m2.TridentGeneratorFullIFW(
                output_nc=output_nc, ngf=ngf, div=cfg.netg_resb_div,
                disp=cfg.netg_resb_disp).train(),
            d=torch.nn.ModuleDict({
                k: m2.NLayerDiscriminator(c, ndf, cfg.n_layers_d)
                for k, c in m2.d_input_channels(cfg).items()}).train(),
            g_opt=None, d_opt=None,
            pool=torch.zeros((pool_size, output_nc, crop, crop)),
            pool_count=0)
        frozen = m2.FrozenNets(m2.MODNet(), m2.MobileFaceNet(),
                               m2.Sphere20a(), m2.FlowUnet())
        for net in (frozen.modnet, frozen.mobilefacenet, frozen.sphere,
                    frozen.flowunet):
            net.eval().requires_grad_(False)
    b = m2.make_example_batch(cfg, batch, device=meta)
    step = m2.build_train_step(cfg)
    flops, shapes = _flops(lambda: step.grads(state, b, frozen, cpu_gen))
    return {"step_flops": flops, "in_shapes": shapes}
