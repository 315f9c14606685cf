"""Model parallelism over the ranks of a process group: the GPipe
pipeline (port of ``animateportrait_tpu/parallel.py``), the tensor-parallel
generator and the sequence-parallel landmark branch (ports of the modes of
``__graft_entry__.py:dryrun_multichip``, where GSPMD inserts the
collectives of a sharded program; here each is explicit).

The JAX package shards a stack of per-stage parameters over a mesh axis
and moves activations stage to stage with ``lax.ppermute`` inside one
``shard_map`` program. Here each rank of ``group`` is one stage and holds
its own stage as an ``nn.Module`` (``resnet_stage`` of its share of the
blocks, ``stage_blocks``); activations travel by point-to-point
``send``/``recv`` (``utils/distributed.py``: through host memory for a
CUDA tensor under gloo, on the card under NCCL).

The schedule is the same: the batch is split into M microbatches, and at
tick t = 0 .. P + M - 2 stage s applies its blocks to microbatch t - s
when that is one of them; the last stage's outputs then go to every rank
(a broadcast where JAX takes a masked ``psum``). The steady-state bubble
is (P - 1) / (P + M - 1), so M >= P (the default M = P). Where the JAX
loop computes on a ghost input in a stage's idle ticks, the stage here
waits.
"""
from __future__ import annotations

import copy
import math

import torch
import torch.distributed as dist
import torch.nn as nn

from animateportrait_tpu_torch.nn import InstanceNorm2d
from animateportrait_tpu_torch.utils import distributed as ddp


def stage_blocks(blocks: list, n_stages: int, stage: int) -> list:
    """Stage ``stage``'s share of ``blocks``: the ``stage``-th of
    ``n_stages`` contiguous equal runs (the JAX tests stack
    ``n_stages * blocks_per_stage`` blocks in this order)."""
    if len(blocks) % n_stages:
        raise ValueError(f"{len(blocks)} blocks do not split into "
                         f"{n_stages} equal stages")
    per = len(blocks) // n_stages
    return list(blocks[stage * per:(stage + 1) * per])


def resnet_stage(blocks: list) -> nn.Sequential:
    """A stage: its ``models/gan.py:ResnetBlock``s in order (the JAX
    ``resnet_stage_fn``'s scan over the stage's stacked blocks)."""
    return nn.Sequential(*blocks)


@torch.no_grad()
def seq_apply(blocks: list, x: torch.Tensor) -> torch.Tensor:
    """The sequential reference: every block in order (JAX ``_seq_apply``)."""
    for block in blocks:
        x = block(x)
    return x


@torch.no_grad()
def gpipe_apply(stage: nn.Module, x: torch.Tensor, group=None,
                num_microbatches: int | None = None) -> torch.Tensor:
    """Run this rank's ``stage`` in a P-stage GPipe forward over ``group``
    (default: the whole world; stage s is group rank s) and return the
    pipeline's output, ``x``'s shape, on every rank.

    ``x`` is the whole batch, the same on every rank (stage 0 reads it; the
    others take its shape); it splits into ``num_microbatches`` (default
    P) microbatches, and an indivisible batch raises ``ValueError``.
    Every stage maps an activation to one of the same shape and dtype (true
    of the generator's ResNet bottleneck). Forward only, as the JAX
    package's tests run it."""
    s, n_stages = ddp.world(group)
    m = num_microbatches or n_stages
    if x.shape[0] % m:
        raise ValueError(
            f"batch {x.shape[0]} not divisible by {m} microbatches")
    mbs = x.reshape(m, x.shape[0] // m, *x.shape[1:])
    outs = torch.zeros_like(mbs)
    for t in range(n_stages + m - 1):
        i = t - s                   # the microbatch at this stage now
        if not 0 <= i < m:
            continue
        h = mbs[i] if s == 0 else ddp.recv(mbs[0], s - 1, group)
        y = stage(h)
        if s < n_stages - 1:
            ddp.send(y, s + 1, group)
        else:
            outs[i] = y
    last = (dist.get_global_rank(group, n_stages - 1) if group is not None
            else n_stages - 1)
    dist.broadcast(outs, src=last, group=group)
    return outs.reshape(x.shape)


# --- tensor parallelism: the trident generator ------------------------------

# modules that act on each channel alone: a channel slice goes through them
# before its all-gather
_CHANNEL_LOCAL = (InstanceNorm2d, nn.Identity, nn.ReLU, nn.LeakyReLU,
                  nn.Tanh)


def tp_sharded(mod: nn.Module) -> bool:
    """JAX's ``tp_spec`` rule (``__graft_entry__.py:131-136``): a conv
    kernel whose last HWIO axis is even is sharded. That axis is the
    weight's first in torch's layout, for a conv (its output channels) and
    a transposed conv (its input channels: JAX keeps that kernel HWOI)."""
    return (isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d))
            and mod.weight.shape[0] % 2 == 0)


def _column_slice(conv: nn.Module, rank: int, world: int) -> nn.Module:
    """A copy of ``conv`` that computes output channels
    [rank * C / world, (rank + 1) * C / world) only."""
    out = copy.deepcopy(conv)
    axis = 1 if isinstance(conv, nn.ConvTranspose2d) else 0
    c = conv.weight.shape[axis]
    if c % world:
        raise ValueError(f"{c} output channels over {world} model ranks")
    s = c // world
    out.weight = nn.Parameter(conv.weight.detach().narrow(
        axis, rank * s, s).clone())
    if conv.bias is not None:
        out.bias = nn.Parameter(conv.bias.detach()[rank * s:(rank + 1) * s]
                                .clone())
    out.out_channels = s
    return out


class GatherChannels(nn.Module):
    """``module`` on a channel slice, then the slices of the model group
    all-gathered along channels."""

    def __init__(self, module: nn.Module, group):
        super().__init__()
        self.module, self.group = module, group

    def forward(self, x):
        return ddp.all_gather_dim(self.module(x), 1, self.group)


def _shard_columns(mod: nn.Module, rank: int, world: int, group) -> None:
    """Replace, in place, each ``tp_sharded`` conv under ``mod`` by its
    output-channel slice, and all-gather the slices after the channel-local
    modules that follow it in a ``Sequential`` (before the first that mixes
    channels, or at the end)."""
    for name, child in mod.named_children():
        if isinstance(child, nn.Sequential):
            kids = list(child)
            pending = None          # the last slice-wise module of a run
            for i, k in enumerate(kids):
                if pending is not None and isinstance(k, _CHANNEL_LOCAL):
                    pending = i
                    continue
                if pending is not None:
                    kids[pending] = GatherChannels(kids[pending], group)
                    pending = None
                if tp_sharded(k):
                    kids[i] = _column_slice(k, rank, world)
                    pending = i
                else:
                    _shard_columns(k, rank, world, group)
            if pending is not None:
                kids[pending] = GatherChannels(kids[pending], group)
            setattr(mod, name, nn.Sequential(*kids))
        elif tp_sharded(child):
            setattr(mod, name, GatherChannels(
                _column_slice(child, rank, world), group))
        else:
            _shard_columns(child, rank, world, group)


class TensorParallelGenerator(nn.Module):
    """``tensor_parallel_generator``'s module: forward(x_in, land1, land2,
    motion, flow, ifmask) as ``TridentGeneratorFullIFW``'s, on the whole
    frame batch on every rank; each rank computes its data group's share
    of the frames and its model group's share of each sharded conv's
    channels, and returns the whole batch."""

    def __init__(self, g: nn.Module, data_group, model_group):
        super().__init__()
        self.data_group, self.model_group = data_group, model_group
        rank, world = ddp.world(model_group)
        self.g = copy.deepcopy(g)
        _shard_columns(self.g, rank, world, model_group)

    @torch.no_grad()
    def forward(self, *args):
        r, n = ddp.world(self.data_group)
        b = args[0].shape[0]
        if b % n:
            raise ValueError(f"{b} frames over {n} data ranks")
        mine = [a[r * b // n:(r + 1) * b // n] for a in args]
        return ddp.all_gather_batch(self.g(*mine), self.data_group)


def tensor_parallel_generator(g: nn.Module, data_group, model_group
                              ) -> TensorParallelGenerator:
    """The trident generator ``g`` (``models/gan.py:
    TridentGeneratorFullIFW``) in tensor-parallel inference over a (data,
    model) grid of ranks (``utils/distributed.py:grid_groups``): every
    conv that JAX's ``tp_spec`` shards keeps only its output-channel slice
    on each model rank, and InstanceNorm (K2) runs on the slice (N/d,
    C/m, H, W) before the slices are all-gathered along channels; the
    frames are sharded over the data group. Every rank must call this with
    the same ``g``."""
    return TensorParallelGenerator(g, data_group, model_group)


# --- sequence parallelism: the landmark branch ------------------------------


def _sp_attention(attn: nn.Module, x: torch.Tensor, group) -> torch.Tensor:
    """Self-attention of this rank's frames ``x`` (1, t, d) against the
    keys and values of every rank's: each rank projects its own, and one
    all-gather along the sequence joins them in frame order."""
    kv = torch.cat([attn.k_linear(x), attn.v_linear(x)], dim=-1)
    k, v = ddp.all_gather_dim(kv, 1, group).chunk(2, dim=-1)
    return attn.attend(attn.q_linear(x), k, v)


@torch.no_grad()
def sequence_parallel_pos(pos: nn.Module, au: torch.Tensor,
                          emb: torch.Tensor, face_id: torch.Tensor,
                          z: torch.Tensor, group=None) -> torch.Tensor:
    """``Audio2landmarkPos`` (``models/audio2landmark.py``) on one segment
    of T frames, sequence-parallel over ``group``: au (T, 18, 80), emb (T,
    256), z (T, 128) the whole segment on every rank (face_id is not used
    by the landmarks). Rank r computes frames [r T / n, (r + 1) T / n):
    its LSTM windows, speaker MLP, embedding at those positions, norms,
    feed-forwards and output MLP stay local; each attention layer gathers
    every rank's keys and values, so the segment stays one attention
    sequence (the reference's ``unsqueeze(0)``). Returns the landmarks
    (T, 204) in frame order on every rank. T must divide by the ranks."""
    r, n = ddp.world(group)
    T = au.shape[0]
    if T % n:
        raise ValueError(f"{T} frames over {n} ranks")
    t = T // n
    mine = slice(r * t, (r + 1) * t)
    a, _ = pos.audio_content_encoder(au[mine])
    comb = torch.cat([a[:, -1, :], pos.spk_emb_encoder(emb[mine]), z[mine]],
                     dim=-1)[None]
    enc = pos.encoder
    x = (enc.embed(comb) * math.sqrt(enc.pe.d_model)
         + enc.pe.pe[:, r * t:(r + 1) * t])
    for layer in enc.layers:
        x = x + _sp_attention(layer.attn, layer.norm_1(x), group)
        x = x + layer.ff(layer.norm_2(x))
    out = pos.out(torch.cat([enc.norm(x)[0], z[mine]], dim=-1))
    return ddp.all_gather_batch(out, group)
