"""GPipe pipeline parallelism over the ranks of a process group. Port of
``animateportrait_tpu/parallel.py``.

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

import torch
import torch.distributed as dist
import torch.nn as nn

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
