"""Process groups and collectives of the port's multi-card paths: the
data-parallel trainer (``train_cli --data_parallel`` / ``--multihost``),
the GPipe schedule (``parallel.py``) and the tests and smoke runs that
start several ranks on one machine.

The JAX package runs these paths as one program over a device mesh, where
GSPMD inserts the collectives; here each card is one process (a rank) of a
``torch.distributed`` group, and the collectives are explicit:

- ``init_group`` joins a group from the JAX CLI's flags (the coordinator
  address becomes a ``tcp://`` init method, ``--num_processes`` the world
  size, ``--process_id`` the rank), with NCCL for CUDA and gloo for the
  CPU (``backend_for``), and a timeout on the join and on every
  collective, so that a lost rank fails the run instead of hanging it;
- ``all_gather_batch``, ``all_reduce_mean_``, ``scatter_batch``,
  ``broadcast_module``, ``broadcast_tensors``, ``send``/``recv`` and
  ``barrier``;
- ``spawn`` runs a function on N ranks of this machine
  (``torch.multiprocessing.spawn``, localhost rendezvous on a
  ``free_port``).

NCCL refuses two ranks on one card, so several ranks on one card run over
gloo. Gloo takes CUDA tensors for ``broadcast`` and ``all_reduce`` only:
``all_gather``, ``scatter``, ``send`` and ``recv`` of a CUDA tensor over
gloo go through host memory (``_staged``), an explicit branch on the
backend; the compute stays on the card either way.
"""
from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as dist

# the join and every collective: a rank that is gone fails the others'
# next collective after this long instead of hanging them
TIMEOUT = datetime.timedelta(seconds=600)


def backend_for(device: torch.device | str) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_method(address: str) -> str:
    """The JAX CLI's ``--coordinator_address`` (``host:port``) as an init
    method."""
    return address if "://" in address else f"tcp://{address}"


def free_port() -> int:
    """A TCP port of localhost that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(device_type: str, rank: int) -> torch.device:
    """The device of ``rank``: ``cuda:<local rank>`` (``LOCAL_RANK`` where
    a launcher sets it, else the rank modulo the cards of this machine),
    or the CPU."""
    if device_type != "cuda":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", rank % max(
        torch.cuda.device_count(), 1)))
    return torch.device("cuda", local)


def init_group(init: str, world_size: int, rank: int,
               device: torch.device | str, backend: str | None = None
               ) -> None:
    """Join the default process group; ``backend`` defaults to
    ``backend_for(device)`` (``spawn`` passes gloo for several ranks on
    one card). A CUDA rank first makes ``device`` its current device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or backend_for(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method(init),
                            world_size=world_size, rank=rank,
                            timeout=TIMEOUT, **kw)


def world(group=None) -> tuple[int, int]:
    """(this process's rank in ``group``, its size)."""
    return dist.get_rank(group), dist.get_world_size(group)


def _staged(t: torch.Tensor, group) -> bool:
    """Whether a CUDA tensor goes through host memory: gloo's all_gather,
    scatter, send and recv take CPU tensors only."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_gather_batch(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes), concatenated along the batch in
    rank order: the JAX package's shard order, contiguous batch slices,
    process-major."""
    _, n = world(group)
    src = x.detach().contiguous()
    if _staged(src, group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(x.device)


def all_reduce_mean_(tensors: list[torch.Tensor], group=None) -> None:
    """Replace each tensor by its mean over the ranks, in place, through
    one flattened buffer per dtype. With equal shards per rank, the mean
    of the ranks' batch means is the mean over the global batch."""
    _, n = world(group)
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        same = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=group)
        flat /= n
        for t, v in zip(same, flat.split([t.numel() for t in same])):
            t.copy_(v.view_as(t))


def all_gather_dim(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes), concatenated along ``dim`` in
    rank order (the tensor-parallel generator's channel slices)."""
    if dim == 0:
        return all_gather_batch(x, group)
    return torch.cat(all_gather_batch(x.movedim(dim, 0).unsqueeze(0),
                                      group).unbind(0), dim=0).movedim(0, dim)


def all_gather_flat(tensors: list[torch.Tensor], group=None
                    ) -> list[torch.Tensor]:
    """Every rank's ``tensors`` (the same shapes on every rank), through
    one flattened buffer per dtype: for each tensor, the ranks' copies
    stacked, (world, *shape), rank r's at [r]."""
    _, n = world(group)
    out: list = [None] * len(tensors)
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        every = all_gather_batch(flat[None], group)        # (n, total)
        for i, part in zip(idx, every.split(
                [tensors[i].numel() for i in idx], dim=1)):
            out[i] = part.reshape(n, *tensors[i].shape)
    return out


def reduce_scatter_mean(parts: list[torch.Tensor], group=None
                        ) -> list[torch.Tensor]:
    """For each tensor of ``parts`` ((world, *shape): rank r's share at
    [r]), the mean over the ranks of this rank's share, through one
    flattened buffer per dtype: NCCL's reduce-scatter; under gloo, which
    reduce-scatters no CUDA tensor, an all-reduce of the buffer and then
    this rank's share of it."""
    rank, n = world(group)
    out: list = [None] * len(parts)
    for dtype in dict.fromkeys(t.dtype for t in parts):
        idx = [i for i, t in enumerate(parts) if t.dtype == dtype]
        sizes = [parts[i][0].numel() for i in idx]
        flat = torch.cat([parts[i][r].reshape(-1) for r in range(n)
                          for i in idx])
        total = sum(sizes)
        if dist.get_backend(group) == "nccl":
            mine = torch.empty(total, dtype=dtype, device=flat.device)
            dist.reduce_scatter_tensor(mine, flat, group=group)
        else:
            dist.all_reduce(flat, group=group)
            mine = flat[rank * total:(rank + 1) * total]
        mine = mine / n
        for i, v in zip(idx, mine.split(sizes)):
            out[i] = v.view(parts[i].shape[1:])
    return out


def grid_groups(shape: tuple[int, int]) -> tuple:
    """The (data group, model group) of this rank in a (data, model) grid
    of the world's ranks, row-major (rank = i * model + j): the model
    group is the rank's row of ``model`` ranks, the data group its column
    of ``data`` ranks. Every rank builds every group (``dist.new_group``
    is collective), in the same order."""
    d, m = shape
    rank, n = world()
    if d * m != n:
        raise ValueError(f"grid {shape} for {n} ranks")
    rows = [dist.new_group(list(range(i * m, (i + 1) * m)), timeout=TIMEOUT)
            for i in range(d)]
    cols = [dist.new_group(list(range(j, n, m)), timeout=TIMEOUT)
            for j in range(m)]
    return cols[rank % m], rows[rank // m]


def broadcast_tensors(tensors: list[torch.Tensor], group=None) -> None:
    """Overwrite ``tensors`` (the same shapes on every rank) with rank 0's,
    in place."""
    for t in tensors:
        dist.broadcast(t.data, src=0, group=group)


def broadcast_module(module: torch.nn.Module, group=None) -> None:
    """Give every rank rank 0's parameters and buffers."""
    broadcast_tensors([*module.parameters(), *module.buffers()], group)


def scatter_batch(batch: dict | None, device: torch.device,
                  group=None) -> dict:
    """Rank 0 holds the global batch (a dict of tensors whose first
    dimension divides by the world size); every rank gets its contiguous
    slice, in rank order, on ``device``. Under NCCL the batch moves to
    rank 0's card first; under gloo it goes through host memory."""
    rank, n = world(group)
    src = 0
    meta = [None]
    if rank == src:
        meta = [{k: (tuple(v.shape), v.dtype) for k, v in batch.items()}]
    # under NCCL the object travels through this rank's current card
    dist.broadcast_object_list(meta, src=src, group=group)
    gloo = dist.get_backend(group) == "gloo"
    where = torch.device("cpu") if gloo else device
    out = {}
    for k, (shape, dtype) in meta[0].items():
        if shape[0] % n:
            raise ValueError(f"scatter_batch: {k} has {shape[0]} items for "
                             f"{n} ranks")
        part = torch.empty((shape[0] // n, *shape[1:]), dtype=dtype,
                           device=where)
        parts = None
        if rank == src:
            parts = list(batch[k].to(where).contiguous().chunk(n))
        dist.scatter(part, parts, src=src, group=group)
        out[k] = part.to(device, non_blocking=True)
    return out


def send(t: torch.Tensor, dst: int, group=None) -> None:
    """Send ``t`` to group rank ``dst``."""
    peer = dist.get_global_rank(group, dst) if group is not None else dst
    dist.send(t.cpu() if _staged(t, group) else t.contiguous(), dst=peer,
              group=group)


def recv(like: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """A tensor shaped as ``like``, received from group rank ``src``."""
    peer = dist.get_global_rank(group, src) if group is not None else src
    if _staged(like, group):
        host = torch.empty(like.shape, dtype=like.dtype)
        dist.recv(host, src=peer, group=group)
        return host.to(like.device)
    out = torch.empty_like(like)
    dist.recv(out, src=peer, group=group)
    return out


def barrier(group=None) -> None:
    """Wait for every rank, within the group's timeout. Gloo's barrier is
    an all-reduce of one CPU value; NCCL's runs on this rank's card."""
    if dist.get_backend(group) == "nccl":
        dist.barrier(group=group,
                     device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=group)


def _precision() -> dict:
    """This process's float32 settings of matmuls and convs, which a
    spawned rank would otherwise take at their defaults (cuDNN's TF32 on)."""
    return {"matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_precision": torch.get_float32_matmul_precision()}


def _rank_main(rank: int, fn, world_size: int, init: str, devices: list,
               backend: str | None, threads: int, precision: dict,
               args: tuple) -> None:
    torch.set_num_threads(threads)
    torch.backends.cuda.matmul.allow_tf32 = precision["matmul_tf32"]
    torch.backends.cudnn.allow_tf32 = precision["cudnn_tf32"]
    torch.set_float32_matmul_precision(precision["matmul_precision"])
    device = torch.device(devices[rank])
    init_group(init, world_size, rank, device, backend)
    try:
        fn(rank, world_size, device, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, devices: list, *args, timeout: float | None = None) -> None:
    """Run ``fn(rank, world_size, device, *args)`` on one rank per entry of
    ``devices`` (repeats allowed: several ranks on one card run over gloo,
    since NCCL refuses them; else the backend is ``backend_for``'s), each a
    spawned process joined to a fresh localhost group, and wait for all of
    them; a rank's exception is raised here. ``fn`` and ``args`` are
    pickled (``fn`` by its import path). Each rank takes this process's
    torch threads divided by the ranks, so the ranks do not oversubscribe
    the cores, and this process's float32 matmul and conv precision (TF32
    or not). With a ``timeout``, ranks still running after that many
    seconds are killed, and that raises."""
    import time

    import torch.multiprocessing as mp

    devices = [str(d) for d in devices]
    n = len(devices)
    backend = backend_for(devices[0])
    if backend == "nccl" and len(set(devices)) < n:
        backend = "gloo"
    threads = max(1, torch.get_num_threads() // n)
    ctx = mp.spawn(_rank_main, nprocs=n, join=False,
                   args=(fn, n, f"tcp://127.0.0.1:{free_port()}", devices,
                         backend, threads, _precision(), args))
    deadline = None if timeout is None else time.monotonic() + timeout
    # join raises at the first rank that fails, after stopping the others
    while not ctx.join(timeout=None if deadline is None else max(
            deadline - time.monotonic(), 0.0)):
        if deadline is not None and time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
                p.join()
            raise TimeoutError(f"spawn: {n} ranks of {fn.__qualname__} "
                               f"still running after {timeout} s")
