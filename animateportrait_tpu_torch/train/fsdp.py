"""FSDP sharding of the Module2 train state over the ranks of a process
group. Port of ``animateportrait_tpu/train/module2.py:798-869``
(``fsdp_param_shardings``, ``shard_state_fsdp``, ``state_shardings``).

The JAX package places each large leaf of G, the Ds and their Adam moments
sharded along one axis over a mesh axis, and XLA inserts the all-gathers
on use and the reduce-scatters of the gradients. Here each rank of a
``torch.distributed`` group keeps only its contiguous slice of every
sharded G and D parameter and of both its Adam moments; the pool, the
step, the small leaves and the frozen nets stay replicated. A step of a
sharded state (``Module2TrainStep.grads`` / ``step``):

- gathers the full G and D leaves once, before the forward (one flat
  all-gather per dtype, ``utils/distributed.py:all_gather_flat``), into the
  nets' own parameters, which hold an empty tensor between steps;
- runs the data-parallel step (the fakes gathered, the pool queried with
  the global batch);
- reduce-scatters the gradient means of the sharded leaves into each
  rank's slice (``reduce_scatter_mean``: NCCL's reduce-scatter; under gloo
  an all-reduce, then the rank's slice) and all-reduces the rest;
- frees the gathered leaves, and Adam updates the slices.

The step's config does not touch the sharding, as in the JAX package:
under ``compute_dtype="bfloat16"`` the step casts the gathered fp32
leaves, and under ``remat`` it recomputes G's forwards while they are
still gathered, so both run sharded as they run unsharded.

Adam's state is keyed by the slices (``FSDPShards.masters``), which live
as long as the state; a replicated leaf's master is the net's own
parameter. ``gather_state`` returns the whole state on every rank (the
JAX ``state_shardings`` keeps it placed; here the checkpoint writer needs
it whole), so a checkpoint saved under FSDP is the one saved without it.
"""
from __future__ import annotations

import contextlib
import copy
import math

import torch
import torch.distributed as dist
import torch.nn as nn

from animateportrait_tpu_torch.utils import distributed as ddp

# torch's OIHW conv weight (and (I, O, H, W) transposed-conv weight) holds
# at axis t the axis JAX_OF_TORCH_4D[t] of the JAX kernel (HWIO, and HWOI
# for the transposed conv): io/from_jax.py transposes by (3, 2, 0, 1)
JAX_OF_TORCH_4D = (3, 2, 0, 1)


def shard_axis(shape: tuple, world: int, min_size: int = 2 ** 16
               ) -> int | None:
    """JAX's rule for one leaf of torch ``shape``: None (replicated) for
    fewer than ``min_size`` elements; else the leaf's largest axis that
    divides by ``world`` in the JAX layout, ties broken by the JAX axis
    order (its stable ``sorted``), as a torch axis; None if none divides."""
    if math.prod(shape) < min_size:
        return None
    perm = JAX_OF_TORCH_4D if len(shape) == 4 else tuple(range(len(shape)))
    jshape = [0] * len(shape)
    for t, j in enumerate(perm):
        jshape[j] = shape[t]
    for j in sorted(range(len(jshape)), key=lambda i: -jshape[i]):
        if jshape[j] % world == 0 and jshape[j] >= world:
            return perm.index(j)
    return None


def fsdp_param_shardings(params: dict, world: int, min_size: int = 2 ** 16
                         ) -> dict[str, int | None]:
    """The shard axis of each leaf of ``params`` (state-dict key -> tensor)
    over ``world`` ranks, or None where it is replicated (``shard_axis``)."""
    return {k: shard_axis(tuple(v.shape), world, min_size)
            for k, v in params.items()}


def _slice(x: torch.Tensor, axis: int, rank: int, world: int
           ) -> torch.Tensor:
    s = x.shape[axis] // world
    return x.narrow(axis, rank * s, s)


def _parts(x: torch.Tensor, axis: int, world: int) -> torch.Tensor:
    """``x`` split into ``world`` equal slices along ``axis``, stacked:
    (world, *slice shape), rank r's slice at [r]."""
    shape = list(x.shape)
    shape[axis:axis + 1] = [world, shape[axis] // world]
    return x.reshape(shape).movedim(axis, 0)


def _whole(parts: torch.Tensor, axis: int) -> torch.Tensor:
    """The inverse of ``_parts``: the slices in rank order along ``axis``."""
    shape = list(parts.shape[1:])
    shape[axis] *= parts.shape[0]
    return parts.movedim(0, axis).reshape(shape)


class FSDPShards:
    """The sharding of a ``TrainState``'s G and Ds over ``group``: each
    leaf's shard axis (``specs``), the tensors Adam updates (``masters``:
    this rank's slice of a sharded leaf, the net's own parameter of a
    replicated one), and the nets whose sharded parameters are gathered
    for a step and emptied after it."""

    def __init__(self, nets: dict[str, nn.Module], group, min_size: int):
        # the step tells a data-parallel pass by its group: never None
        self.group = dist.group.WORLD if group is None else group
        self.rank, self.world = ddp.world(group)
        self.nets = nets
        self.specs = {key: fsdp_param_shardings(
            dict(net.named_parameters()), self.world, min_size)
            for key, net in nets.items()}
        self.masters = {}
        for key, net in nets.items():
            self.masters[key] = {
                name: p if self.specs[key][name] is None else nn.Parameter(
                    _slice(p.detach(), self.specs[key][name], self.rank,
                           self.world).clone())
                for name, p in net.named_parameters()}
        self.opts: dict[str, torch.optim.Adam] = {}   # shard_state_fsdp's

    def sharded(self):
        """(net key, name, the net's parameter, its master, axis) of every
        sharded leaf, in a fixed order."""
        for key, net in self.nets.items():
            for name, p in net.named_parameters():
                axis = self.specs[key][name]
                if axis is not None:
                    yield key, name, p, self.masters[key][name], axis

    def gather(self) -> None:
        """Every sharded parameter whole, in the nets: one flat all-gather
        per dtype."""
        leaves = list(self.sharded())
        full = ddp.all_gather_flat([m.detach() for *_, m, _ in leaves],
                                   self.group)
        for (_, _, p, _, axis), parts in zip(leaves, full):
            p.data = _whole(parts, axis)

    def free(self) -> None:
        """Drop the gathered parameters: each holds an empty tensor."""
        for _, _, p, m, _ in self.sharded():
            p.data = torch.empty(0, dtype=m.dtype, device=m.device)

    @contextlib.contextmanager
    def whole(self):
        """The nets with their sharded parameters gathered, freed after."""
        self.gather()
        try:
            yield
        finally:
            self.free()

    def reduce_grads(self, grads: dict[str, dict[str, torch.Tensor]]
                     ) -> dict[str, dict[str, torch.Tensor]]:
        """Each net's gradients (name -> whole tensor, this rank's batch)
        as the means over the ranks: this rank's slice of a sharded leaf
        (one flat reduce-scatter per dtype), the whole of a replicated one
        (one flat all-reduce per dtype)."""
        out = {key: dict(g) for key, g in grads.items()}
        leaves = [(key, name, axis) for key, name, _, _, axis
                  in self.sharded()]
        mine = ddp.reduce_scatter_mean(
            [_parts(grads[key][name], axis, self.world)
             for key, name, axis in leaves], self.group)
        for (key, name, _), g in zip(leaves, mine):
            out[key][name] = g
        rest = [out[key][name] for key in out for name in out[key]
                if self.specs[key][name] is None]
        ddp.all_reduce_mean_(rest, self.group)
        return out

    def gather_tree(self, key: str, tree: dict[str, torch.Tensor]
                    ) -> dict[str, torch.Tensor]:
        """A tree of net ``key`` (name -> this rank's slice of a sharded
        leaf, the whole of a replicated one) made whole on every rank."""
        names = [n for n in tree if self.specs[key][n] is not None]
        full = ddp.all_gather_flat([tree[n] for n in names], self.group)
        out = dict(tree)
        for n, parts in zip(names, full):
            out[n] = _whole(parts, self.specs[key][n])
        return out

    def nbytes(self) -> dict[str, int]:
        """This rank's bytes of parameters plus Adam moments: of the
        sharded leaves' slices ("sharded"), of the same leaves whole
        ("unsharded": what each rank held before), and of the replicated
        leaves ("replicated"); from the optimizers' states (moments count
        once they exist)."""
        out = {"sharded": 0, "unsharded": 0, "replicated": 0}
        for key, masters in self.masters.items():
            opt = self.opts[key]
            for name, m in masters.items():
                st = opt.state.get(m, {})
                k = 1 + sum(1 for v in ("exp_avg", "exp_avg_sq") if v in st)
                b = k * m.numel() * m.element_size()
                if self.specs[key][name] is None:
                    out["replicated"] += b
                else:
                    out["sharded"] += b
                    out["unsharded"] += b * self.world
        return out


def _sharded_adam(old: torch.optim.Adam, net: nn.Module, masters: dict,
                  specs: dict, rank: int, world: int) -> torch.optim.Adam:
    """An Adam over ``masters`` with ``old``'s settings and its moments
    (where it has taken steps) sliced as the masters are."""
    hp = old.param_groups[0]
    opt = torch.optim.Adam(list(masters.values()), lr=hp["lr"],
                           betas=hp["betas"], eps=hp["eps"])
    for name, p in net.named_parameters():
        st = old.state.get(p)
        if not st:
            continue
        axis = specs[name]
        opt.state[masters[name]] = {
            k: v if k == "step" or axis is None
            else _slice(v, axis, rank, world).clone()
            for k, v in st.items()}
    return opt


def shard_state_fsdp(state, group=None, min_size: int = 2 ** 16):
    """Shard ``state`` (a ``train/module2.py:TrainState``, the same on every
    rank of ``group``) in place: G's and the Ds' leaves by
    ``fsdp_param_shardings`` over the group, and their Adam moments with
    them; the pool and the step stay replicated. Returns ``state``, whose
    steps (``Module2TrainStep.grads`` / ``step``, the data-parallel step
    over ``group``) then gather, reduce-scatter and update the slices."""
    if state.fsdp is not None:
        raise ValueError("shard_state_fsdp: the state is sharded already")
    shards = FSDPShards({"g": state.g, "d": state.d}, group, min_size)
    for key, net, attr in (("g", state.g, "g_opt"), ("d", state.d, "d_opt")):
        opt = _sharded_adam(getattr(state, attr), net, shards.masters[key],
                            shards.specs[key], shards.rank, shards.world)
        setattr(state, attr, opt)
        shards.opts[key] = opt
    shards.free()
    state.fsdp = shards
    return state


def gather_state(state):
    """The whole state of a sharded ``state`` on every rank (every rank of
    its group must call this): G and the Ds with every leaf gathered, Adam
    states over them with their moments gathered, the pool and counts
    copied. An unsharded state is returned as it is."""
    shards = state.fsdp
    if shards is None:
        return state
    with shards.whole():
        nets = {"g": copy.deepcopy(state.g), "d": copy.deepcopy(state.d)}
    opts = {}
    for key, net in nets.items():
        old = shards.opts[key]
        masters = shards.masters[key]
        moments = {}
        for k in ("exp_avg", "exp_avg_sq"):
            tree = {n: old.state[m][k] for n, m in masters.items()
                    if k in old.state.get(m, {})}
            if tree:
                moments[k] = shards.gather_tree(key, tree)
        hp = old.param_groups[0]
        opt = torch.optim.Adam(net.parameters(), lr=hp["lr"],
                               betas=hp["betas"], eps=hp["eps"])
        for name, p in net.named_parameters():
            st = old.state.get(masters[name])
            if st:
                opt.state[p] = {"step": st["step"].clone(), **{
                    k: moments[k][name].clone() for k in moments}}
        opts[key] = opt
    return type(state)(
        step=state.step, g=nets["g"], d=nets["d"], g_opt=opts["g"],
        d_opt=opts["d"], pool=state.pool.clone(),
        pool_count=state.pool_count, compute_dtype=state.compute_dtype)
