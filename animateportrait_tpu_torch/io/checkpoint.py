"""Training checkpoints of the port. Port of
``animateportrait_tpu/io/checkpoint.py`` (reference: the per-net
``<epoch>_net_<name>.pth`` files of Module2/models/base_model.py:144-202).

A save is one ``torch.save`` of the whole train state (``train_state_dict``:
the generator's and discriminators' state dicts, both Adam ``state_dict``s,
the coherence pool and its count, the step, and the compute dtype: a bf16
run's masters and Adam state are fp32 all the same), written under a temporary
name and renamed into place, so a crash leaves the previous checkpoint
whole. The format is the port's own; the JAX package's Orbax trees do not
load here.

``CheckpointManager`` keeps Orbax's ``CheckpointManager`` semantics as the
JAX package uses them: an epoch namespace with ``max_to_keep`` and a
``save_interval_steps`` cadence (an unforced save off the cadence, or of a
step not after the newest, writes nothing, but the first save of an empty
namespace always writes), a rolling ``latest/`` slot of one, and
``iters/``, never pruned. ``save_flax_npz`` and ``load_flax_npz`` read and
write the JAX package's single-file variable dicts with numpy alone.
"""
from __future__ import annotations

import os
import re
from typing import Any

import numpy as np
import torch


def save_flax_npz(path: str, variables: dict) -> None:
    """A nested variable dict -> .npz of '/'-joined key paths (empty
    subtrees dropped, as flax's ``flatten_dict``)."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, dict):
                walk(v, key)
            else:
                flat[key] = np.asarray(v)

    walk(variables, "")
    np.savez(path, **flat)


def load_flax_npz(path: str) -> dict:
    """The nested variable dict of a ``save_flax_npz`` file."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for seg in parents:
                node = node.setdefault(seg, {})
            node[leaf] = z[key]
    return tree


def train_state_dict(state) -> dict:
    """A ``TrainState`` (``train/module2.py``) as one picklable dict. A
    state sharded by ``train/fsdp.py`` is gathered whole first
    (``gather_state``, a collective: every rank of its group calls this),
    so its checkpoint is the one an unsharded run writes."""
    if state.fsdp is not None:
        from animateportrait_tpu_torch.train.fsdp import gather_state

        state = gather_state(state)
    return {"step": int(state.step), "g": state.g.state_dict(),
            "d": state.d.state_dict(),
            "g_opt": _eager_optimizer_state(state.g_opt),
            "d_opt": _eager_optimizer_state(state.d_opt), "pool": state.pool,
            "pool_count": int(state.pool_count),
            "compute_dtype": state.compute_dtype}


def _eager_optimizer_state(opt) -> dict:
    """``opt.state_dict()`` as an eager step leaves it: no group
    ``capturable`` and each ``step`` a host tensor. The single-card step's
    CUDA graph (``train/module2.py:_StepGraph``) makes both live on the
    card, where a graph of the restored state makes them again, but the
    host's Adam refuses them: so a checkpoint resumes on any device."""
    sd = opt.state_dict()
    sd["param_groups"] = [{**g, "capturable": False} if "capturable" in g
                          else g for g in sd["param_groups"]]
    sd["state"] = {k: {**v, "step": v["step"].cpu()} if "step" in v else v
                   for k, v in sd["state"].items()}
    return sd


def load_train_state(state, obj: dict):
    """Load ``train_state_dict``'s dict into ``state``, in place, on the
    state's devices; returns ``state``. A checkpoint of another compute
    dtype than the state's raises: its run would not go on as it was; so
    does a sharded state (load the whole state, then shard it)."""
    if state.fsdp is not None:
        raise ValueError("load a checkpoint into an unsharded state, then "
                         "shard it (train/fsdp.py:shard_state_fsdp)")
    saved = obj.get("compute_dtype", "float32")
    if saved != state.compute_dtype:
        raise ValueError(f"checkpoint of a {saved} run, restored into a "
                         f"{state.compute_dtype} state")
    state.g.load_state_dict(obj["g"])
    state.d.load_state_dict(obj["d"])
    state.g_opt.load_state_dict(obj["g_opt"])
    state.d_opt.load_state_dict(obj["d_opt"])
    state.pool = obj["pool"].to(state.pool.device)
    state.pool_count = int(obj["pool_count"])
    state.step = int(obj["step"])
    return state


class _Slot:
    """One directory of ``<step>.pt`` checkpoints, pruned to the newest
    ``max_to_keep`` (None: all)."""

    _NAME = re.compile(r"^(\d+)\.pt$")

    def __init__(self, directory: str, max_to_keep: int | None):
        self.dir, self.max_to_keep = directory, max_to_keep

    def all_steps(self) -> list[int]:
        if not os.path.isdir(self.dir):
            return []
        return sorted(int(m.group(1)) for m in map(self._NAME.match,
                                                   os.listdir(self.dir)) if m)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.dir, f"{step}.pt")

    def write(self, step: int, obj: Any) -> None:
        if step in self.all_steps():
            raise ValueError(f"checkpoint for step {step} already exists "
                             f"in {self.dir}")
        os.makedirs(self.dir, exist_ok=True)
        tmp = os.path.join(self.dir, f".{step}.pt.tmp")
        torch.save(obj, tmp)
        os.replace(tmp, self.path(step))
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self.path(old))

    def read(self, step: int) -> Any:
        return torch.load(self.path(step), map_location="cpu",
                          weights_only=False)


def _payload(state: Any) -> Any:
    return train_state_dict(state) if hasattr(state, "g_opt") else state


class CheckpointManager:
    """Epoch saves (the reference's ``<epoch>_net_*``), the rolling latest
    slot (``latest_net_*``) and by-iteration saves, as the JAX package's
    manager keeps them (base_model.py:144-163)."""

    def __init__(self, directory: str, max_to_keep: int = 5,
                 save_interval_steps: int = 1):
        self.dir = os.path.abspath(directory)
        self.interval = save_interval_steps
        self._main = _Slot(self.dir, max_to_keep)
        self._latest = _Slot(os.path.join(self.dir, "latest"), 1)
        self._iters = _Slot(os.path.join(self.dir, "iters"), None)

    def all_steps(self) -> list[int]:
        return self._main.all_steps()

    def should_save(self, step: int) -> bool:
        """Orbax's decision for an unforced save: always into an empty
        namespace, never at or before its newest step, else on the
        cadence."""
        last = self._main.latest_step()
        if last is None:
            return True
        return step > last and step % self.interval == 0

    def save(self, step: int, state: Any, force: bool = False,
             keep: bool = False, latest: bool = False) -> bool:
        """Save ``state`` (a ``TrainState``, or anything ``torch.save``
        takes) at ``step``. force: save off the cadence; latest: into the
        rolling latest/ slot instead of the epoch namespace (the
        save_latest_freq path, train.py:48-55); keep: also under iters/,
        never pruned, when the step is after its newest (--save_by_iter).
        A forced or latest save of a step the namespace holds raises.
        Returns whether the epoch or latest save wrote."""
        obj = None
        last_kept = self._iters.latest_step()
        if keep and (last_kept is None or step > last_kept):
            obj = _payload(state)
            self._iters.write(step, obj)
        if latest:
            self._latest.write(step, obj if obj is not None
                               else _payload(state))
            return True
        if not force and not self.should_save(step):
            return False
        self._main.write(step, obj if obj is not None else _payload(state))
        return True

    def restore(self, step: int | None, target: Any) -> Any:
        """The checkpoint of ``step`` (default: the newest), loaded into
        ``target`` when that is a ``TrainState``, else returned. The
        latest/ slot answers exactly when it alone holds the step."""
        step = self.latest_step() if step is None else step
        slot = self._main
        if (step is not None and self._latest.latest_step() == step
                and step not in self._main.all_steps()):
            slot = self._latest
        obj = slot.read(step)
        if hasattr(target, "g_opt"):
            return load_train_state(target, obj)
        return obj

    def latest_step(self) -> int | None:
        steps = [s for s in (self._main.latest_step(),
                             self._latest.latest_step()) if s is not None]
        return max(steps) if steps else None
