"""The multi-device dry run: every sharding mode of the port on n ranks at
tiny shapes. Port of ``__graft_entry__.py:dryrun_multichip``.

``dryrun_multichip(n)`` spawns n ranks (``utils/distributed.py:spawn``):
one card each where the machine has n cards (NCCL), else n ranks sharing
card 0 (gloo), or n CPU ranks with ``device_type="cpu"``. Each rank runs
the JAX function's four modes at its sizes:

- one Module2 training step at crop 64, ngf = ndf = 8, pool 4,
  ``lambda_geom_lipline`` 50 on the example batch of n, data-parallel with
  the state FSDP-sharded at ``min_size`` 2**10 (``train/fsdp.py``), whose
  losses must be within 1e-4 (relative, 1e-5 absolute) of the same step
  in one process on the whole batch, JAX's bar;
- where n is even, the trident generator (ngf 8, 3 blocks) tensor-parallel
  on an (n/2, 2) grid of ranks on n frames at 64^2, against the one-rank
  generator;
- ``Audio2landmarkPos`` sequence-parallel over T = 8n frames, against the
  one-rank pos;
- GPipe over n ResNet blocks of 8 channels, one a stage, against the
  blocks in sequence at rtol = atol = 2e-5.

Unlike JAX's shape checks, TP and SP are held to the one-rank modules
(within ``TP_ATOL`` / ``SP_ATOL``, on seeded random weights and inputs;
SP with ``gain_attention``'s weights, and the first rank's frames as a
sequence of their own must miss the bar).
Rank 0 prints ``dryrun_multichip(n) OK — `` and the step's first four
losses, as the JAX function does. ``python -m animateportrait_tpu_torch.
multichip N [--device cpu]`` runs it.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from animateportrait_tpu_torch.utils import distributed as ddp
from animateportrait_tpu_torch.utils.device import (
    DEFAULT_DEVICE, resolve_device)

LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5   # __graft_entry__.py:117
TP_ATOL = 1e-4        # tests/test_torch_models.py's generator bar
SP_ATOL = 1e-4        # tests/test_torch_audio_landmark.py's pos bar
PP_TOL = dict(rtol=2e-5, atol=2e-5)  # __graft_entry__.py:197
FSDP_MIN_SIZE = 2 ** 10
SPAWN_TIMEOUT = 600.0  # s, for the ranks of one spawn
# the pos branch's attention output projections are scaled by this in the
# SP checks: at random weights the residual stream (the embedding x 8)
# drowns what attention adds, and a segment cut into per-rank sequences
# would pass SP_ATOL; scaled, it fails (``first_rank_alone``)
ATTN_GAIN = 30.0


def dryrun_devices(n: int, device_type: str = DEFAULT_DEVICE) -> list[str]:
    """One card per rank where this machine has n, else card 0 for every
    rank; or the CPU for each."""
    if device_type == "cpu":
        return ["cpu"] * n
    resolve_device(device_type)
    if torch.cuda.device_count() >= n:
        return [f"cuda:{i}" for i in range(n)]
    return ["cuda:0"] * n


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _counted(device, fn, *args):
    """(fn(*args), K2's and K2b's launches in it, ms on the host clock to a
    synchronize)."""
    from animateportrait_tpu_torch.ops.instnorm import (
        instance_norm, instance_norm_backward)

    instance_norm.launches = instance_norm_backward.launches = 0
    _sync(device)
    t0 = time.perf_counter()
    out = fn(*args)
    _sync(device)
    ms = 1e3 * (time.perf_counter() - t0)
    return out, {"instance_norm": instance_norm.launches,
                 "instance_norm_backward":
                 instance_norm_backward.launches}, ms


def step_mode(rank: int, n: int, device: torch.device) -> dict:
    """The DP + FSDP Module2 step against the one-process step."""
    from animateportrait_tpu_torch.train import module2 as m2
    from animateportrait_tpu_torch.train.fsdp import shard_state_fsdp
    from animateportrait_tpu_torch.utils.smoke import (
        _kept_instance_norm_inputs, k2_against_plain)

    cfg = m2.Module2Config(crop_size=64, output_nc=1, ngf=8, ndf=8,
                           pool_size=4, steps_per_epoch=2,
                           lambda_geom_lipline=50.0)
    batch = m2.make_example_batch(cfg, batch_size=n, device=device)
    step = m2.build_train_step(cfg)

    def fresh():
        return (m2.init_state(cfg, torch.Generator().manual_seed(0), device),
                m2.init_frozen_random(torch.Generator().manual_seed(1),
                                      device))

    def gen():
        return torch.Generator(device=device).manual_seed(1)

    state, frozen = fresh()
    base = {k: float(v) for k, v in step.step(state, batch, frozen,
                                              gen()).items()}
    state, frozen = fresh()
    shard_state_fsdp(state, None, FSDP_MIN_SIZE)
    kept, hooks = _kept_instance_norm_inputs([state.g, state.d])
    local = {k: v[rank:rank + 1] for k, v in batch.items()}
    metrics, launches, ms = _counted(device, step.step, state, local, frozen,
                                     gen())
    for h in hooks:
        h.remove()
    metrics = {k: float(v) for k, v in metrics.items()}
    for k, v in metrics.items():
        ref = base[k]
        if not (np.isfinite(v) and abs(v - ref) <= LOSS_RTOL * max(
                abs(ref), 1.0) + LOSS_ATOL):
            raise AssertionError(f"sharded metric {k}={v} != one process "
                                 f"{ref}")
    return {"metrics": metrics, "launches": launches, "ms": ms,
            "bytes": state.fsdp.nbytes(), "k2_err": k2_against_plain(kept)}


def tp_mode(rank: int, n: int, device: torch.device) -> dict:
    """The tensor-parallel generator on an (n/2, 2) grid."""
    from animateportrait_tpu_torch.models.gan import TridentGeneratorFullIFW
    from animateportrait_tpu_torch.utils.smoke import init_random_

    kw = dict(output_nc=1, ngf=8, n_blocks=3, div=3, disp=3)
    g = init_random_(TridentGeneratorFullIFW(**kw),
                     torch.Generator().manual_seed(2))
    inputs = generator_inputs(np.random.default_rng(3), n, 64)
    rec = tp_run(rank, n, device, (n // 2, 2), kw, g.state_dict(), inputs)
    with torch.no_grad():
        want = g.to(device).eval()(*(torch.as_tensor(a, device=device)
                                     for a in inputs)).cpu()
    rec["err"] = float((rec.pop("y") - want).abs().max())
    if not rec["err"] <= TP_ATOL:
        raise AssertionError(f"TP generator: {rec['err']}")
    return rec


def sp_mode(rank: int, n: int, device: torch.device) -> dict:
    """The sequence-parallel pos over T = 8n frames."""
    from animateportrait_tpu_torch.models.audio2landmark import (
        Audio2landmarkPos)
    from animateportrait_tpu_torch.utils.smoke import init_random_

    sd = gain_attention(init_random_(
        Audio2landmarkPos(), torch.Generator().manual_seed(4)).state_dict())
    inputs = pos_inputs(np.random.default_rng(5), 8 * n)
    rec = sp_run(rank, n, device, sd, inputs)
    pos = Audio2landmarkPos()
    pos.load_state_dict(sd)
    pos = pos.to(device).eval()
    args = [torch.as_tensor(a, device=device) for a in inputs]
    with torch.no_grad():
        want = pos(*args)[0].cpu()
        alone = first_rank_alone(pos, args, n).cpu()
    rec["err"] = float((rec.pop("y") - want).abs().max())
    rec["alone"] = float((alone - want[:alone.shape[0]]).abs().max())
    if not rec["err"] <= SP_ATOL < rec["alone"]:
        raise AssertionError(f"SP pos: {rec['err']}, the first rank's frames "
                             f"alone {rec['alone']}")
    return rec


def pp_mode(rank: int, n: int, device: torch.device) -> dict:
    """GPipe over n ResNet blocks of 8 channels, one a stage."""
    from animateportrait_tpu_torch.models.gan import ResnetBlock
    from animateportrait_tpu_torch.parallel import (
        gpipe_apply, resnet_stage, seq_apply)
    from animateportrait_tpu_torch.utils.smoke import resnet_blocks

    dim = 8
    mods = []
    for sd in resnet_blocks(dim, n, seed=6):
        block = ResnetBlock(dim)
        block.load_state_dict(sd)
        mods.append(block.to(device).eval())
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (2 * n, dim, 8, 8)).astype(np.float32), device=device)
    out, launches, ms = _counted(device, gpipe_apply,
                                 resnet_stage([mods[rank]]), x)
    want = seq_apply(mods, x)
    err = float((out - want).abs().max())
    if not torch.allclose(out, want, **PP_TOL):
        raise AssertionError(f"GPipe: {err}")
    return {"err": err, "launches": launches, "ms": ms}


def _warm_and_timed(device, fn, *args) -> tuple:
    """A warm call of ``fn``, then a counted one: (its output, K2's
    launches in it, its ms)."""
    fn(*args)
    return _counted(device, fn, *args)


def generator_inputs(rng: np.random.Generator, frames: int, size: int
                     ) -> list[np.ndarray]:
    """Seeded arguments of ``TridentGeneratorFullIFW`` (x_in, land1, land2,
    motion, flow, ifmask), numpy NCHW (motion NHWC)."""
    f32 = np.float32
    out = [rng.uniform(-1, 1, (frames, c, size, size)).astype(f32)
           for c in (3, 1, 1)]
    return out + [rng.uniform(-1, 1, (frames, size, size, 2)).astype(f32),
                  rng.standard_normal((frames, 2, size, size)).astype(f32),
                  np.ones((frames, 1, size, size), f32)]


def pos_inputs(rng: np.random.Generator, T: int) -> list[np.ndarray]:
    """Seeded arguments of ``Audio2landmarkPos`` on one segment of T
    frames (au, emb, face_id, z), numpy."""
    f32 = np.float32
    return [rng.standard_normal((T, 18, 80)).astype(f32),
            rng.uniform(-1, 1, (T, 256)).astype(f32),
            np.zeros((1, 204), f32),
            rng.standard_normal((T, 128)).astype(f32)]


def gain_attention(state_dict: dict) -> dict:
    """``state_dict`` of an ``Audio2landmarkPos`` with every attention
    output projection's weight times ``ATTN_GAIN``."""
    return {k: v * ATTN_GAIN if k.endswith("attn.out.weight") else v
            for k, v in state_dict.items()}


@torch.no_grad()
def first_rank_alone(pos, args: list, n: int) -> torch.Tensor:
    """The fault that sequence parallelism must not make: the first of n
    ranks' frames of the segment ``args`` (au, emb, face_id, z) as an
    attention sequence of their own; (T / n, 204)."""
    t = args[0].shape[0] // n
    return pos(*(a if i == 2 else a[:t] for i, a in enumerate(args)))[0]


def tp_run(rank: int, world: int, device: torch.device, grid: tuple,
           g_kwargs: dict, state_dict: dict, inputs: list) -> dict:
    """``tensor_parallel_generator`` on a ``grid`` (data, model) of the
    world's ranks: ``TridentGeneratorFullIFW(**g_kwargs)`` with
    ``state_dict`` on ``inputs`` (``generator_inputs``, the whole batch).
    Returns the output, K2's launches and ms of a call after a warm one,
    the number of sliced convs, the largest |K2 - its plain version| on
    the InstanceNorm inputs of the slices, and the backend."""
    import torch.distributed as dist

    from animateportrait_tpu_torch.models.gan import TridentGeneratorFullIFW
    from animateportrait_tpu_torch.parallel import (
        GatherChannels, tensor_parallel_generator)
    from animateportrait_tpu_torch.utils.smoke import (
        _kept_instance_norm_inputs, k2_against_plain)

    g = TridentGeneratorFullIFW(**g_kwargs)
    g.load_state_dict(state_dict)
    tp = tensor_parallel_generator(g.to(device).eval(),
                                   *ddp.grid_groups(grid))
    args = [torch.as_tensor(a, device=device) for a in inputs]
    kept, hooks = _kept_instance_norm_inputs([tp.g])
    y, launches, ms = _warm_and_timed(device, tp, *args)
    for h in hooks:
        h.remove()
    return {"y": y.cpu(), "launches": launches, "ms": ms,
            "sliced": sum(isinstance(m, GatherChannels)
                          for m in tp.g.modules()),
            "k2_err": k2_against_plain(kept), "backend": dist.get_backend()}


def sp_run(rank: int, world: int, device: torch.device, state_dict: dict,
           inputs: list) -> dict:
    """``sequence_parallel_pos`` of ``Audio2landmarkPos`` with
    ``state_dict`` on ``inputs`` (``pos_inputs``, the whole segment).
    Returns the landmarks, the ms of a call after a warm one, and the
    backend."""
    import torch.distributed as dist

    from animateportrait_tpu_torch.models.audio2landmark import (
        Audio2landmarkPos)
    from animateportrait_tpu_torch.parallel import sequence_parallel_pos

    pos = Audio2landmarkPos()
    pos.load_state_dict(state_dict)
    pos = pos.to(device).eval()
    args = [torch.as_tensor(a, device=device) for a in inputs]
    y, _, ms = _warm_and_timed(device, sequence_parallel_pos, pos, *args)
    return {"y": y.cpu(), "ms": ms, "backend": dist.get_backend()}


def dryrun_rank(rank: int, n: int, device: torch.device, out_dir: str
                ) -> None:
    """One rank of ``dryrun_multichip``: its record goes to
    ``<out_dir>/rank<rank>.pt``."""
    import torch.distributed as dist

    rec = {"backend": dist.get_backend(), "device": str(device),
           "step": step_mode(rank, n, device)}
    if n % 2 == 0:
        rec["tp"] = tp_mode(rank, n, device)
    rec["sp"] = sp_mode(rank, n, device)
    rec["pp"] = pp_mode(rank, n, device)
    torch.save(rec, os.path.join(out_dir, f"rank{rank}.pt"))
    if rank == 0:
        print(f"dryrun_multichip({n}) OK — " + ", ".join(
            f"{k}={v:.3f}" for k, v in sorted(rec["step"]["metrics"].items()
                                               )[:4]), flush=True)


def dryrun_multichip(n: int, device_type: str = DEFAULT_DEVICE
                     ) -> list[dict]:
    """Run the dry run on n ranks (``dryrun_devices``) and return each
    rank's record: the backend and device; the step's losses, K2's and
    K2b's launches, ms, the bytes of ``FSDPShards.nbytes`` and K2 against
    its plain version on the step's InstanceNorm inputs; the TP, SP and
    GPipe errors against one rank (SP's also with the first rank's frames
    alone), their ms and K2's launches. A failing mode on any rank
    raises."""
    with tempfile.TemporaryDirectory() as d:
        ddp.spawn(dryrun_rank, dryrun_devices(n, device_type), d,
                  timeout=SPAWN_TIMEOUT)
        return [torch.load(os.path.join(d, f"rank{r}.pt"))
                for r in range(n)]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n", type=int, help="ranks")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="cuda (default) or cpu")
    a = p.parse_args(argv)
    dryrun_multichip(a.n, a.device)


if __name__ == "__main__":
    main()
