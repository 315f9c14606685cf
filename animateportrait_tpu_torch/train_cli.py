"""The Module2 trainer of the port, with the reference's train.py flag
surface (``utils/options.py``):

    python -m animateportrait_tpu_torch.train_cli --dataroot <root> \\
        --name training/drawing1 --model geomgm_ifw_fore \\
        --netG resnet_9blocks_rcatland32_full_ifw --netg_resb_div 3 \\
        --netg_resb_disp 3 --output_nc 1 --lr 0.00005 --lambda_geom 50 \\
        ... --frozen_dir checkpoints

Port of ``animateportrait_tpu/train_cli.py`` (reference: Module2/train.py:
7-65): the UMLVD-IFW data (``data/umlvd_ifw.py``) from ``--num_threads``
worker processes, the training step (``train/module2.py``), the loss log
and the visual gallery (``utils/observe.py``), checkpoints
(``io/checkpoint.py``) under ``<checkpoints_dir>/<name>/checkpoints``, and
the frozen nets from the reference's files in ``--frozen_dir``
(``io/reference.py``; random weights with a warning where one is missing).

The epoch loop, ``--print_freq``, ``--display_freq``, ``--update_html_freq``,
``--no_html``, ``--save_latest_freq`` with ``--save_by_iter``, the
end-of-epoch saves, ``--max_steps`` with its forced final save,
``--continue_train`` with ``--load_iter``, and the ``--epoch_count`` step
offset are the JAX CLI's. Each step's pool draws come from a generator
seeded by the step number, so a resumed run draws what an uninterrupted one
would. ``--compute_dtype bfloat16`` runs the step in bf16 with fp32
masters (``train/module2.py``), and its checkpoints record it.

Data parallelism, one card per rank (``utils/distributed.py``; NCCL on the
cards, gloo on ``--device cpu``), the JAX CLI's global step:

- ``--data_parallel N`` (0, the default, takes every visible card; one
  rank on the CPU) spawns N ranks on this machine. The global batch is
  ``--batch_size`` rounded up to a multiple of N, and rank 0 alone loads
  it, from the stream of the single-process trainer (``default_rng(0)``),
  and scatters each rank its slice: every step trains on the global
  batch the JAX CLI's single-process ``--data_parallel`` trains on.
- ``--multihost 1`` joins a group of ``--num_processes`` processes, one
  card each, at ``--coordinator_address`` (``host:port``) as rank
  ``--process_id``; each loads its slice of the rounded global batch from
  ``default_rng(process_id)``, as each JAX process does.

The ranks start from rank 0's state (after ``--continue_train``'s restore,
which every rank reads from the one checkpoint tree), gather the fakes for
the pool's global query, and average gradients and losses
(``Module2TrainStep.grads``). Rank 0 alone logs, writes visuals and
saves, and the ranks then meet at a barrier. ``--display_freq`` is
disabled under ``--multihost``, as in the JAX CLI. ``--device`` (default
``cuda``) without a card raises.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist


def build_argparser():
    from animateportrait_tpu_torch.utils.options import build_train_argparser

    p = build_train_argparser()
    p.add_argument("--frozen_dir", default="checkpoints",
                   help="dir with the reference's frozen-net checkpoints")
    p.add_argument("--max_steps", type=int, default=0,
                   help="stop after N steps (0 = run all epochs)")
    # the JAX CLI's multi-host flags: one process per card, joined into
    # one group; each process loads its own slice of every global batch
    p.add_argument("--multihost", type=int, default=0,
                   help="join --num_processes processes (one card each) at "
                        "--coordinator_address as rank --process_id")
    p.add_argument("--coordinator_address", default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    return p


@dataclasses.dataclass
class StepRecord:
    step: int
    data_s: float      # waiting for the batch, and its copy to the device
    comp_s: float      # the step, and logging, visuals and saves after it
    t_end: float       # perf_counter when its logging ended


@dataclasses.dataclass
class TrainResult:
    state: object                    # the final TrainState
    resumed_from: int | None         # the restored step, if any
    records: list[StepRecord]        # one per step run, at print_freq
    data_share: float                # StepTimer's data-wait share


def _count(module: torch.nn.Module) -> float:
    return sum(p.numel() for p in module.parameters()) / 1e6


def _visuals(step_fn, state, batch, frozen) -> dict:
    """The step's visuals as NHWC numpy, with the four landmark overlays."""
    from animateportrait_tpu_torch.utils.observe import draw_lm_overlay

    vis, aux = step_fn.visuals(state, batch, frozen)
    vis = {k: v.permute(0, 2, 3, 1).cpu().numpy() for k, v in vis.items()}
    aux = {k: v.cpu().numpy() for k, v in aux.items()}
    for name, fake, lm, win in (
            ("fake_B_lm_68_vis", "fake_B", "fb_lm", "winB"),
            ("fake_B_lm_68_vist", "fake_B", "tb_lm", "winB"),
            ("fake_B2_lm_68_vis", "fake_B2", "fb2_lm", "winB2"),
            ("fake_B2_lm_68_vist", "fake_B2", "tb2_lm", "winB2")):
        vis[name] = draw_lm_overlay(vis[fake], aux[lm], aux[win])
    return vis


def main(argv=None) -> TrainResult | None:
    """Train as the flags say. Returns the run's ``TrainResult``, on one
    process or this ``--multihost`` rank's; None after ``--data_parallel``
    ranks, which ran in processes of their own."""
    from animateportrait_tpu_torch.utils import distributed as ddp
    from animateportrait_tpu_torch.utils.device import resolve_device
    from animateportrait_tpu_torch.utils.options import (
        data_parallel_world, to_configs)

    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_argparser().parse_args(argv)
    cfg, data_cfg = to_configs(args)
    device = resolve_device(args.device)
    if args.multihost:
        missing = [f"--{k}" for k in ("coordinator_address",
                                      "num_processes", "process_id")
                   if getattr(args, k) is None]
        if missing:
            raise SystemExit(f"--multihost needs {', '.join(missing)}")
        device = ddp.rank_device(device.type, args.process_id)
        ddp.init_group(args.coordinator_address, args.num_processes,
                       args.process_id, device)
        try:
            return _run(args, cfg, data_cfg, device, dist.group.WORLD)
        finally:
            dist.destroy_process_group()
    n = data_parallel_world(args.data_parallel, args.device)
    if n == 1:
        return _run(args, cfg, data_cfg, device, None)
    if device.type == "cuda":
        # built once here, not by the ranks at their first step
        from animateportrait_tpu_torch import kernels
        kernels.build()
    ddp.spawn(_data_parallel_rank, [ddp.rank_device(device.type, r)
                                    for r in range(n)], argv)
    return None


def _data_parallel_rank(rank: int, world: int, device: torch.device,
                        argv: list) -> None:
    """One rank of ``--data_parallel``, in a process of its own."""
    from animateportrait_tpu_torch.utils.options import to_configs

    args = build_argparser().parse_args(argv)
    cfg, data_cfg = to_configs(args)
    _run(args, cfg, data_cfg, device, dist.group.WORLD)


def _run(args, cfg, data_cfg, device: torch.device, group) -> TrainResult:
    """This process's share of the run: the dataset and its loader, then
    ``_train``. ``group`` None is the single-process trainer."""
    from animateportrait_tpu_torch.data.umlvd_ifw import (
        UMLVDIFWDataset, loader)
    from animateportrait_tpu_torch.utils.options import archive_options

    rank, n = (0, 1) if group is None else (dist.get_rank(group),
                                            dist.get_world_size(group))
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        # fp32 as the JAX package computes it (matmul precision highest)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if rank == 0:
        print(archive_options(args))
        if group is not None:
            print(f"[train] {n} ranks over {dist.get_backend(group)}")

    ds = UMLVDIFWDataset(data_cfg)
    if len(ds.A_paths) == 0:
        raise SystemExit(f"no photos under {data_cfg.root}/Photo")
    # the global batch rounded up to the ranks, so each gets an equal slice
    per_step = -(-max(args.batch_size, n) // n) * n
    batches = None
    if args.multihost:
        batches = loader(ds, per_step // n, np.random.default_rng(rank),
                         num_workers=args.num_threads,
                         pin_memory=device.type == "cuda")
    elif rank == 0:
        batches = loader(ds, per_step, np.random.default_rng(0),
                         num_workers=args.num_threads,
                         pin_memory=device.type == "cuda")
    # the worker processes start here, while the nets are built
    batches = None if batches is None else iter(batches)
    try:
        return _train(args, cfg, device, batches, group)
    finally:
        # stop the worker processes now, not when the iterator is collected
        shutdown = getattr(batches, "_shutdown_workers", None)
        if shutdown is not None:
            shutdown()


def _train(args, cfg, device: torch.device, batches, group) -> TrainResult:
    """The nets, the checkpoint manager and the epoch loop of ``main``;
    with a ``group``, this rank's (``batches`` None on a rank that loads
    nothing and takes its slice from rank 0)."""
    from animateportrait_tpu_torch.io.checkpoint import CheckpointManager
    from animateportrait_tpu_torch.io.reference import load_frozen
    from animateportrait_tpu_torch.train import module2 as m2
    from animateportrait_tpu_torch.utils import distributed as ddp
    from animateportrait_tpu_torch.utils.observe import LossLogger, StepTimer

    rank = 0 if group is None else dist.get_rank(group)
    lead = rank == 0
    # a scattered batch: rank 0 loads the global batch, the others wait
    scattered = group is not None and not args.multihost

    def say(*a, **kw):
        if lead:
            print(*a, **kw)

    def sync():
        if group is not None:
            ddp.barrier(group)

    state = m2.init_state(cfg, torch.Generator().manual_seed(0), device)
    if args.verbose:
        # base_options --verbose: each network's parameter count
        say(f"[verbose] G params: {_count(state.g):.3f} M")
        for name, d in sorted(state.d.items()):
            say(f"[verbose] D[{name}] params: {_count(d):.3f} M")
    frozen = load_frozen(args.frozen_dir, cfg,
                         torch.Generator().manual_seed(1), device)
    step_fn = m2.build_train_step(cfg)

    logger = LossLogger(args.checkpoints_dir, args.name) if lead else None
    ckpt = CheckpointManager(
        os.path.join(args.checkpoints_dir, args.name, "checkpoints"),
        save_interval_steps=args.save_epoch_freq * cfg.steps_per_epoch)
    resumed = None
    if args.continue_train and ckpt.latest_step() is not None:
        # --load_iter resumes from that exact saved step; default latest
        state = ckpt.restore(args.load_iter or None, state)
        resumed = state.step
        say(f"[train] resumed from step {state.step}")
        if args.epoch_count > 1:
            say("[train] --epoch_count ignored with --continue_train "
                "(the restored step already encodes the epoch)",
                file=sys.stderr)
    elif args.epoch_count > 1:
        # reference train.py:19 starts the epoch loop at epoch_count and
        # its linear-lr lambda adds epoch_count (networks.py:57); here the
        # epoch derives from the step, so the shift is a step offset
        state.step += (args.epoch_count - 1) * cfg.steps_per_epoch
    if group is not None:
        m2.broadcast_state(state, group)
    display = args.display_freq
    if display and args.multihost:
        say("[train] --display_freq disabled under --multihost "
            "(batch shards are not host-addressable)", file=sys.stderr)
        display = 0

    def next_batch():
        """(this rank's batch on the device, the global batch on rank 0
        where it loaded it, else this rank's)."""
        full = next(batches) if batches is not None else None
        if scattered:
            return ddp.scatter_batch(full, device, group), full
        local = {k: v.to(device, non_blocking=True) for k, v in full.items()}
        return local, local

    def save(*a, **kw):
        if lead:
            ckpt.save(*a, **kw)
        sync()

    total_epochs = cfg.niter + cfg.niter_decay
    step = state.step
    timer = StepTimer()
    records = []
    for epoch in range(step // cfg.steps_per_epoch + 1, total_epochs + 1):
        for _ in range(cfg.steps_per_epoch):
            batch, full = next_batch()
            timer.data_done()
            gen = torch.Generator(device=device).manual_seed(step)
            metrics = step_fn.step(state, batch, frozen, gen, group)
            step += 1
            if step % args.print_freq == 0:
                # the losses reach the host: the step has finished
                losses = {k: float(v) for k, v in metrics.items()}
                t_comp, t_data = timer.step_done()
                if lead:
                    logger.log(epoch, step, losses, t_comp, t_data)
                records.append(StepRecord(step, t_data, t_comp,
                                          time.perf_counter()))
            else:
                timer.step_done()
            if display and step % display == 0:
                if lead:
                    # the global batch, as the JAX CLI's visuals_fn sees it
                    full = {k: v.to(device) for k, v in full.items()}
                    logger.save_visuals(
                        _visuals(step_fn, state, full, frozen), epoch,
                        iters=step, update_html=(
                            not args.no_html
                            and step % max(1, args.update_html_freq) == 0))
                sync()
            if args.save_latest_freq and step % args.save_latest_freq == 0:
                # the reference's latest_net_* (train.py:48-55): one
                # rolling slot, and with --save_by_iter every such save
                # kept under iters/
                save(step, state, latest=True, keep=args.save_by_iter)
            if args.max_steps and step >= args.max_steps:
                # forced: an off-cadence unforced save writes nothing
                save(step, state, force=True)
                say(f"[train] stopped at max_steps={args.max_steps}")
                return TrainResult(state, resumed, records,
                                   timer.data_share())
        save(step, state)
        say(f"[train] epoch {epoch} done (step {step})")
    return TrainResult(state, resumed, records, timer.data_share())


if __name__ == "__main__":
    main()
