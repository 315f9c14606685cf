"""The port's trainer on several ranks, on the CPU at the small
configuration of ``tests/test_torch_train_cli.py`` (crop 64, load 72,
ngf = ndf = 8) over gloo:

- ``train_cli.main --data_parallel 2 --device cpu`` for 2 steps at batch 3
  (rounded up to 4) against the single-process trainer at batch 4 on the
  same data stream: the loss log and the final checkpoint;
- ``--multihost`` as two processes of ``python -m
  animateportrait_tpu_torch.train_cli`` at ``tests/test_multihost_cli.py``'s
  tiny flags and ``--max_steps 1``: both exit 0, one loss log with
  ``iters: 1`` and one checkpoint tree, and the logged losses equal to a
  single-process step on the concatenation of the two processes' batches
  (each from ``default_rng(process_id)``), at the log's printed precision;
- ``data_parallel_world``: the JAX default of every visible card, and the
  error that names both numbers when more ranks are asked than there are;
- the data-parallel step with ``compute_dtype="bfloat16"`` and ``remat``
  against one process with both;
- ``utils/smoke.py:decomposed_grads`` (the ranks' step emulated in one
  process, each slice alone) against 4 gloo ranks at a batch of 1 each,
  for 2 steps.

The data-parallel step against the JAX package's is in
``tests/test_torch_data_parallel.py``.
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from animateportrait_tpu_torch import train_cli
from animateportrait_tpu_torch.data.umlvd_ifw import UMLVDIFWDataset, loader
from animateportrait_tpu_torch.io.checkpoint import CheckpointManager
from animateportrait_tpu_torch.io.reference import load_frozen
from animateportrait_tpu_torch.train import module2 as m2
from animateportrait_tpu_torch.utils import distributed as ddp
from animateportrait_tpu_torch.utils.options import (
    data_parallel_world, to_configs)
from animateportrait_tpu_torch.utils.smoke import (
    adam_update_parity, decomposed_grads, dp_step_rank, dp_step_run,
    write_umlvd_tree)
from torch_port_helpers import maxdiff

LOSS_TOL = dict(rtol=1e-4, atol=1e-5)    # tests/test_torch_train.py's
SPAWN_TIMEOUT = 180           # s, for the processes of one test
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


TINY = ["--model", "geomgm_ifw_fore",
        "--netG", "resnet_9blocks_rcatland32_full_ifw",
        "--netg_resb_div", "3", "--netg_resb_disp", "3",
        "--output_nc", "1", "--ngf", "8", "--ndf", "8",
        "--load_size", "72", "--crop_size", "64", "--lr", "0.00005",
        "--lambda_geom", "50", "--lambda_geom_lipline", "50",
        "--niter", "1", "--niter_decay", "0", "--print_freq", "1",
        "--device", "cpu"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_umlvd_tree(str(tmp_path_factory.mktemp("umlvd")),
                            n_photos=3, n_styles=3, clips=1, frames=3,
                            size=96, seed=0, png_filter=4)


def _log(ck: str, name: str) -> tuple[list, list]:
    """(the loss log's step lines, metrics.jsonl's records)."""
    d = os.path.join(ck, name)
    with open(os.path.join(d, "loss_log.txt")) as f:
        text = f.read()
    with open(os.path.join(d, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert text.count("Training Loss") == 1       # one writer
    return [ln for ln in text.splitlines() if ln.startswith("(epoch")], recs


def test_train_cli_data_parallel_matches_one_process(tree, tmp_path):
    """``--data_parallel 2`` at batch 3 trains on the global batch of 4
    that the single-process trainer loads at batch 4 from the same stream:
    rank 0 loads it and scatters the halves."""
    base = ["--dataroot", tree, *TINY, "--max_steps", "2",
            "--num_threads", "1", "--frozen_dir", str(tmp_path / "none")]
    assert train_cli.main([*base, "--data_parallel", "2", "--batch_size",
                           "3", "--checkpoints_dir", str(tmp_path / "dp"),
                           "--name", "dp"]) is None
    ref = train_cli.main([*base, "--batch_size", "4", "--checkpoints_dir",
                          str(tmp_path / "one"), "--name", "one"])
    lines, recs = _log(str(tmp_path / "dp"), "dp")
    _, want = _log(str(tmp_path / "one"), "one")
    assert len(lines) == len(recs) == len(want) == 2
    for got, exp in zip(recs, want):
        assert got["iters"] == exp["iters"]
        for k, v in exp.items():
            np.testing.assert_allclose(got[k], v, err_msg=k, **LOSS_TOL)
    ckpt = CheckpointManager(str(tmp_path / "dp" / "dp" / "checkpoints"))
    assert ckpt.all_steps() == [2]
    saved = ckpt.restore(2, None)
    # the trainer's own config (its lr) and initial state
    cfg, _ = to_configs(train_cli.build_argparser().parse_args(
        [*base, "--batch_size", "4"]))
    init = m2.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    for net in ("g", "d"):
        module = getattr(ref.state, net)
        opt = getattr(ref.state, f"{net}_opt")
        # the updates where Adam's first moment (of both steps' gradients)
        # decides them
        moment = {k: opt.state[p]["exp_avg"]
                  for k, p in module.named_parameters()}
        old = dict(getattr(init, net).named_parameters())
        bound, decided = adam_update_parity(
            {k: saved[net][k] for k in old}, dict(module.named_parameters()),
            old, moment, cfg.lr, 2)
        assert bound <= 1.0 and decided <= 1.0, (net, bound, decided)


def test_train_cli_multihost_two_processes(tree, tmp_path):
    ck = str(tmp_path / "ckpts")
    coord = f"127.0.0.1:{ddp.free_port()}"
    argv = ["--dataroot", tree, *TINY, "--checkpoints_dir", ck, "--name",
            "mh", "--max_steps", "1", "--num_threads", "1", "--frozen_dir",
            str(tmp_path / "nonexistent"), "--multihost", "1",
            "--coordinator_address", coord, "--num_processes", "2"]
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join(
                   [ROOT, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "animateportrait_tpu_torch.train_cli", *argv,
         "--process_id", str(i)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i}:\n{out[-4000:]}"
    assert "max_steps=1" in outs[0] and "max_steps=1" not in outs[1]
    assert "2 ranks over gloo" in outs[0]
    lines, recs = _log(ck, "mh")
    assert len(lines) == len(recs) == 1 and "iters: 1," in lines[0]
    assert CheckpointManager(os.path.join(ck, "mh", "checkpoints")
                             ).all_steps() == [1]
    assert sorted(os.listdir(ck)) == ["mh"]

    # one step of one process on both processes' batches, in order
    args = train_cli.build_argparser().parse_args(argv + ["--process_id",
                                                          "0"])
    cfg, data_cfg = to_configs(args)
    ds = UMLVDIFWDataset(data_cfg)
    batch = {}
    for i in range(2):
        part = next(iter(loader(ds, 1, np.random.default_rng(i), 0, False)))
        for k, v in part.items():
            batch[k] = torch.cat([batch[k], v]) if k in batch else v
    state = m2.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    frozen = load_frozen(args.frozen_dir, cfg,
                         torch.Generator().manual_seed(1), "cpu")
    want = m2.build_train_step(cfg).step(
        state, batch, frozen, torch.Generator().manual_seed(0))
    printed = dict(re.findall(r"(\w+): (-?[\d.]+) ", lines[0].split(")")[1]))
    assert set(printed) == set(want)
    for k, v in want.items():
        # %.3f: within half a unit of the last printed digit
        assert abs(float(printed[k]) - float(v)) <= 5e-4 + 1e-4 * abs(
            float(v)), (k, printed[k], float(v))
        np.testing.assert_allclose(recs[0][k], float(v), err_msg=k,
                                   **LOSS_TOL)


def test_data_parallel_world():
    assert data_parallel_world(0, "cpu") == 1
    assert data_parallel_world(3, "cpu") == 3
    assert data_parallel_world(0, "cuda", n_cards=4) == 4
    assert data_parallel_world(2, "cuda", n_cards=4) == 2
    with pytest.raises(SystemExit, match="--data_parallel 5: more ranks than "
                       "the 4 visible CUDA cards"):
        data_parallel_world(5, "cuda", n_cards=4)


def test_dp_step_composes_with_bf16_and_remat(tmp_path):
    """The data-parallel step needs no branch of its own for
    ``compute_dtype="bfloat16"`` and ``remat``: 2 gloo ranks with both
    against one process with both, on a global batch of 4, one step. The
    losses within rtol 2e-2 (bf16 convs at batch 2 against batch 4 round
    apart; the bar of the card's bf16 step against the host in
    ``tests/test_torch_cuda.py``), the pool's fill and the ranks equal."""
    cfg = m2.Module2Config(crop_size=64, output_nc=1, ngf=8, ndf=8,
                           steps_per_epoch=2, pool_size=8,
                           compute_dtype="bfloat16", remat=True)
    batch = {k: v.numpy() for k, v in m2.make_random_batch(
        cfg, 4, torch.Generator().manual_seed(2), "cpu").items()}
    ddp.spawn(dp_step_rank, ["cpu"] * 2, cfg, batch, 1, str(tmp_path),
              timeout=SPAWN_TIMEOUT)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    single = dp_step_run(cfg, batch, 1, torch.device("cpu"))
    for k, v in single["metrics"][0].items():
        assert np.isfinite(v), k
        np.testing.assert_allclose(ranks[0]["metrics"][0][k], v, rtol=2e-2,
                                   err_msg=k)
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    assert ranks[0]["pool_counts"] == single["pool_counts"] == [8]
    for net in ("g", "d"):
        for k, v in ranks[0]["params"][-1][net].items():
            assert v.dtype == torch.float32, k       # fp32 masters
            assert torch.equal(v, ranks[1]["params"][-1][net][k]), k


def test_decomposed_grads_match_the_ranks(tmp_path):
    """The data-parallel step of 4 gloo ranks at a batch of 1 each, 2
    steps, against ``decomposed_grads`` in one process on the same global
    batch (``dp_step_run(decompose=4)``): the losses within 1e-6
    (relative; the ranks and the one process run the same convs at batch
    1, and only the order of the gradient mean differs), where the
    one-process step at batch 4 sits ~1e-4 away at the second step (its
    convs round otherwise, and Adam's first update turns that into steps
    of lr); the pool after the first step bit-equal, after the second
    within 1e-4; and a step that would fill the pool refused."""
    cfg = m2.Module2Config(crop_size=64, output_nc=1, ngf=8, ndf=8,
                           steps_per_epoch=2, pool_size=16)
    batch = {k: v.numpy() for k, v in m2.make_random_batch(
        cfg, 4, torch.Generator().manual_seed(2), "cpu").items()}
    ddp.spawn(dp_step_rank, ["cpu"] * 4, cfg, batch, 2, str(tmp_path),
              timeout=SPAWN_TIMEOUT)
    ranks = torch.load(tmp_path / "rank0.pt")
    cpu = torch.device("cpu")
    # at the ranks' torch threads (``spawn`` gives each this process's
    # divided by the ranks): the CPU's convs round by their thread count
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads // 4))
    try:
        got = dp_step_run(cfg, batch, 2, cpu, decompose=4)
    finally:
        torch.set_num_threads(threads)
    for s in range(2):
        for k, v in ranks["metrics"][s].items():
            np.testing.assert_allclose(got["metrics"][s][k], v, rtol=1e-6,
                                       atol=1e-8, err_msg=k)
        # the first step's fakes bit-equal; the second's from a G whose
        # update differs in the mean's rounding (5.0e-6 on the CPU)
        assert maxdiff(got["pools"][s], ranks["pools"][s]) <= (0.0, 1e-4)[s]
    assert got["pool_counts"] == ranks["pool_counts"] == [8, 16]
    with pytest.raises(ValueError, match="would fill"):
        dp_step_run(cfg, batch, 3, cpu, decompose=4)
