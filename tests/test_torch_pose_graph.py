"""What the pose-transfer trainer's CUDA graph rests on, checked on the host
(``animateportrait_tpu_torch/train/pose_transfer.py``), at the convergence
tool's small widths (``utils/smoke.py:trainer_smoke("pose", small=True)``):
the ImageNet constants made once give ``_pt_normalize``'s values bit for
bit; the static-statistics epilogue (``_StaticStats.settle``) leaves each
BatchNorm bound to the tensors it held, at the eager step's values bit for
bit; and the set of graphs keys its graphs by batch layout, up to
``MAX_GRAPHS``, and drops them for other optimizers or settings. The
graphed step itself runs on the card (``tests/test_torch_cuda.py``)."""
import pytest
import torch

from animateportrait_tpu_torch.train import convergence as cv
from animateportrait_tpu_torch.train import pose_transfer as pt
from animateportrait_tpu_torch.utils.smoke import trainer_smoke


def pose_batch(n: int = 2, size: int = 32, joints: int = 6) -> dict:
    """The smoke trainer's batch (``convergence.pose_batch``, NCHW)."""
    return {k: (torch.from_numpy(v).permute(0, 3, 1, 2).contiguous()
                if v.ndim == 4 else torch.from_numpy(v))
            for k, v in cv.pose_batch(n, size, joints).items()}


def batch_norms(trainer) -> list:
    return [m for net in (trainer.g, trainer.d) for m in net.modules()
            if isinstance(m, pt.BatchNorm2d)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_normalize_constants_made_once_give_the_old_values(dtype):
    x = torch.rand((2, 3, 8, 8), generator=torch.Generator().manual_seed(0),
                   dtype=dtype) * 2 - 1
    mean = torch.tensor([0.485, 0.456, 0.406], dtype=dtype).reshape(
        1, 3, 1, 1)
    std = torch.tensor([0.229, 0.224, 0.225], dtype=dtype).reshape(
        1, 3, 1, 1)
    assert torch.equal(pt._pt_normalize(x), (x * 0.5 + 0.5 - mean) / std)
    first = pt._imagenet_stats(x.device, dtype)
    assert all(a is b for a, b in zip(first,
                                      pt._imagenet_stats(x.device, dtype)))


def test_settled_statistics_stay_in_their_tensors_at_the_eager_values():
    """Three eager steps, each followed by the epilogue, against three
    plain eager steps of a twin: every BatchNorm keeps the tensors it
    held before the first step, and they, the parameters and the losses
    equal the twin's bit for bit (each step reads the statistics the one
    before settled)."""
    settled, plain = (trainer_smoke("pose", "cpu", small=True).trainer
                      for _ in range(2))
    batch = pose_batch()
    stats = pt._StaticStats(settled.g, settled.d)
    norms = batch_norms(settled)
    assert len(stats.held) == len(norms) > 0
    held = [[getattr(m, k) for k in pt._STATS] for m in norms]
    for step in range(3):
        got = settled._step(batch)
        stats.settle()
        want = plain._step(batch)
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in got)
        assert all(getattr(m, k) is t for m, ts in zip(norms, held)
                   for k, t in zip(pt._STATS, ts))
        # D's norms run once a step in training mode (the real pair)
        assert int(settled.d.model[3].num_batches_tracked) == step + 1
        for m, twin in zip(norms, batch_norms(plain)):
            for k in pt._STATS:
                assert torch.equal(getattr(m, k), getattr(twin, k)), k
    for net in ("g", "d"):
        for (k, p), (_, q) in zip(
                getattr(settled, net).named_parameters(),
                getattr(plain, net).named_parameters()):
            assert torch.equal(p, q), k


def test_graphs_are_kept_a_batch_layout_up_to_max_graphs():
    """One graph a layout (keys, shapes, dtypes), made on its first call
    and found on later ones; past ``MAX_GRAPHS`` layouts none. Making the
    set sets both Adams ``capturable``."""
    trainer = trainer_smoke("pose", "cpu", small=True).trainer
    graphs = pt._StepGraphs(trainer)
    assert all(g["capturable"] for opt in (trainer.opt_g, trainer.opt_d)
               for g in opt.param_groups)
    b2, b3, b4 = (pose_batch(n) for n in (2, 3, 4))
    first = graphs.get(b2)
    assert first is not None and graphs.get(b2) is first
    assert first.batch["img_1"] is not b2["img_1"]
    assert torch.equal(first.batch["img_1"], b2["img_1"])
    assert pt.MAX_GRAPHS == 2
    second = graphs.get({**b2, "kp_1": b2["kp_1"].double()})
    assert second is not None and second is not first
    assert graphs.get(b3) is None and graphs.get(b4) is None


@pytest.mark.parametrize("change", ["lr", "betas", "opt_d", "d", "state"])
def test_graphs_are_dropped_for_other_optimizers_or_settings(change):
    trainer = trainer_smoke("pose", "cpu", small=True).trainer
    graphs = pt._StepGraphs(trainer)
    assert graphs.holds(trainer)
    if change == "lr":
        trainer.opt_g.param_groups[0]["lr"] *= 0.5
    elif change == "betas":
        trainer.opt_d.param_groups[0]["betas"] = (0.5, 0.999)
    elif change == "opt_d":
        trainer.opt_d = pt.adam(trainer.d.parameters(), 2e-4)
    elif change == "d":
        trainer.d = pt.build_d(trainer.cfg)
    else:
        trainer.opt_g.load_state_dict(trainer.opt_g.state_dict())
    assert not graphs.holds(trainer)


def test_on_the_host_the_step_takes_no_graph():
    trainer = trainer_smoke("pose", "cpu", small=True).trainer
    batch = pose_batch()
    assert trainer._graph(batch) is None
    trainer.step(batch)
    assert trainer._graphs is None and trainer.steps == 1
    assert not any(g.get("capturable") for opt in (trainer.opt_g,
                                                   trainer.opt_d)
                   for g in opt.param_groups)
