"""The pose-transfer trainer's spans and counter
(``animateportrait_tpu_torch/train/pose_transfer.py``), at the convergence
tool's small widths on the CPU (``utils/smoke.py:trainer_smoke("pose",
small=True)``: G_nf 8, 3 scales, 2 warp scales, 6 joints, 32^2, D on,
batch 2): under a profiler each step records ``pt.step`` with its phases
nested in it once each, and ``pt.feature_warps`` counts every
``warp_acc_flow`` call; with no profiler nothing is recorded, and the
step computes bit for bit what it computes under one. On the host the
step is the eager step, no CUDA graph and no ``pt.graph_*`` counter."""
import torch
from torch.profiler import ProfilerActivity, profile

from animateportrait_tpu_torch.train import convergence as cv
from animateportrait_tpu_torch.utils import observe
from animateportrait_tpu_torch.utils.smoke import trainer_smoke

PHASES = ("pt.flow", "pt.g_forward", "pt.g_loss", "pt.g_grad", "pt.d_loss",
          "pt.d_grad", "pt.adam")


def fresh_session():
    """A profiler session with a new record (a span with none comes
    first, as set-up's spans come before a traced window)."""
    with observe.span("no session"):
        pass
    return profile(activities=[ProfilerActivity.CPU])


def shape(rec):
    """(name, rid, parent's name) a span."""
    return [(n, r, None if p is None else rec[p][0])
            for n, r, p, _, _ in rec]


def test_each_step_records_its_phases_once_inside_pt_step():
    smoke = trainer_smoke("pose", "cpu", small=True)
    cfg = smoke.trainer.cfg
    with fresh_session():
        for _ in range(2):
            smoke.run()
    rec = observe.spans()
    want = []
    for k in range(2):
        want += [("pt.step", k, None)] + [(n, k, "pt.step") for n in PHASES]
    assert shape(rec) == want
    assert all(e is not None and s <= e for _, _, _, s, e in rec)
    # per step: the image warp, and one skip warp a residual block of
    # each warped scale of the DualUnet
    n_res = smoke.trainer.g.n_res
    assert observe.counters() == {
        "pt.feature_warps": 2 * (cfg.G_n_warp_scale * n_res + 1)}


def test_without_a_profiler_nothing_is_recorded_and_the_step_is_the_same(
        monkeypatch):
    plain, traced = (trainer_smoke("pose", "cpu", small=True)
                     for _ in range(2))
    monkeypatch.setattr(observe, "_spans", [])
    monkeypatch.setattr(observe, "_counters", {})
    assert not torch.autograd.profiler._is_profiler_enabled
    got = plain.run()
    assert observe._spans == [] and observe._counters == {}
    with fresh_session():
        want = traced.run()
    assert observe.spans()
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    for name in ("g", "d"):
        a, b = plain.nets[name], traced.nets[name]
        for (k, p), (_, q) in zip(a.named_parameters(),
                                  b.named_parameters()):
            assert torch.equal(p, q) and torch.equal(p.grad, q.grad), k
        for (k, p), (_, q) in zip(a.named_buffers(), b.named_buffers()):
            assert torch.equal(p, q), k


def test_on_the_host_the_step_is_the_eager_step():
    """``step`` on the host against the eager step's body (``_step``) of a
    twin, bit for bit over two steps: the losses, the parameters, their
    gradients and the BatchNorm statistics, which each training-mode call
    binds to new tensors, as the eager step does."""
    smoke, twin = (trainer_smoke("pose", "cpu", small=True)
                   for _ in range(2))
    tr = smoke.trainer
    bn = tr.d.model[3]
    with fresh_session():
        for _ in range(2):
            before = bn.running_mean
            got = smoke.run()
            assert bn.running_mean is not before
        counts = observe.counters()
    assert tr._graphs is None and tr.steps == 2
    assert not any(k.startswith("pt.graph") for k in counts)
    # the smoke's batch (convergence.pose_batch, NCHW)
    batch = {k: (torch.from_numpy(v).permute(0, 3, 1, 2).contiguous()
                 if v.ndim == 4 else torch.from_numpy(v))
             for k, v in cv.pose_batch(2, 32, 6).items()}
    for _ in range(2):
        want = twin.trainer._step(batch)
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    for name in ("g", "d"):
        a, b = smoke.nets[name], twin.nets[name]
        for (k, p), (_, q) in zip(a.named_parameters(),
                                  b.named_parameters()):
            assert torch.equal(p, q) and torch.equal(p.grad, q.grad), k
        for (k, p), (_, q) in zip(a.named_buffers(), b.named_buffers()):
            assert torch.equal(p, q), k
