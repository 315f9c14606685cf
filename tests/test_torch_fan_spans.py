"""The spans of the port's one-net trainers (``train/optim.py:AdamTrainer``
and ``train/fan.py:FANTrainer``) on the CPU, at small widths: under a
profiler a FAN step records ``fan.step`` with ``fan.forward``,
``fan.loss``, ``fan.grad`` and ``fan.adam`` nested in it once each, its
request id the steps taken before it; with no profiler nothing is
recorded, and the step computes bit for bit what it computes under one.
The other ``AdamTrainer`` trainers record ``<prefix>.step`` with its
``.grad`` and ``.adam`` under a prefix of their own, and their losses and
updates do not change under a profiler."""
import copy

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from animateportrait_tpu_torch.train import fan as tf
from animateportrait_tpu_torch.utils import observe
from animateportrait_tpu_torch.utils.smoke import trainer_smoke

FAN_PHASES = ("fan.forward", "fan.loss", "fan.grad", "fan.adam")
# the other AdamTrainer trainers of ``utils/smoke.py``, by their prefix
OTHERS = {"content": "m1_content", "speaker": "m1_speaker",
          "flow": "flowreg", "imtrans": "imtrans"}


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


def fan_pair():
    """Two identical FAN trainers (2 stacks, 68 points) and a batch of
    two 64^2 faces with their targets."""
    cfg = tf.FANTrainConfig(num_modules=2, num_landmarks=68)
    torch.manual_seed(0)
    model = tf.build_fan(cfg)
    trainers = [tf.FANTrainer(cfg, copy.deepcopy(model), device="cpu")
                for _ in range(2)]
    rng = np.random.default_rng(3)
    lms = rng.uniform(40, 216, (2, 68, 2))
    targets = [tf.make_fan_targets(lm, hm_size=16) for lm in lms]
    gt, w = (torch.from_numpy(np.stack([t[j] for t in targets]))
             for j in (0, 1))
    x = torch.from_numpy(rng.uniform(0, 1, (2, 3, 64, 64)).astype(
        np.float32))
    return trainers, (x, gt, w)


def assert_same_state(a, b):
    for (k, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q) and torch.equal(p.grad, q.grad), k
    for (k, p), (_, q) in zip(a.named_buffers(), b.named_buffers()):
        assert torch.equal(p, q), k


def test_a_fan_step_records_its_phases_once_inside_fan_step():
    (tr, _), batch = fan_pair()
    with fresh_session():
        for _ in range(2):
            tr.step(*batch)
    rec = observe.spans()
    want = []
    for k in range(2):
        want += [("fan.step", k, None)] + [(n, k, "fan.step")
                                           for n in FAN_PHASES]
    assert shape(rec) == want
    assert all(e is not None and s <= e for _, _, _, s, e in rec)
    # the phases lie inside their step, one after another
    for i in (0, 5):
        inner = rec[i + 1:i + 5]
        assert rec[i][3] <= inner[0][3] and inner[-1][4] <= rec[i][4]
        assert all(a[4] <= b[3] for a, b in zip(inner, inner[1:]))
    assert observe.counters() == {}


def test_without_a_profiler_nothing_is_recorded_and_the_step_is_the_same(
        monkeypatch):
    (plain, traced), batch = fan_pair()
    monkeypatch.setattr(observe, "_spans", [])
    monkeypatch.setattr(observe, "_counters", {})
    assert not torch.autograd.profiler._is_profiler_enabled
    got = [plain.step(*batch) for _ in range(2)]
    assert observe._spans == [] and observe._counters == {}
    with fresh_session():
        want = [traced.step(*batch) for _ in range(2)]
    assert observe.spans()
    for a, b in zip(got, want):
        assert a.keys() == b.keys() == {"loss"}
        assert torch.equal(a["loss"], b["loss"])
    assert plain.steps == traced.steps == 2
    assert_same_state(plain.model, traced.model)


@pytest.mark.parametrize("name", sorted(OTHERS))
def test_the_other_trainers_keep_their_losses_under_their_own_prefix(name):
    """One step plain and one under a profiler, on twins: the same losses
    and state bit for bit, the losses those of ``losses`` on the batch
    before the update, and the spans ``<prefix>.step`` with ``.grad`` and
    ``.adam`` inside it."""
    plain, traced, probe = (trainer_smoke(name, "cpu", small=True)
                            for _ in range(3))
    prefix = OTHERS[name]
    assert type(plain.trainer).span_prefix == prefix
    got = plain.run()
    with fresh_session():
        want = traced.run()
    assert shape(observe.spans()) == [
        (f"{prefix}.step", 0, None), (f"{prefix}.grad", 0, f"{prefix}.step"),
        (f"{prefix}.adam", 0, f"{prefix}.step")]
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    for net in plain.nets:
        assert_same_state(plain.nets[net], traced.nets[net])
    # the step returns what its losses computed before the update
    probe.trainer.step = probe.trainer.losses
    before = probe.run()
    for k in got:
        assert torch.equal(got[k], before[k].detach()), k
