"""The port's span registry (``animateportrait_tpu_torch/utils/observe.py``):
with no profiler session a span or a count does nothing (checked by
structure: ``record_function`` and the clocks raise if called); under a
CPU ``torch.profiler`` session it records nesting, parents, self time,
request ids, the cap's drops and a new record a session; its times lie on
kineto's clock; ``profile_trace`` writes ``spans.jsonl`` inside the
trace's time. Only ``observe.py`` opens ``record_function`` in the port."""
import json
import pathlib
import threading
import time
import types

import torch
from torch.profiler import ProfilerActivity, profile

from animateportrait_tpu_torch.utils import observe

PORT = pathlib.Path(__file__).resolve().parents[1].joinpath(
    "animateportrait_tpu_torch")


def session():
    """A CPU profiler session with a new record: a span outside any
    session comes first, as set-up's spans come before a traced window."""
    with observe.span("no session"):
        pass
    return profile(activities=[ProfilerActivity.CPU])


def busy(ms: float) -> None:
    end = time.perf_counter() + ms / 1e3
    while time.perf_counter() < end:
        pass


def dur(rec) -> int:
    return rec[4] - rec[3]


def in_a_thread():
    with observe.span("e"):
        pass


def _raise(*args, **kwargs):
    raise AssertionError("called with no profiler session")


def test_a_span_does_nothing_without_a_profiler(monkeypatch):
    monkeypatch.setattr(observe, "_spans", [])
    monkeypatch.setattr(observe, "_counters", {})
    monkeypatch.setattr(observe, "record_function", _raise)
    monkeypatch.setattr(observe, "time", types.SimpleNamespace(
        perf_counter_ns=_raise, time_ns=_raise))
    monkeypatch.setattr(observe, "_Span", _raise)
    assert not torch.autograd.profiler._is_profiler_enabled
    for _ in range(3):
        with observe.span("a") as s:
            assert s is None
            observe.count("c", 5)
    write = object()
    assert observe.timed(write, "c") is write
    assert observe.spans() == [] and observe.counters() == {}
    assert observe.span("b") is observe.span("c")   # one shared object


def test_nesting_parents_self_time_and_rids():
    with session():
        observe.request(3)
        with observe.span("a"):
            busy(2)
            with observe.span("b"):
                busy(1)
                observe.count("n", 2)
            with observe.span("b"):
                busy(1)
                observe.count("n", 3)
        observe.request(4)
        with observe.span("c"):
            pass
        with observe.span("d"):
            t = threading.Thread(target=in_a_thread)
            t.start()
            t.join()
    rec = observe.spans()
    assert [r[0] for r in rec] == ["a", "b", "b", "c", "d", "e"]
    # another thread's span has its own stack and its own request id
    assert [r[2] for r in rec] == [None, 0, 0, None, None, None]
    assert [r[1] for r in rec] == [3, 3, 3, 4, 4, None]
    a, b1, b2 = rec[:3]
    assert a[3] <= b1[3] <= b1[4] <= b2[3] <= b2[4] <= a[4]
    assert dur(b1) >= 1e6 and dur(a) >= 4e6
    assert observe.self_ns("a") == dur(a) - dur(b1) - dur(b2)
    assert observe.self_ns("b") == dur(b1) + dur(b2)
    assert observe.self_ns("missing") == 0
    assert observe.counters() == {"n": 5}


def test_the_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(observe, "MAX_SPANS", 3)
    with session():
        for _ in range(2):
            with observe.span("kept"):
                pass
        with observe.span("kept"):
            with observe.span("dropped"):
                pass
        with observe.span("dropped"):
            pass
    rec = observe.spans()
    assert [r[0] for r in rec] == ["kept"] * 3
    assert all(r[4] is not None for r in rec)
    assert observe.counters() == {observe.DROPPED: 2}


def test_a_new_session_starts_a_new_record():
    with session():
        with observe.span("first"):
            observe.count("n", 1)
    # the record outlives its session, for the readers after it
    with observe.span("off"):
        observe.count("n", 1)
    assert [r[0] for r in observe.spans()] == ["first"]
    assert observe.counters() == {"n": 1}
    with session():
        with observe.span("second"):
            pass
    assert [r[0] for r in observe.spans()] == ["second"]
    assert observe.counters() == {}


def test_span_times_lie_on_the_profilers_clock():
    with session():                 # the process's first record_function
        with observe.span("warm"):
            pass
    with session() as prof:
        for i in range(5):
            with observe.span(f"s{i}"):
                torch.ones(64, 64) @ torch.ones(64, 64)
                busy(0.2)
    ours = {r[0]: r for r in observe.spans()}
    events = {ev.name(): ev for ev in prof.profiler.kineto_results.events()
              if ev.name() in ours}
    assert set(events) == set(ours)
    for name, r in ours.items():
        ev = events[name]
        assert abs(r[3] - ev.start_ns()) < 1e6, name
        assert abs(r[4] - (ev.start_ns() + ev.duration_ns())) < 1e6, name


def test_profile_trace_writes_spans_inside_the_trace(tmp_path):
    with session():                 # a record the trace must replace
        with observe.span("earlier"):
            pass
    with observe.profile_trace(str(tmp_path)) as path:
        observe.request(9)
        with observe.span("outer"):
            with observe.span("inner"):
                torch.ones(32, 32).sum()
        observe.count("bytes", 7)
    with open(tmp_path / "spans.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert lines[-1] == {"counters": {"bytes": 7}}
    spans = lines[:-1]
    assert [(s["name"], s["rid"], s["parent"]) for s in spans] == [
        ("outer", 9, None), ("inner", 9, 0)]
    with open(path) as f:
        trace = json.load(f)
    base = trace["baseTimeNanoseconds"]
    timed = [e for e in trace["traceEvents"] if "ts" in e and "dur" in e]
    lo = min(base + e["ts"] * 1e3 for e in timed)
    hi = max(base + (e["ts"] + e["dur"]) * 1e3 for e in timed)
    for s in spans:
        assert lo <= s["start_ns"] <= s["end_ns"] <= hi, s
    # each span is its own event of the trace, at its time
    for s in spans:
        ev = next(e for e in timed if e["name"] == s["name"])
        assert abs(base + ev["ts"] * 1e3 - s["start_ns"]) < 1e6


def test_only_observe_opens_record_function():
    offenders = [str(p.relative_to(PORT)) for p in PORT.rglob("*.py")
                 if p.name != "observe.py"
                 and ("record_function" in p.read_text()
                      or "torch.profiler" in p.read_text())]
    assert offenders == []
