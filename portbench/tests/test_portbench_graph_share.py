"""``graph_share.train`` reads the port's replay counter over the window's
steps, and finds nothing without a record or without the counter."""
import importlib.util
import os

import pytest

from portbench import program_spans
from portbench.tests import helpers


def reader():
    path = os.path.join(helpers.REPO, "portbench", "metrics",
                        "graph_share.train.py")
    spec = importlib.util.spec_from_file_location("graph_share_train", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


SPAN = ("m2.step", 0, None, 10, 20)


@pytest.mark.parametrize("record, steps, want", [
    (([SPAN], {"m2.graph_replay": 49, "m2.graph_capture": 0}), 50, 98.0),
    (([SPAN], {"m2.graph_replay": 50}), 50, 100.0),
    (([SPAN], {}), 50, None),          # the record of an eager step
    (None, 50, None),                  # no record
    (([SPAN], {"m2.graph_replay": 3}), 0, None),
], ids=["replays", "all", "no_counter", "no_record", "no_steps"])
def test_graph_share_reads_the_replay_counter(monkeypatch, record, steps,
                                              want):
    monkeypatch.setattr(program_spans, "record", lambda: record)
    assert reader()({"steps": steps}) == want
