"""``graph_share.pose`` reads the pose trainer's replay counter over the
window's steps, and finds nothing without a record or without the
counter."""
import importlib.util
import os

import pytest

from portbench import program_spans
from portbench.tests import helpers


def reader():
    path = os.path.join(helpers.REPO, "portbench", "metrics",
                        "graph_share.pose.py")
    spec = importlib.util.spec_from_file_location("graph_share_pose", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


SPAN = ("pt.step", 0, None, 10, 20)


@pytest.mark.parametrize("record, steps, want", [
    (([SPAN], {"pt.graph_replay": 49, "pt.graph_capture": 0}), 50, 98.0),
    (([SPAN], {"pt.graph_replay": 50}), 50, 100.0),
    (([SPAN], {"pt.feature_warps": 11}), 50, None),   # an eager step
    (([SPAN], {"m2.graph_replay": 50}), 50, None),    # the Module2 step's
    (None, 50, None),                                 # no record
    (([SPAN], {"pt.graph_replay": 3}), 0, None),
], ids=["replays", "all", "no_counter", "other_step", "no_record",
        "no_steps"])
def test_graph_share_pose_reads_the_replay_counter(monkeypatch, record,
                                                   steps, want):
    monkeypatch.setattr(program_spans, "record", lambda: record)
    assert reader()({"steps": steps}) == want
