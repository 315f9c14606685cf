"""Train step: the share of the window's steps that replayed the step's
CUDA graph: the port's counter ``m2.graph_replay`` over the window's
steps, in %. None where the record holds no such counter (a port that
does not replay the step)."""
from portbench import program_spans


def read(run):
    steps = run.get("steps")
    rec = program_spans.record()
    if not steps or rec is None:
        return None
    replays = rec[1].get("m2.graph_replay")
    if replays is None:
        return None
    return 100.0 * replays / steps
