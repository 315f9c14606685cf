"""Train step (pose transfer): the share of the window's steps that
replayed the step's CUDA graph: the port's counter ``pt.graph_replay``
over the window's steps, in %. None where the record holds no such
counter (a port that does not replay the step)."""
from portbench import program_spans


def read(run):
    steps = run.get("steps")
    rec = program_spans.record()
    if not steps or rec is None:
        return None
    replays = rec[1].get("pt.graph_replay")
    if replays is None:
        return None
    return 100.0 * replays / steps
