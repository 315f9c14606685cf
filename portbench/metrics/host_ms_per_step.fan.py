"""Train step (FAN): the host's ms a step, issuing it: the port's
``fan.step`` spans over the window's steps. Against 1 / the traced steps
per second it says whether the host sets the step's pace."""
from portbench import program_spans


def read(run):
    steps = run.get("steps")
    rec = program_spans.record()
    if not steps or rec is None:
        return None
    ns = program_spans.total_ns(rec[0], "fan.step")
    if ns <= 0:
        return None
    return ns / 1e6 / steps
