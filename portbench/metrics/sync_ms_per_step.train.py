"""Train step: ms a step the host waits on the device inside the step:
the port's ``m2.pool_fetch`` spans (the pool draws' device-to-host read,
which drains the queue), over the window's steps."""
from portbench import program_spans


def read(run):
    steps = run.get("steps")
    rec = program_spans.record()
    if not steps or rec is None:
        return None
    spans, _ = rec
    return program_spans.total_ns(spans, "m2.pool_fetch") / 1e6 / steps
