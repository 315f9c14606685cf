"""Train step: the host's own ms a step, issuing it: the port's
``m2.step`` spans less its ``m2.pool_fetch`` spans (the pool's blocking
reads), over the window's steps."""
from portbench import program_spans


def read(run):
    steps = run.get("steps")
    rec = program_spans.record()
    if not steps or rec is None:
        return None
    spans, _ = rec
    ns = (program_spans.total_ns(spans, "m2.step")
          - program_spans.total_ns(spans, "m2.pool_fetch"))
    return ns / 1e6 / steps
