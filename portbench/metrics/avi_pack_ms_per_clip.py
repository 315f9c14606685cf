"""Entry layer: host ms a clip in the AVI writer's own work, its file
writes left out: the port's ``video.write`` spans (the gray-to-RGB
repeat, the DIB rows, the chunks) less its ``video.file_write_ns``
counter, over the window's clips."""
from portbench import program_spans


def read(run):
    units = run.get("units") or []
    rec = program_spans.record()
    if not units or rec is None:
        return None
    spans, counters = rec
    ns = program_spans.total_ns(spans, "video.write") - counters.get(
        "video.file_write_ns", 0)
    return ns / 1e6 / len(units)
