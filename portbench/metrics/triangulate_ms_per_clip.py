"""Renderer: host ms a clip in the Delaunay triangulation of every padded
frame, before the clip's first batch: the port's ``render.triangulate``
spans over the window's clips."""
from portbench import program_spans


def read(run):
    units = run.get("units") or []
    rec = program_spans.record()
    if not units or rec is None:
        return None
    spans, _ = rec
    return program_spans.total_ns(spans, "render.triangulate") / 1e6 / len(
        units)
