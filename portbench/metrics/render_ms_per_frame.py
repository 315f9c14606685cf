"""Renderer: ms of the ``render`` stage (``stage_seconds``) per frame
delivered."""


def read(run):
    units = run.get("units") or []
    frames = sum(u["frames_n"] for u in units)
    if not frames:
        return None
    return 1e3 * sum(u["stages"]["render"] for u in units) / frames
