"""Entry layer: host ms a clip in the CLI's own I/O calls (``read_image``,
``load_wav``, ``write_video_with_audio``), by the host clock."""


def read(run):
    units = run.get("units") or []
    if not units:
        return None
    return 1e3 * sum(u["io_s"] for u in units) / len(units)
