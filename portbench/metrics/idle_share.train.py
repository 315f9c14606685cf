"""Device: the share of the traced window in which no kernel, memcpy or
memset ran (training cells)."""


def read(run):
    trace = run.get("trace")
    if trace is None or not run.get("steps"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
