"""Device memory: ``torch.cuda.max_memory_allocated`` over the window
(after ``reset_peak_memory_stats``), in GiB: what bounds the batch."""


def read(run):
    if not run.get("steps") or not run.get("peak_bytes"):
        return None
    return run["peak_bytes"] / 2 ** 30
