"""Kernels: K2's share of its HBM roofline on the inference path. The
least time of the window's InstanceNorms (each clip's per-photo planes
and its frame batches, padded ones too, at the shapes ``counts/flops.py``
reads off the frozen nets; bytes by the frozen ``k2_work``) over the
device time of K2's kernels (``instance_norm_*_kernel``, not the
backward's) in the trace."""
from portbench.counts import bound, k2_work


def is_k2(name: str) -> bool:
    """K2's kernels (``instance_norm_smem_kernel``, the streaming branch),
    by name, demangled or not; not K2b's (``instance_norm_bwd_*``)."""
    return "instance_norm_" in name and "bwd" not in name


def read(run):
    trace, units = run.get("trace"), run.get("units") or []
    if trace is None or not units:
        return None
    k2_s = sum(t for n, t in trace["kernel_s"].items() if is_k2(n))
    if k2_s <= 0:
        return None
    work = run["work"]
    fb = run["config"]["frame_batch"]
    photo = sum(bound(*k2_work(s))[0] for s in work["photo_in_shapes"])
    batch = sum(bound(*k2_work(s))[0] for s in work["batch_in_shapes"])
    batches = sum((u["frames_n"] + u["padded"]) // fb for u in units)
    return 100.0 * (len(units) * photo + batches * batch) / k2_s
