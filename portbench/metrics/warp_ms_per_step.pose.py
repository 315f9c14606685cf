"""Kernels (pose transfer): the device ms a step in the flow warps, the
``grid_sample`` kernels forward and backward (``grid_sampler_2d*``, by
name in the trace), over the window's steps: the source image's warp and
the DualUnet's skip warps, with their gradients."""


def is_warp(name: str) -> bool:
    """``grid_sampler_2d_kernel`` and ``grid_sampler_2d_backward_kernel``,
    by name, demangled or not."""
    return "grid_sampler_2d" in name


def read(run):
    trace, steps = run.get("trace"), run.get("steps")
    if trace is None or not steps:
        return None
    s = sum(t for n, t in trace["kernel_s"].items() if is_warp(n))
    if s <= 0:
        return None
    return 1e3 * s / steps
