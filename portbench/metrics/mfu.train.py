"""The whole train step's share of the H100's fp32 peak: the step's
forward and backward FLOPs (``counts/flops.py`` over the frozen step;
Adam left out) x the window's steps over its time x 67 TFLOP/s."""
from portbench.counts import FP32_FLOPS


def read(run):
    if not run.get("steps"):
        return None
    return 100.0 * run["steps"] * run["work"]["step_flops"] / (
        run["window_s"] * FP32_FLOPS)
