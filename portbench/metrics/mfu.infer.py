"""The whole inference pass's share of the H100's fp32 peak: the
renderer's FLOPs of the frames delivered and of each clip's photo
(MODNet, the static net, ``encode_static``; ``counts/flops.py``) over the
window's time x 67 TFLOP/s. MTCNN, FAN3D, the audio nets and the padded
frames are left out, so the share is a floor."""
from portbench.counts import FP32_FLOPS


def read(run):
    units = run.get("units") or []
    if not units:
        return None
    work = run["work"]
    flops = sum(u["frames_n"] for u in units) * work["frame_flops"] \
        + len(units) * work["photo_flops"]
    return 100.0 * flops / (run["window_s"] * FP32_FLOPS)
