"""Front end: ms a clip in the pipeline's stages before the renderer
(detect, align, fan, audio, landmarks), from the port's
``PipelineOutputs.stage_seconds`` (each stage ends in a synchronize)."""

STAGES = ("detect", "align", "fan", "audio", "landmarks")


def read(run):
    units = run.get("units") or []
    if not units:
        return None
    return 1e3 * sum(sum(u["stages"].get(s, 0.0) for s in STAGES)
                     for u in units) / len(units)
