"""Seconds of the engine per video: `SceneResult.timings["inference_s"]`
(the pipeline's own interval, ending in a synchronise), averaged over the
window's videos."""
UNIT = "s"


def read(run, suffix):
    t = [v["timings"]["inference_s"] for v in run.done() if "inference_s" in v["timings"]]
    return sum(t) / len(t) if t else None
