"""Seconds of the MST initialisation per video: `SceneResult.timings
["init_s"]`, averaged over the window's videos."""
UNIT = "s"


def read(run, suffix):
    t = [v["timings"]["init_s"] for v in run.done() if "init_s" in v["timings"]]
    return sum(t) / len(t) if t else None
