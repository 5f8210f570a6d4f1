"""Adam iterations of the global alignment per second: the window's
iterations over the sum of `SceneResult.timings["solve_s"]`."""
UNIT = "it/s"


def read(run, suffix):
    so = run.traffic.get("solve")
    t = [v["timings"]["solve_s"] for v in run.done() if "solve_s" in v["timings"]]
    return so["niter"] * len(t) / sum(t) if so and t and sum(t) else None
