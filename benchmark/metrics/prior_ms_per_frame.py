"""Milliseconds of the prior per frame: the benchmark's spans around each
prior batch (each ends in a synchronise) in the window, over the frames."""
UNIT = "ms"


def read(run, suffix):
    frames = sum(v["frames"] for v in run.done())
    s = run.span_seconds("prior")
    return 1e3 * s / frames if frames and s else None
