"""Pairs per second of the engine alone: the window's pairs over the
benchmark's spans around `inference.engine.inference` (each ends in a
synchronise)."""
UNIT = "pairs/s"


def read(run, suffix):
    pairs = sum(v["pairs"] for v in run.done())
    s = run.span_seconds("engine")
    return pairs / s if pairs and s else None
