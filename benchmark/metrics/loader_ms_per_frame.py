"""Milliseconds of the host loader per frame: the benchmark's span around
the frames' and priors' crop to the network's size (`inference/images.py`'s
`crop_img` and `normalize_img`, on the host) in the window, over the
frames."""
UNIT = "ms"


def read(run, suffix):
    frames = sum(v["frames"] for v in run.done())
    s = run.span_seconds("loader")
    return 1e3 * s / frames if frames and s else None
