"""Seconds from the process's start to the window's: imports, the kernels'
build (from the checkout's cache after the first run), seeded weights, the
input videos and one warm-up video of the cell's traffic."""
UNIT = "s"


def read(run, suffix):
    return run.setup_s
