"""Seconds per video on the whole depth path: the time from the window's
start to the end of the last video started in it, over the videos started
(failed ones included)."""
UNIT = "s"


def read(run, suffix):
    n = len(run.videos)
    return (run.window[1] - run.window[0]) / n if n else None
