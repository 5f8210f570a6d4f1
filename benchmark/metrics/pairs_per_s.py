"""Pairs through the network pass per second: every pair of every video
started in the window, over the time from the window's start to the end of
the last one."""
UNIT = "pairs/s"


def read(run, suffix):
    pairs = sum(v["pairs"] for v in run.done())
    return pairs / (run.window[1] - run.window[0]) if pairs else None
