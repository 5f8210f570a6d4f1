"""Share of the traced window in which no kernel, copy or set ran on the
card: the union of the profiler's device intervals against the window."""
UNIT = "%"


def read(run, suffix):
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (tr.window_s - tr.busy_s()) / tr.window_s
