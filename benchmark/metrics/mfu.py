"""The whole step's share of the chip's peak: each video's products at the
peaks of the precisions the configuration states (counts/work.py: bf16 at
989 TFLOP/s, fp32 at 67, the priors' attention as 3 x its operations at the
3xTF32 rate of 494.7), for every video of the traced window, over the
window's length. The solve's arithmetic is not counted."""
from benchmark.counts import work

UNIT = "%"


def read(run, suffix):
    tr, n = run.trace, len(run.done())
    if tr is None or not n:
        return None
    return 100.0 * n * work.least_time_s(run.cfg, run.traffic) / tr.window_s
