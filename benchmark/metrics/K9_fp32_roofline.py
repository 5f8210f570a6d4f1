"""K9's fp32 forward (3xTF32 flash attention: `flash_fwd_tf32` and its key
split `flash_fwd_tf32_split`) over the prior's attention, against its
operations bound (three products per product at 494.7 TFLOP/s)."""
from benchmark.counts.work import roofline_share

UNIT = "%"
NAMES = {"flash_fwd_tf32", "flash_fwd_tf32_split"}


def read(run, suffix):
    return roofline_share(run, NAMES, "k9_fp32_bound_s")
