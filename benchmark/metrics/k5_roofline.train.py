"""K5 (``sorted_window_accumulate``) against its roofline, in %: the least
time of the bytes a stage-1 step needs it to move (``work.k5_bound``: the
filled samples' rows read once and each scale's gradient grid written
once, at the HBM rate) over K5's device time a step in the trace. Nothing
is read where K5 did not run."""
from benchmark.trace import kernel_us


def read(r):
    us = kernel_us(r["trace"], "K5_scatter")
    bound = r["work"].get("k5")
    if us is None or not bound:
        return None
    return 100.0 * bound["seconds"] / (us * 1e-6)
