"""K6 (``fused_subgroup_agg``) against its roofline, in %: the least time
of the work its output needs in a frame (``work.k6_bound``: the larger of
its operations at the peaks and its bytes at the HBM rate) over K6's
device time a frame in the trace. Nothing is read where K6 did not run."""
from benchmark.trace import kernel_us


def read(r):
    us = kernel_us(r["trace"], "K6_agg")
    bound = r["work"].get("k6")
    if us is None or not bound:
        return None
    return 100.0 * bound["seconds"] / (us * 1e-6)
