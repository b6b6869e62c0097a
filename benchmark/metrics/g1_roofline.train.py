"""G1 (the stage-1 multi-scale grid sample: ``trilerp_kernel`` forward,
``trilerp_grad_kernel``, ``trilerp_rows_kernel`` and
``trilerp_fold_kernel`` backward) against its roofline, in %: the least
time of the bytes a stage-1 step needs it to move (``work.g1_bound``: the
grid points the samples touch, their positions, the three scales'
features; the live rows' cotangents and the points they touch, the
grid's gradient and d/dxyz; touched points and live rows counted in the
reference's steps) over G1's device time a step in the trace. K5, which
G1's backward calls, keeps its own mark and is not counted here. Nothing is read where G1 did not run."""
from benchmark.trace import kernel_us


def read(r):
    us = kernel_us(r["trace"], "G1_trilerp")
    bound = r["work"].get("g1")
    if us is None or not bound:
        return None
    return 100.0 * bound["seconds"] / (us * 1e-6)
