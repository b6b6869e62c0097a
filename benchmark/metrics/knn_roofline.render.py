"""The exact k-NN (K2 ``knn_count_kernel`` and K3 ``knn_topk_kernel``)
against its roofline, in %: the least time of the k-NN work a frame's
result needs (``work.knn_bound``: the larger of 8 fp32 operations for each
of the K distances of each active sample, and the bytes of the queries
read once, the K (d2, index) pairs written and the point tables read once
a chunk) over K2 and K3's device time a frame in the trace. Nothing is
read where neither ran or the cell counts no such work."""
from benchmark.trace import kernel_us


def read(r):
    us = [kernel_us(r["trace"], k) for k in ("K2_count", "K1_K3_scan")]
    bound = r["work"].get("knn")
    if all(u is None for u in us) or not bound:
        return None
    return 100.0 * bound["seconds"] / (sum(u or 0.0 for u in us) * 1e-6)
