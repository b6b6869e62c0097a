"""The whole step's share of the chip's peak, in %: the least time of the
work the step needs (``work.point_model``: bf16 operations at the bf16
peak plus fp32 operations at the fp32 peak, TF32 off) over the measured
wall time of a step in the traced window."""
from benchmark.work import least_seconds


def read(r):
    ops = r["work"].get("ops")
    if not ops or r["unit_s"] <= 0:
        return None
    return 100.0 * least_seconds(ops, r["peaks"]) / r["unit_s"]
