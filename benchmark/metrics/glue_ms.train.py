"""Device ms a step in PyTorch's own kernels: every device operation that
is neither a hand-written kernel of ``apnerf_torch/csrc`` nor a library
matrix product (the marks of ``kernels.json``). Nothing is read where no
matrix product shows in the trace: the marks would then mislabel them."""


def read(r):
    groups = r["trace"]["device_us_by_group"]
    if not groups.get("gemm") or not groups.get("glue"):
        return None
    return groups["glue"] / 1e3
