"""The control of each cell on the card, at the cell's own size: the
reference put in the program's place in the next lower precision (TF32)
must come out not correct under the cell's limits, on three seeds, while
the program comes out correct. ``benchmark.calibrate`` prints the same
readings for more seeds; the benchmark's own runs never run this."""
import contextlib
import importlib
import sys

import pytest

from benchmark import run as bench

SEEDS = (4100000007, 4100000019, 4100000031)


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      bench.bench_spec()["workloads"]])
def test_control_fails_and_program_passes(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = bench.bench_spec()
    for seed in SEEDS:
        ctx = bench.context(spec, workload, seed, 1.0, False)
        ctx.extra["controls"] = True
        generator = importlib.import_module(
            f"benchmark.generators.{ctx.traffic['generator']}")
        with contextlib.redirect_stdout(sys.stderr):
            res = generator.run(ctx)
        assert all(v <= lim for _, v, lim in res["checks"]), res["checks"]
        tf32 = res["controls"]["tf32"]
        assert any(tf32[k] > ctx.limits[k] for k in tf32
                   if k in ctx.limits), tf32
        torch.cuda.empty_cache()
