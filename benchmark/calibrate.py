"""The readings that the limits of ``limits/<workload>.json`` are set from.

    python3 -m benchmark.calibrate --workload <name> --seeds 1,2,3
                                   [--controls 3] [--seconds 1]

Runs the cell once a seed in one process (a short window) and prints, a
line a seed, every number that decides ``correct`` for the program and,
on the first ``--controls`` seeds, for the control (the reference in the
next lower precision put in the program's place: TF32) and, in a training
cell, the fault of half the batch left out. The last line sums them up:
for each number the largest program reading (the lower reading) and the
smallest reading of each control and fault (the upper ones). The
benchmark's own runs never run this; it needs a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys

from . import run as bench


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = bench.bench_spec()
    lower, upper = {}, {}
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        ctx = bench.context(spec, args.workload, seed, args.seconds, False)
        ctx.extra["controls"] = i < args.controls
        generator = importlib.import_module(
            f"benchmark.generators.{ctx.traffic['generator']}")
        with contextlib.redirect_stdout(sys.stderr):
            res = generator.run(ctx)
        row = {"seed": seed, "program": {k: v for k, v, _ in res["checks"]},
               "loss_gap_by_step": res.get("loss_gap_by_step"),
               "controls": res.get("controls", {}),
               "e2e": res["e2e"]}
        print(json.dumps(row), flush=True)
        for k, v in row["program"].items():
            lower[k] = max(lower.get(k, 0.0), v)
        for name, vals in row["controls"].items():
            for k, v in vals.items():
                if not isinstance(v, list):
                    upper.setdefault(name, {})
                    upper[name][k] = min(upper[name].get(k, float("inf")), v)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "lower": lower,
                      "upper": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
