"""The benchmark of ``apnerf_torch`` on one NVIDIA H100.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

Run from the root of a checkout. Everything is found by name from
``BENCHMARK.json``: the cell (``workloads``) names a configuration
(``configs/<config>.json``, which the scene maker and the program read)
and a traffic mix (``traffic/<traffic>.json``, whose ``generator`` names the
general generator in ``generators/`` that reads it); the cell's limits on
the numbers that decide ``correct`` are ``limits/<workload>.json``; each
per-layer metric is read by ``metrics/<name>.py``. A new cell, mix, limit
or metric is a new file and a new entry, never an edit.

With ``--trace 0`` the result line holds the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, read from a ``torch.profiler``
window of a fixed number of steps or frames. Either way the run checks
what its timed path produced against the plain reference
(``reference/``) after the window and prints each number compared beside
its limit, last on standard error and last in the result line. The last
line of standard output is the result, a JSON object.

Exit codes: 0 with a result line; 2 without a CUDA device (or fewer than
the cell asks for) or without the program beside the benchmark; 3 when
JAX, jaxlib, flax or the JAX package was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()   # set-up counts from here, torch's import in it

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import Any, Dict  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "apnerf")


@dataclass
class Ctx:
    """What a generator is given."""
    workload: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t0: float = T0
    extra: Dict[str, Any] = field(default_factory=dict)


def load(rel: str):
    with open(os.path.join(HERE, rel)) as f:
        return json.load(f)


def bench_spec(root: str = ROOT) -> Dict[str, Any]:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_of(spec: Dict[str, Any], workload: str) -> Dict[str, Any]:
    for w in spec["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"benchmark: no workload {workload!r} in BENCHMARK.json")


def context(spec, workload, seed, seconds, trace, device="cuda") -> Ctx:
    cell = cell_of(spec, workload)
    return Ctx(workload, load(f"configs/{cell['config']}.json"),
               load(f"traffic/{cell['traffic']}.json"),
               load(f"limits/{workload}.json"), int(seed), float(seconds),
               bool(trace), device, T0)


def metrics_of(spec, section: str, workload: str):
    """The metrics of ``section`` that the cell reports."""
    return [m for m in spec[section]
            if "workloads" not in m or workload in m["workloads"]]


def reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    mod_spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def nvidia_smi() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unreadable"


def execute(ctx: Ctx, spec: Dict[str, Any]) -> Dict[str, Any]:
    """Run the cell's generator and compose the result line (a dict)."""
    import torch
    generator = importlib.import_module(
        f"benchmark.generators.{ctx.traffic['generator']}")
    with contextlib.redirect_stdout(sys.stderr):
        res = generator.run(ctx)
    checks = res["checks"]
    correct = bool(checks) and all(v <= lim for _, v, lim in checks)
    metrics = {}
    if ctx.trace:
        reading = dict(res["reading"])
        for m in metrics_of(spec, "per_layer", ctx.workload):
            value = reader(m["name"])(reading)
            if value is None:
                print(f"benchmark: {m['name']}: nothing to read in this "
                      f"trace", file=sys.stderr)
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in metrics_of(spec, "end_to_end", ctx.workload):
            if m["name"] in res["e2e"]:
                metrics[m["name"]] = {"value": res["e2e"][m["name"]],
                                      "unit": m["unit"]}
    dev = torch.device(ctx.device)
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": 1, "memory_peak_bytes": int(res["memory_peak_bytes"])}
    line = {"correct": correct, "attempted": int(res["attempted"]),
            "failed": int(res["failed"]), "metrics": metrics,
            "device": device}
    if ctx.trace:
        device["busy_s"] = res["reading"]["trace"]["busy_s"]
        device["window_s"] = res["reading"]["trace"]["window_s"]
        line["breakdown"] = res["reading"]["trace"]["breakdown"]
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in checks}
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "apnerf_torch")):
        print("benchmark: the program (apnerf_torch) is not beside the "
              "benchmark", file=sys.stderr)
        return 2
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"
    # one process, few host threads: the host's part of a step or a frame
    # then waits on no other thread of ours
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    import torch
    spec = bench_spec()
    cell = cell_of(spec, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); {torch.cuda.device_count()} available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"benchmark: {args.workload} seed {args.seed} on "
          f"{nvidia_smi()}", file=sys.stderr)
    ctx = context(spec, args.workload, args.seed, args.seconds, args.trace)
    line = execute(ctx, spec)
    found = loaded_forbidden()
    if found:
        print(f"benchmark: loaded {found}: the benchmark and the program "
              f"must not load JAX or the JAX package", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
