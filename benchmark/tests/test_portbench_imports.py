"""What the benchmark loads: never JAX, jaxlib, flax or the JAX package
(compared by whole top-level names), and its reference nothing of the
program; and a run without a card, or without the program beside it,
prints no result."""
import os
import shutil
import subprocess
import sys

from benchmark import run as bench

HARNESS = """
import glob, os, sys
import benchmark.run, benchmark.calibrate, benchmark.scene, benchmark.trace
import benchmark.work
import benchmark.generators.common, benchmark.generators.stage2_train
import benchmark.generators.repose, benchmark.generators.render_test
import benchmark.generators.stage1_train, benchmark.reference.stage1
import benchmark.reference.stage2, benchmark.reference.render
from benchmark import run
for f in glob.glob(os.path.join(run.HERE, "metrics", "*.py")):
    run.reader(os.path.basename(f)[:-3])
import apnerf_torch.train.stage2, apnerf_torch.render.renderers
import apnerf_torch.cli
print(sorted({m.split(".")[0] for m in sys.modules}))
"""

REFERENCE = """
import sys
import benchmark.reference.stage2, benchmark.reference.render
import benchmark.scene, benchmark.work, benchmark.trace
print(sorted({m.split(".")[0] for m in sys.modules}))
"""


def loaded(code):
    res = subprocess.run([sys.executable, "-c", code], cwd=bench.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return set(eval(res.stdout.strip().splitlines()[-1]))


def test_harness_and_program_load_no_jax():
    tops = loaded(HARNESS)
    assert "apnerf_torch" in tops and "benchmark" in tops
    assert not tops & set(bench.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    tops = loaded(REFERENCE)
    assert "apnerf_torch" not in tops
    assert not tops & set(bench.FORBIDDEN)


def test_the_guard_compares_whole_names(monkeypatch):
    before = set(bench.loaded_forbidden())
    monkeypatch.setitem(sys.modules, "apnerf_torch_like", sys)
    monkeypatch.setitem(sys.modules, "apnerfx.models", sys)
    assert set(bench.loaded_forbidden()) == before
    monkeypatch.setitem(sys.modules, "apnerf.models", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert {"apnerf", "jaxlib"} <= set(bench.loaded_forbidden())


def run_bench(cwd):
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "dnerf-stage2-train", "--seed", "4294967311", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300)


def test_no_result_without_a_card():
    """Here there is no CUDA device: exit 2, nothing on standard output.
    (Skipped where there is one.)"""
    import torch
    if torch.cuda.is_available():
        return
    res = run_bench(bench.ROOT)
    assert res.returncode == 2 and res.stdout == ""


def test_no_result_beside_nothing_but_the_benchmark(tmp_path):
    shutil.copytree(bench.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(bench.ROOT, "BENCHMARK.json"), tmp_path)
    res = run_bench(tmp_path)
    assert res.returncode != 0 and res.stdout == ""
