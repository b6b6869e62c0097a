"""``BENCHMARK.json`` against the benchmark's contract, and the harness
finding a new configuration, traffic mix, limit file and metric by name
alone."""
import json
import os
import re
import shutil
import subprocess
import sys

from benchmark import run as bench

ROOT = bench.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def spec():
    return bench.bench_spec()


def test_top_level_and_names():
    s = spec()
    assert set(s) == KEYS
    assert s["paths"] == ["benchmark"]
    assert 1 <= s["run_seconds"] <= 51
    assert s["command"][:3] == ["python3", "-m", "benchmark.run"]
    names = [c["name"] for c in s["configs"]] + \
        [w["name"] for w in s["workloads"]] + \
        [m["name"] for m in s["end_to_end"] + s["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert json.load(open(os.path.join(ROOT, c["file"])))["reduced"] \
            == c["reduced"]
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_every_cell_and_metric_has_its_files():
    s = spec()
    e2e = {m["name"] for m in s["end_to_end"]}
    assert "setup_s" in e2e
    pairs = set()
    for w in s["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        pairs.add((w["config"], w["traffic"]))
        ctx = bench.context(s, w["name"], 1, 1.0, False)
        assert os.path.isfile(os.path.join(
            bench.HERE, "generators", ctx.traffic["generator"] + ".py"))
        reported = {m["name"] for m in bench.metrics_of(s, "end_to_end",
                                                        w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        assert bench.metrics_of(s, "per_layer", w["name"])
    assert len(pairs) == len(s["workloads"])
    for m in s["per_layer"]:
        assert m["moves"] in e2e
        assert callable(bench.reader(m["name"]))
        for w in m.get("workloads", []):
            assert m["moves"] in {x["name"] for x in bench.metrics_of(
                s, "end_to_end", w)}


def test_a_new_cell_is_found_without_an_edit(tmp_path):
    """A dummy configuration, traffic mix, limit file and per-layer metric
    added as files and entries in a copy: the harness there runs the new
    cell (on the CPU, at a tiny size) and reads the new metric."""
    copy = tmp_path / "checkout"
    shutil.copytree(bench.HERE, copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(ROOT, "apnerf_torch"), copy / "apnerf_torch")
    s = spec()
    b = copy / "benchmark"
    cfg = json.load(open(b / "configs" / "dnerf.json"))
    cfg["name"] = "dummy"
    json.dump(cfg, open(b / "configs" / "dummy.json", "w"))
    traffic = json.load(open(b / "traffic" / "stage2-train.json"))
    traffic["log_every"] = 2
    json.dump(traffic, open(b / "traffic" / "dummy-mix.json", "w"))
    shutil.copy(b / "limits" / "dnerf-stage2-train.json",
                b / "limits" / "dummy-cell.json")
    (b / "metrics" / "dummy_ms.train.py").write_text(
        "def read(r):\n    return 1e3 * r['unit_s']\n")
    s["configs"].append({"name": "dummy", "source": "https://example.org",
                         "file": "benchmark/configs/dummy.json",
                         "reduced": [], "why": "a test"})
    s["workloads"].append({"name": "dummy-cell", "config": "dummy",
                           "traffic": "dummy-mix", "chips": 1,
                           "why": "a test"})
    for m in s["end_to_end"]:
        if "workloads" in m and m["name"] == "train_step_ms":
            m["workloads"].append("dummy-cell")
    s["per_layer"].append({"name": "dummy_ms.train", "unit": "ms",
                           "better": "lower", "source": "device_trace",
                           "layer": "device", "moves": "train_step_ms",
                           "workloads": ["dummy-cell"]})
    json.dump(s, open(copy / "BENCHMARK.json", "w"))
    code = """
import json
from benchmark import run as bench
from benchmark.tests.tiny import tiny_config
spec = bench.bench_spec()
out = {}
for trace in (False, True):
    ctx = bench.context(spec, "dummy-cell", 5, 0.2, trace, device="cpu")
    ctx.config = tiny_config(ctx.config)
    ctx.traffic.update(warmup_steps=4, trace_steps=2)
    out[str(trace)] = bench.execute(ctx, spec)
print(json.dumps(out))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=copy,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["False"]["correct"]
    assert set(out["False"]["metrics"]) == {"train_step_ms", "setup_s"}
    assert "dummy_ms.train" in out["True"]["metrics"]
