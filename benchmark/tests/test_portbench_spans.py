"""The readers of the program's own record (``benchmark/spans.py`` and
the five metrics that read it) on a hand-made record, and a tiny traced
run of a stage-2 cell on the CPU, whose result line carries the span and
counter metrics of its cell."""
from unittest import mock

import pytest

from benchmark import run as bench
from benchmark import spans
from benchmark.tests.tiny import tiny_context

MS = 1_000_000


def span(sid, name, start_ms, end_ms, attr=None, parent=None, **extra):
    return dict(name=name, start_ns=int(start_ms * MS),
                end_ns=int(end_ms * MS), id=sid, parent=parent, unit=None,
                attr=attr, **extra)


RECORD = {
    "spans": [
        span(0, "stage2.draw", 0, 1.5), span(1, "step.load", 1.5, 1.75),
        span(2, "step.prepare", 1.75, 2.0),
        span(3, "graph.replay", 2, 2.5, ()), span(4, "stage2.log", 2.5, 4.5),
        span(5, "stage2.draw", 5, 6), span(6, "stage1.segment", 6, 9),
        span(7, "graph.capture", 6.5, 8.5, (), parent=6),
        span(10, "render.frame", 10, 50),
        span(11, "render.pose", 10.25, 10.75, parent=10),
        span(12, "graph.replay", 11, 11.5, ("frame", (24, 4)), parent=10,
             device_ms=1.25),
        span(13, "graph.replay", 11.5, 12, ("scan", 1), parent=10,
             device_ms=30.0),
        span(14, "render.readback", 12, 12.5, parent=10),
        span(15, "render.wait", 20, 45, parent=10),
        span(16, "render.host_copy", 45, 46, parent=10),
        span(17, "render.finish", 46, 48, parent=10),
    ],
    "counters": {"budget.train.pass_demand": 300,
                 "budget.train.pass_budget": 400,
                 "budget.render.pass_demand": 50,
                 "budget.render.pass_budget": 200},
    "dropped": 0}
EMPTY = {"spans": [], "counters": {}, "dropped": 0}


def read(name, record, units=2):
    from apnerf_torch.utils import profiling
    with mock.patch.object(profiling, "record", lambda: record):
        return bench.reader(name)({"trace": {"units": units}})


@pytest.mark.parametrize("name,value", [
    ("host_ms.train", (1.5 + 0.25 + 0.25 + 2 + 1 + 1) / 2),
    ("host_ms.render", (0.5 + 0.5 + 1 + 2) / 2),
    ("frame_graph_ms.render", 1.25 / 2), ("budget_fill.train", 75.0),
    ("budget_fill.render", 25.0)])
def test_readers_of_the_record(name, value):
    assert read(name, RECORD) == pytest.approx(value)
    assert read(name, EMPTY) is None


def test_self_time_leaves_out_the_spans_inside():
    """A span's self time is its own less the spans opened inside it; the
    launches and the wait on the device are no host work of the loops."""
    assert spans.self_ms(RECORD, ("stage1.segment",)) == pytest.approx(1)
    assert spans.self_ms(RECORD, ("render.frame",)) == pytest.approx(
        40 - 0.5 - 0.5 - 0.5 - 0.5 - 25 - 1 - 2)
    assert spans.self_ms(RECORD, ("graph.capture",)) == pytest.approx(2)
    assert spans.self_ms(RECORD, ("render.wait",)) == pytest.approx(25)
    assert spans.self_ms(EMPTY, ("render.wait",)) is None


def test_readers_without_the_recorder():
    """A program whose profiling module has no ``record`` (the parent of
    the recorder) gives nothing to read, and no reader raises."""
    from apnerf_torch.utils import profiling
    with mock.patch.object(profiling, "record", None):
        for name in ("host_ms.train", "budget_fill.render"):
            assert bench.reader(name)({"trace": {"units": 1}}) is None


def test_tiny_traced_stage2_run_reads_spans_and_counters():
    from apnerf_torch.utils import profiling
    profiling.reset()
    spec, ctx = tiny_context("dnerf-stage2-train", trace=True)
    line = bench.execute(ctx, spec)
    assert line["correct"], line["checks"]
    m = line["metrics"]
    for name in ("host_ms.train", "budget_fill.train"):
        assert m[name]["value"] > 0, name
    assert m["host_ms.train"]["value"] < 1e3 * line["device"]["window_s"]
    assert 0 < m["budget_fill.train"]["value"] <= 100
