"""The port's span and counter recorder (``apnerf_torch.utils.profiling``)
inside its loops, graph calls and frame path, on the CPU.

- Off (no profiler, no ``enable()``): a tiny ``train_pcd``,
  ``scene_rep_reconstruction`` and repose frame leave the record empty.
- With ``enable()``: each per-step and per-frame span appears once a
  unit, with its parent and the unit's id; a frame read back after the
  next one was queued (``render_viewpoints``) keeps its own spans.
- Under ``torch.profiler`` on the CPU: the mirrored spans are the
  profiler's events of the same names, nested as the record says, and the
  record's timestamps lie within ``CLOCK_TOL_NS`` of their events' (both
  on CLOCK_REALTIME); the spans that launch are not mirrored.
- The counters: the render's equals the sums of the fill of the
  budget-audit rows that its frames read back, the training's the sums
  of the steps' fill outputs.
"""
import numpy as np
import pytest
import torch

from apnerf_torch.data.synthetic import make_scene
from apnerf_torch.models import temporal_points as tp
from apnerf_torch.render import render as trender
from apnerf_torch.render import renderers as trenderers
from apnerf_torch.train import stage1 as ts1
from apnerf_torch.train import stage2 as ts2
from apnerf_torch.utils import profiling
from test_torch_render import _cameras
from test_torch_stage1 import _tiny_cfg
from test_torch_temporal_points import MODES, port_model, scene  # noqa
from torch_stage2_scene import artifacts, backbone, config

H, W = 12, 16
CLOCK_TOL_NS = 25_000_000    # an event against its span: the same clock
BBOX = (np.full(3, -1.5), np.full(3, 1.5))
STEPS = 3


@pytest.fixture(autouse=True)
def recorder():
    """An empty record, the recorder off, before and after each test."""
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


@pytest.fixture(scope="module")
def stage2_setup():
    cfg = config(active_fraction=1.0, pass_fraction=0.5)
    cfg.pcd_train_config.update(N_rand=64, full_t_iter=6)
    canonical, skeleton = artifacts()
    _, tcfg, heads = backbone()
    return cfg, make_scene(3, 32, 32, seed=0), canonical, skeleton, heads, \
        tcfg


def run_stage2(setup, monkeypatch=None, rows=None):
    """``STEPS`` steps of ``train_pcd``, logged at step 2 and 3; ``rows``
    receives each step's budget fill (its third output)."""
    if rows is not None:
        real = ts2.make_graphed_step

        def make(*args, **kw):
            step = real(*args, **kw)

            def call(batch):
                out = step(batch)
                rows.append(out[2].clone())
                return out
            return call
        monkeypatch.setattr(ts2, "make_graphed_step", make)
    cfg, data, canonical, skeleton, heads, tcfg = setup
    ts2.train_pcd(cfg, data, canonical, skeleton, heads, tcfg, BBOX, seed=0,
                  n_iters=STEPS, log_every=2, sample_budget=32, device="cpu")


def run_stage1():
    """Four steps of ``scene_rep_reconstruction``: a ``pg_scale`` rebuild
    at step 2, the occupancy switch at step 3 (a new segment and a
    refresh), a refresh at step 4, logged at steps 2 and 4."""
    cfg = _tiny_cfg()
    cfg.train_config.update(pg_scale=[2], occupancy_start=3,
                            occupancy_update_every=4)
    ts1.scene_rep_reconstruction(cfg, make_scene(3, 24, 24, seed=0), seed=0,
                                 n_iters=4, log_every=2, device="cpu")


def repose(scene, n=2, rows=None):
    """``n`` repose frames through ``render_image``, each a new pose;
    ``rows`` receives the budget-audit rows each frame read back."""
    poses, Ks, _ = _cameras(1)
    model, state = port_model(dict(MODES["shared8_cand8"], pass_fraction=0.3),
                              scene)
    renderer = trenderers.make_points_renderer(model, state, 0.5, 6.0, 1.0,
                                               poses=poses, Ks=Ks)
    rng = np.random.default_rng(0)
    for _ in range(n):
        rot = (rng.normal(size=(model.cfg.n_joints, 4)) * 0.2).astype(
            np.float32)
        rot[0] = 0.0
        view = renderer(0, None, rot_params=rot)
        if rows is not None:
            real = view.finish

            def finish(image=None, _real=real):
                rows.append(np.array(image["budget_audit"]))
                return _real(image)
            view.finish = finish
        trender.render_image(view, Ks[0], poses[0], H, W, chunk=96,
                             device="cpu")


def by_unit(rec):
    out = {}
    for s in rec["spans"]:
        out.setdefault(s["unit"], []).append(s)
    return out


@pytest.mark.parametrize("path", ["stage2", "stage1", "repose"])
def test_recorder_off_leaves_the_record_empty(path, stage2_setup, scene):
    if path == "stage2":
        run_stage2(stage2_setup)
    elif path == "stage1":
        run_stage1()
    else:
        repose(scene)
    assert not profiling.on()
    rec = profiling.record()
    assert rec == {"spans": [], "counters": {}, "dropped": 0}


def test_stage2_spans_once_a_step(stage2_setup):
    profiling.enable()
    run_stage2(stage2_setup)
    units = by_unit(profiling.record())
    assert sorted(units) == [("stage2", i) for i in range(1, STEPS + 1)]
    for (_, step), spans in units.items():
        names = [s["name"] for s in spans]
        want = ["stage2.draw", "step.load", "step.prepare", "graph.replay"]
        assert names == want + (["stage2.log"] if step >= 2 else [])
        # the loop's spans are the step's top level
        assert all(s["parent"] is None for s in spans)
        assert spans[3]["attr"] == ()
        assert all(s["start_ns"] <= s["end_ns"] for s in spans)
        assert all(a["end_ns"] <= b["start_ns"]
                   for a, b in zip(spans, spans[1:]))


def test_stage1_spans_once_a_step():
    profiling.enable()
    run_stage1()
    units = by_unit(profiling.record())
    assert sorted(units) == [("stage1", i) for i in range(1, 5)]
    names = {step: [s["name"] for s in spans]
             for (_, step), spans in units.items()}
    common = ["stage1.draw", "step.load", "step.prepare", "graph.replay"]
    assert names[1] == common
    assert names[2] == ["stage1.segment"] + common + ["stage1.log"]
    assert names[3] == ["stage1.segment", "stage1.occupancy"] + common
    assert names[4] == ["stage1.occupancy"] + common + ["stage1.log"]
    replays = [s for s in profiling.record()["spans"]
               if s["name"] == "graph.replay"]
    # the graph's key: the TV switches (feature TV dense before step 3)
    assert [s["attr"] for s in replays] == [(True, i < 3) for i in range(1, 5)]


FRAME = ["render.pose", "graph.replay", "graph.replay", "render.readback",
         "render.wait", "render.host_copy", "render.finish"]


def check_frames(rec, n):
    units = by_unit(rec)
    assert sorted(units) == [("frame", i) for i in range(n)]
    for spans in units.values():
        frame = [s for s in spans if s["name"] == "render.frame"]
        assert len(frame) == 1
        inner = sorted((s for s in spans if s is not frame[0]),
                       key=lambda s: s["start_ns"])
        assert [s["name"] for s in inner] == FRAME
        assert all(s["parent"] == frame[0]["id"] for s in inner)
        assert all(frame[0]["start_ns"] <= s["start_ns"] <= s["end_ns"]
                   <= frame[0]["end_ns"] for s in inner)
        assert inner[1]["attr"] == ("frame", (6, 4))
        assert inner[2]["attr"][0] == "scan"


def test_frame_spans_once_a_frame(scene):
    profiling.enable()
    repose(scene, n=3)
    check_frames(profiling.record(), 3)


def test_queued_frames_keep_their_spans(scene):
    """``render_viewpoints`` queues view i + 1 before it reads view i
    back: each frame's spans stay under its own frame span."""
    poses, Ks, HW = _cameras(3)
    model, state = port_model(MODES["shared8_cand8"], scene)
    view = trenderers.make_points_renderer(model, state, 0.5, 6.0, 1.0,
                                           poses=poses, Ks=Ks)
    profiling.enable()
    trender.render_viewpoints(view, poses, HW, Ks, [0.0, 0.5, 1.0],
                              chunk=96, verbose=False, device="cpu")
    rec = profiling.record()
    frames = [s for s in rec["spans"] if s["name"] == "render.frame"]
    # frame 1 was opened before frame 0 was read back
    assert frames[0]["unit"] == ("frame", 0)
    spans = {s["unit"]: s for s in frames}
    assert spans[("frame", 1)]["start_ns"] < spans[("frame", 0)]["end_ns"]
    for s in rec["spans"]:
        if s["name"] == "graph.replay" and s["attr"][0] == "frame":
            assert s["attr"] == ("frame", None)     # a time, not a pose
    units = by_unit(rec)
    for spans in units.values():
        frame = next(s for s in spans if s["name"] == "render.frame")
        assert sorted(s["name"] for s in spans if s is not frame) == \
            sorted(FRAME)
        assert all(s["parent"] == frame["id"] for s in spans
                   if s is not frame)


def test_mirrored_spans_share_the_profiler_clock(stage2_setup, scene):
    """Under ``torch.profiler``: each mirrored span (the batch draw, the
    frame's wait, host copy and finish) is an event of its name whose
    start and end lie within ``CLOCK_TOL_NS`` of the record's, and the
    events nest as the record's spans do; a span that launches (the
    replay, the static-input copies) is in the record but not among the
    events."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.scope("outer", mirror=True):
            with profiling.scope("inner", mirror=True):
                pass
        run_stage2(stage2_setup)
        repose(scene, n=1)
    assert not profiling.on()
    rec = profiling.record()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    events = {}
    for e in prof.events():
        events.setdefault(e.name, []).append(e)
    names = {s["name"] for s in rec["spans"]}
    assert {"stage2.draw", "render.wait", "render.host_copy",
            "render.finish", "graph.replay", "step.load",
            "render.frame"} <= names
    for name in ("graph.replay", "step.load", "step.prepare", "render.frame",
                 "render.pose", "render.readback"):
        assert name not in events, name
    for name in ("outer", "inner", "stage2.draw", "render.wait",
                 "render.host_copy", "render.finish"):
        spans = [s for s in rec["spans"] if s["name"] == name]
        evs = sorted(events[name], key=lambda e: e.time_range.start)
        assert len(evs) == len(spans), name
        for s, e in zip(spans, evs):
            e0 = start_ns + 1e3 * e.time_range.start
            e1 = start_ns + 1e3 * e.time_range.end
            assert abs(e0 - s["start_ns"]) < CLOCK_TOL_NS, name
            assert abs(e1 - s["end_ns"]) < CLOCK_TOL_NS, name
            assert s["start_ns"] <= e0 + 1e3 and e1 <= s["end_ns"] + 1e3
    outer, inner = (next(s for s in rec["spans"] if s["name"] == n)
                    for n in ("outer", "inner"))
    assert inner["parent"] == outer["id"]
    assert events["inner"][0].cpu_parent.name == "outer"
    # the finish's projection runs inside its span
    assert any(e.cpu_parent is not None
               and e.cpu_parent.name == "render.finish"
               for e in prof.events() if e.name.startswith("aten::"))


def test_render_counter_is_the_rows_read_back(scene):
    profiling.enable()
    rows = []
    repose(scene, n=3, rows=rows)
    r = np.concatenate(rows)
    assert len(r) == 3 * -(-H * W // 96)
    assert (r[:, 2] > r[:, 3]).any()       # the pass budget truncates
    want = {"budget.render.active_demand": np.minimum(r[:, 0], r[:, 1]),
            "budget.render.active_budget": r[:, 1],
            "budget.render.pass_demand": np.minimum(r[:, 2], r[:, 3]),
            "budget.render.pass_budget": r[:, 3]}
    assert profiling.record()["counters"] == {k: int(v.sum())
                                              for k, v in want.items()}


def test_training_counter_is_the_steps_rows(stage2_setup, monkeypatch):
    """The step's output is the fill of its audit row (min(demand,
    budget) and the budget, twice), and the counters are their sums."""
    profiling.enable()
    rows = []
    run_stage2(stage2_setup, monkeypatch, rows)
    r = torch.stack(rows).numpy()
    assert r.shape == (STEPS, 4)
    assert (r[:, 0] <= r[:, 1]).all() and (r[:, 2] <= r[:, 3]).all()
    assert (r[:, 2] < r[:, 3]).any()
    want = dict(zip(ts2.BUDGET_COUNTERS, r.sum(0).tolist()))
    assert profiling.record()["counters"] == want


def test_budget_fill_of_audit_rows():
    rows = torch.tensor([[5, 8, 30, 20], [9, 8, 10, 20], [0, 8, 0, 20]])
    assert tp.budget_fill(rows).tolist() == [13, 24, 30, 60]
    assert tp.budget_fill(rows[0]).tolist() == [5, 8, 20, 20]
    assert tp.budget_fill(torch.zeros((0, 4))).tolist() == [0, 0, 0, 0]
