"""The one-dispatch training step of the port (``utils/graphs.GraphedStep``
under ``train/stage1.make_graphed_step`` and ``train/stage2.
make_graphed_step``, the counterparts of the JAX package's jitted steps)
on the CPU, where the bodies that a CUDA device captures run eagerly.

- One update on the first call: with the card's stream and graph calls
  stood in for (a capture runs the body with its effects undone, a replay
  runs the captured body into the captured outputs), the first call is
  the step run eagerly and later calls replay; the parameters follow the
  eager step's exactly, and the launches are counted once a step.
- No baked-in value: after one step, the stage-1 (dense and occupancy)
  and stage-2 bodies make no host tensor and read nothing back.
- Every per-step value comes from the static inputs: two steps of one
  stage-2 step object, with other times, sparsity switches, batches and
  step sizes, equal two freshly built step objects bit for bit.
- Masked Adam: ``advance`` + ``apply`` (the step sizes in a static vector)
  bit-equal to the update before the step was split, over 5 steps with a
  frozen key and a ``skip_zero_grad_fields`` key, and within
  ``test_masked_adam_vs_jax``'s tolerance of the JAX optimizer.
- Stage-1 segments: a ``scene_rep_reconstruction`` with a pg_scale
  rebuild, the occupancy switch, a refresh and ``step_to_half`` inside the
  run against the JAX package's (``test_scene_rep_reconstruction_vs_jax``'s
  tolerance); the occupancy grid a segment reads keeps its storage across
  the refresh and holds the new grid.
- The TV switches: in each of the four settings of ``tv_on`` /
  ``tv_dense``, the graphed body's feature gradient bit-equal to the
  branch the step took before it was graphed.
"""
from contextlib import contextmanager

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apnerf.train import masked_adam as jadam
from apnerf.train import stage1 as js1
from apnerf_torch import kernels
from apnerf_torch.data.synthetic import make_scene
from apnerf_torch.models import tineuvox as tt
from apnerf_torch.ops import grid as tgrid
from apnerf_torch.train import stage1 as ts1
from apnerf_torch.train import stage2 as ts2
from apnerf_torch.train.masked_adam import MaskedAdam
from apnerf_torch.utils import checkpoint as tck
from test_torch_image_scan import _recorded
from test_torch_stage1 import _Toy, _tree_np, _port_model, _tiny_cfg
from torch_stage2_scene import (artifacts, backbone, batch_arrays,  # noqa
                                camera, config, H, W, NEAR, FAR)

S1 = 24                 # the stage-1 scene's image size


@pytest.fixture(scope="module")
def scene():
    return make_scene(3, S1, S1, seed=0)


def _stage1(scene, seed=1):
    """(model, config, train config, Ks, poses) of the tiny stage-1 setup
    (``_tiny_cfg``: TV on the feature grid), the model from the JAX
    initialisers."""
    import apnerf.models.tineuvox as jt
    cfg = _tiny_cfg()
    lo, hi = ts1.compute_bbox_by_cam_frustrm(
        scene["HW"], scene["Ks"], scene["poses"], scene["i_train"],
        scene["img_to_cam"], scene["near"], scene["far"])
    m = cfg.model_and_render
    jcfg = jt.TiNeuVoxConfig(
        xyz_min=tuple(lo), xyz_max=tuple(hi), num_voxels=m.num_voxels,
        num_voxels_base=m.num_voxels_base, voxel_dim=m.voxel_dim,
        defor_depth=m.defor_depth, net_width=m.net_width)
    model = _port_model(jt.init_params(jax.random.PRNGKey(seed), jcfg), jcfg)
    ct = dict(cfg.train_config, _stepsize=m.stepsize)
    return model, jcfg, ct, torch.tensor(scene["Ks"]), \
        torch.tensor(scene["poses"])


def _stage1_batches(scene, jcfg, n, seed=0):
    from apnerf_torch.data import rays as trays
    idx = trays.build_ray_index(
        list(scene["images"]), list(scene["masks"]), scene["times"],
        scene["img_to_cam"], scene["poses"], scene["Ks"], S1, S1,
        np.asarray(jcfg.xyz_min), np.asarray(jcfg.xyz_max), scene["near"],
        scene["far"], device="cpu")
    gen = trays.batch_index_generator(idx.n, 64, seed)
    out = []
    for _ in range(n):
        rgb, m, t, cam, pix = idx.gather(next(gen))
        out.append({"rgb": rgb, "mask": m, "time": t, "cam": cam,
                    "pix": pix})
    return out


def _tensors(batch):
    """A host batch as the eager step takes it."""
    return {k: (torch.as_tensor(np.asarray(v)).long()
                if k in ("cam", "pix", "chamfer_pcd_idx")
                else torch.as_tensor(np.asarray(v, np.float32)))
            for k, v in batch.items()}


def _occupancy(jcfg):
    flags = torch.zeros(jcfg.world_size, dtype=torch.bool)
    flags[2:-2, 2:-2, 2:-2] = True
    return flags


@pytest.fixture
def deterministic():
    """PyTorch's deterministic CPU kernels, for the tests that hold two
    runs of a step bit-equal: the threads of an accumulating index_put_
    (the backward of a gather) otherwise add in another order each run,
    and two runs of one step differ in the last bits."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def _same_params(a, b):
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n


# ---------------------------------------------------------------------------
# One update on the first call (the card's graph calls stood in for)
# ---------------------------------------------------------------------------

class FakeStream:
    def wait_stream(self, other):
        pass


class FakeGraph:
    """A CUDA graph on the CPU. A replay runs the body of the call it was
    captured for (``call``) and writes the results into the call's
    captured outputs, the launches its wrappers count taken back
    (``GraphReplay`` adds those the capture counted)."""

    def __init__(self):
        self.replays = 0
        self.call = None

    def replay(self):
        self.replays += 1
        with kernels.counted_capture():
            _copy_into(self.call.out, self.call.body())


def _copy_into(dst, src):
    if torch.is_tensor(dst):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, (tuple, list)):
        for a, b in zip(dst, src):
            _copy_into(a, b)


@contextmanager
def fake_card(monkeypatch, state):
    """torch.cuda's streams and graphs stood in for: a capture runs the
    body, then puts back the tensors of ``state`` (the parameters and the
    moments), since a capture launches nothing."""
    graphs_made = []

    @contextmanager
    def capture(graph, pool=None):
        saved = [t.detach().clone() for t in state]
        yield
        with torch.no_grad():
            for t, v in zip(state, saved):
                t.copy_(v)

    def new_graph():
        graphs_made.append(FakeGraph())
        return graphs_made[-1]

    @contextmanager
    def on_stream(stream):
        yield

    monkeypatch.setattr(torch.cuda, "Stream", FakeStream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", on_stream)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", new_graph)
    monkeypatch.setattr(torch.cuda, "graph", capture)
    yield graphs_made


def test_first_call_takes_one_update(scene, monkeypatch, deterministic):
    """A stage-1 occupancy segment through the stand-in graph calls
    against the eager step on a twin model: every call's loss and the
    parameters after it bit-equal, the optimizer's count one a call, one
    capture and a replay from the second call on, and kernel K5 (its
    plain version, counted here) counted as often a step either way."""
    model, jcfg, ct, Ks, poses = _stage1(scene)
    twin, _, _, _, _ = _stage1(scene)
    budget, _ = ts1.active_budget(64, jcfg.max_steps(0.5), 0.25)
    occ = _occupancy(jcfg)
    opt, topt = MaskedAdam(model, ct), MaskedAdam(twin, ct)
    step = ts1.make_graphed_step(model, ct, opt, Ks, poses, S1, S1,
                                 scene["near"], scene["far"], 1.0, 64,
                                 active_budget=budget,
                                 occ_shape=jcfg.world_size)
    step.graphs.pool = "pool"           # the card's path
    step.inputs["occ"].copy_(occ)
    eager = ts1.make_train_step(twin, ct, topt, Ks, poses, S1, S1,
                                scene["near"], scene["far"], 1.0,
                                active_budget=budget)
    real = tgrid.sorted_window_accumulate

    def counted(*args, **kw):
        kernels.LAUNCHES["scatter"] += 1
        return real(*args, **kw)

    monkeypatch.setattr(tgrid, "sorted_window_accumulate", counted)
    state = list(model.parameters()) + list(opt.mu.values()) + \
        list(opt.nu.values())
    with fake_card(monkeypatch, state) as made:
        for i, b in enumerate(_stage1_batches(scene, jcfg, 4)):
            kernels.reset_launches()
            loss, mse, _ = step(b, (True, i < 2))
            n_graphed = kernels.LAUNCHES["scatter"]
            # each graph replays the call it was captured for
            for graph, call in zip(made, step.graphs.calls.values()):
                graph.call = call
            if i == 0:
                assert len(made) == 1 and made[0].replays == 0
            kernels.reset_launches()
            eloss, emse = eager(_tensors(b), True, occ, i < 2)
            assert kernels.LAUNCHES["scatter"] == n_graphed > 0
            assert torch.equal(loss, eloss) and torch.equal(mse, emse), i
            assert opt.count == topt.count == i + 1
            _same_params(model, twin)
            for n in opt.mu:
                assert torch.equal(opt.mu[n], topt.mu[n]), n
    # steps 3 and 4 took the sparse TV: a second key, captured at its
    # first call (step 3), replayed at step 4
    assert len(made) == 2
    assert [g.replays for g in made] == [1, 1]
    assert sorted(step.graphs.calls) == [(True, False), (True, True)]
    kernels.reset_launches()


# ---------------------------------------------------------------------------
# No baked-in value
# ---------------------------------------------------------------------------

def _stage2_setup(**over):
    cfg = config(sample_budget=32, **over)
    canonical, skeleton = artifacts()
    _, tcfg, heads = backbone()
    mcfg, model, state = ts2.build_model(cfg, canonical, skeleton, heads,
                                         tcfg, device="cpu")
    K, pose = camera()
    return cfg, mcfg, model, state, torch.tensor(K), torch.tensor(pose)


def _stage2_step(cfg, model, state, K, pose, opt=None):
    opt = opt or MaskedAdam(model, cfg.pcd_train_config)
    return ts2.make_graphed_step(model, state, cfg.pcd_train_config, opt, K,
                                 pose, H, W, NEAR, FAR, 1.0, 1, 128), opt


def _stage2_batch(seed, t, sparsity_on):
    b = batch_arrays(n_chamfer=ts2.CH_M, n_pcd=ts2.CH_N, seed=seed)
    b.update(t=t, sparsity_on=sparsity_on)
    return b


@pytest.mark.parametrize("case", ["stage1 dense", "stage1 occupancy",
                                  "stage2"])
def test_step_bodies_make_no_host_copy(case, scene, monkeypatch):
    """After one step (the warm-up), the step body runs again while calls
    that make a host tensor or read a tensor back are recorded: there is
    none, so a capture on the card meets no host-to-device copy and no
    sync."""
    if case == "stage2":
        cfg, _, model, state, K, pose = _stage2_setup()
        step, _ = _stage2_step(cfg, model, state, K, pose)
        step(_stage2_batch(3, 0.3, 1.0))
        key = ()
    else:
        model, jcfg, ct, Ks, poses = _stage1(scene)
        occupancy = case == "stage1 occupancy"
        budget = (ts1.active_budget(64, jcfg.max_steps(0.5), 0.25)[0]
                  if occupancy else None)
        step = ts1.make_graphed_step(
            model, ct, MaskedAdam(model, ct), Ks, poses, S1, S1,
            scene["near"], scene["far"], 1.0, 64, active_budget=budget,
            occ_shape=jcfg.world_size if occupancy else None)
        if occupancy:
            step.inputs["occ"].copy_(_occupancy(jcfg))
        key = (True, True)
        step(_stage1_batches(scene, jcfg, 1)[0], key)
    calls = []
    body = step.graphs.calls[key].body
    _recorded(monkeypatch, calls)
    out = body()
    monkeypatch.undo()
    assert calls == []
    assert torch.isfinite(out[0]["loss"] if case == "stage2" else out[0])


# ---------------------------------------------------------------------------
# Every per-step value comes from the static inputs
# ---------------------------------------------------------------------------

def test_values_come_from_static_inputs(deterministic):
    """One stage-2 step object takes two steps whose time, sparsity
    switch, rays, chamfer views and Adam step size all differ; two
    freshly built step objects (the second built after the first's step)
    take the same two steps on a twin model: every metric, every gradient
    and the parameters after each step bit-equal."""
    cfg, _, model, state, K, pose = _stage2_setup()
    _, _, twin, tstate, _, _ = _stage2_setup()
    step, opt = _stage2_step(cfg, model, state, K, pose)
    topt = MaskedAdam(twin, cfg.pcd_train_config)
    batches = [_stage2_batch(3, 0.3, 0.0), _stage2_batch(4, 0.8, 1.0)]
    for i, b in enumerate(batches):
        got, ggrads, gaudit = step(b)
        fresh, _ = _stage2_step(cfg, twin, tstate, K, pose, topt)
        want, wgrads, waudit = fresh(b)
        assert torch.equal(gaudit, waudit), i
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (i, k)
        for n, g in wgrads.items():
            assert (g is None) == (ggrads[n] is None), n
            assert g is None or torch.equal(ggrads[n], g), (i, n)
        _same_params(model, twin)
    assert opt.count == topt.count == 2
    # the two steps did differ in what the static inputs carried
    assert not torch.equal(opt.step_sizes, torch.zeros_like(opt.step_sizes))
    assert float(step.inputs["t"]) == pytest.approx(0.8)
    assert float(step.inputs["sparsity_on"]) == 1.0


# ---------------------------------------------------------------------------
# Masked Adam: the split update against the one before it
# ---------------------------------------------------------------------------

def _update_before_the_split(opt, grads):
    """The masked-Adam update as it was before ``advance`` / ``apply``:
    the step size a host number, the moments bound anew."""
    opt.count += 1
    b1, b2, eps = opt.b1, opt.b2, opt.eps
    with torch.no_grad():
        for name, p in opt.params.items():
            key = name.split(".")[0]
            lr = opt.lrs[key]
            if lr == 0.0:
                continue
            step_size = float(opt._step_size(lr))
            g = grads.get(name)
            g = torch.zeros_like(p, dtype=torch.float32) if g is None \
                else g.float()
            m_old, v_old = opt.mu[name], opt.nu[name]
            m = b1 * m_old + (1 - b1) * g
            v = b2 * v_old + (1 - b2) * g * g
            delta = step_size * m / (torch.sqrt(v) + eps)
            p32 = p.float()
            if key in opt.skip_fields:
                keep = g == 0.0
                m = torch.where(keep, m_old, m)
                v = torch.where(keep, v_old, v)
                p_new = torch.where(keep, p32, p32 - delta)
            else:
                p_new = p32 - delta
            p.copy_(p_new)
            opt.mu[name], opt.nu[name] = m, v


def test_masked_adam_split_unchanged():
    """Five steps; ``feature`` skips zero-gradient entries, ``frozen`` has
    no lr, ``net.bias`` gets no gradient at step 2: the split update
    (static step sizes, moments in place) bit-equal to the update before
    the split, and within ``test_masked_adam_vs_jax``'s tolerance of the
    JAX optimizer (params 1e-6 / 1e-7, moments 1e-6 / 1e-12)."""
    rng = np.random.default_rng(1)
    tree = {"feature": rng.normal(size=(4, 5, 3)).astype(np.float32),
            "net": {"w": rng.normal(size=(3, 2)).astype(np.float32),
                    "b": rng.normal(size=(2,)).astype(np.float32)},
            "frozen": rng.normal(size=(6,)).astype(np.float32)}
    cfg_train = {"lrate_decay": 0.02, "lrate_feature": 0.08,
                 "lrate_net": 1e-3, "skip_zero_grad_fields": ["feature"]}
    jopt = jadam.create_optimizer(tree, cfg_train)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jopt.init(params)
    split, before = _Toy(tree), _Toy(tree)
    sopt, bopt = MaskedAdam(split, cfg_train), MaskedAdam(before, cfg_train)
    mu_ptr = {n: m.data_ptr() for n, m in sopt.mu.items()}
    for step in range(5):
        grads = jax.tree_util.tree_map(
            lambda x: rng.normal(size=x.shape).astype(np.float32) * 1e-3,
            tree)
        grads["feature"][rng.random(grads["feature"].shape) < 0.5] = 0.0
        tg = tck.params_from_jax(grads)
        if step == 1:
            grads["net"]["b"][:] = 0.0
            tg["net.bias"] = None           # no gradient reached it
        params, jstate = jopt.update(
            jax.tree_util.tree_map(jnp.asarray, grads), jstate, params)
        sopt.advance()
        sopt.apply(tg)
        _update_before_the_split(bopt, tg)
        assert sopt.count == bopt.count == int(jstate.count) == step + 1
        _same_params(split, before)
        for attr in ("mu", "nu"):
            for n, v in getattr(sopt, attr).items():
                assert torch.equal(v, getattr(bopt, attr)[n]), (step, n)
    assert {n: m.data_ptr() for n, m in sopt.mu.items()} == mu_ptr
    want = tck.params_from_jax(_tree_np(params))
    for n, p in split.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=n)
    np.testing.assert_array_equal(split.frozen.detach().numpy(),
                                  tree["frozen"])
    for attr in ("mu", "nu"):
        want = tck.params_from_jax(_tree_np(getattr(jstate, attr)))
        for n, v in getattr(sopt, attr).items():
            np.testing.assert_allclose(v.numpy(), want[n].numpy(),
                                       rtol=1e-6, atol=1e-12, err_msg=n)


# ---------------------------------------------------------------------------
# Stage-1 segments
# ---------------------------------------------------------------------------

def test_segments_vs_jax(scene, monkeypatch):
    """Eight steps: pg_scale [2] (a rebuild at step 2), occupancy from
    step 3, a refresh at step 5 (occupancy_update_every 5) and the
    feature grid cast to bf16 at step 7 (``step_to_half``): four segments
    after the first (five step objects), the logged losses against the
    JAX package's run at ``test_scene_rep_reconstruction_vs_jax``'s rtol
    1e-4; the occupancy segment's grid keeps its storage across the
    refresh and holds the refreshed grid, which the bf16 segment gets
    too. The tiny model's alpha stays above the threshold everywhere in
    eight steps, so in both packages the second refresh sees no alpha in
    the upper half of the grid: a grid unlike the first."""
    cfg = _tiny_cfg()
    cfg.train_config.update(pg_scale=[2], occupancy_start=3,
                            occupancy_update_every=5)

    def jax_init(mcfg, generator, device=None):
        import apnerf.models.tineuvox as jt
        jcfg = jt.TiNeuVoxConfig(**mcfg.get_kwargs())
        return _port_model(jt.init_params(jax.random.PRNGKey(3), jcfg),
                           jcfg).to(device)

    steps, grids, ptrs = [], [], []
    real_make, real_refresh = ts1.make_graphed_step, ts1.refresh_occupancy
    alpha_calls = {"jax": 0, "port": 0}

    def halved(alpha_volume, who):
        def alpha(*args, **kw):
            a = np.array(alpha_volume(*args, **kw))
            alpha_calls[who] += 1
            if alpha_calls[who] > 4:       # the second refresh's 4 times
                a[a.shape[0] // 2:] = 0.0
            return a
        return alpha

    def make(*args, **kw):
        steps.append(real_make(*args, **kw))
        return steps[-1]

    def refresh(*args, **kw):
        grids.append(real_refresh(*args, **kw))
        return grids[-1]

    def callback(step, model, mcfg, stats):
        occ = steps[-1].inputs.get("occ")
        ptrs.append((step, len(steps), None if occ is None
                     else occ.data_ptr()))

    monkeypatch.setattr(ts1.tineuvox, "init_model", jax_init)
    monkeypatch.setattr(ts1, "make_graphed_step", make)
    monkeypatch.setattr(ts1, "refresh_occupancy", refresh)
    for who, mod in (("jax", js1.tineuvox), ("port", ts1.tineuvox)):
        monkeypatch.setattr(mod, "eval_alpha_volume",
                            halved(mod.eval_alpha_volume, who))
    run = dict(seed=3, log_every=1, n_iters=8, step_to_half=7)
    _, _, jstats = js1.scene_rep_reconstruction(cfg, scene, **run)
    model, _, tstats = ts1.scene_rep_reconstruction(
        cfg, scene, device="cpu", callback=callback, **run)
    np.testing.assert_allclose(tstats["loss"], jstats["loss"], rtol=1e-4)
    assert model.feature.dtype == torch.bfloat16
    # segments: step 1, step 2 (rebuild), 3-6 (occupancy), 7-8 (bf16)
    assert [n for _, n, _ in ptrs] == [1, 2, 3, 3, 3, 3, 4, 4]
    assert len(grids) == 2                          # steps 3 and 5
    assert alpha_calls == {"jax": 8, "port": 8}
    occ_ptrs = {p for s, _, p in ptrs if 3 <= s <= 6}
    assert len(occ_ptrs) == 1                       # across the refresh
    assert not torch.equal(grids[0], grids[1])
    assert torch.equal(steps[2].inputs["occ"], grids[1])
    assert torch.equal(steps[3].inputs["occ"], grids[1])
    assert "occ" not in steps[0].inputs and "occ" not in steps[1].inputs


# ---------------------------------------------------------------------------
# The TV switches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tv_on,tv_dense", [(False, False), (False, True),
                                            (True, False), (True, True)])
def test_tv_switches(scene, tv_on, tv_dense, deterministic):
    """The graphed body's feature gradient (the one its update took) in
    one setting of the two switches, bit-equal to the branch the step
    took before it was graphed: the TV gradient added after the backward
    when ``tv_on``, only where the photometric gradient is nonzero unless
    ``tv_dense``."""
    model, jcfg, ct, Ks, poses = _stage1(scene)
    twin, _, _, _, _ = _stage1(scene)
    step = ts1.make_graphed_step(model, ct, MaskedAdam(model, ct), Ks, poses,
                                 S1, S1, scene["near"], scene["far"], 1.0,
                                 64)
    rng = np.random.default_rng(2)     # a grid with something to smooth
    grid = torch.as_tensor(rng.normal(size=tuple(model.feature.shape))
                           .astype(np.float32) * 0.1)
    with torch.no_grad():
        model.feature.copy_(grid)
        twin.feature.copy_(grid)
    b = _stage1_batches(scene, jcfg, 1)[0]
    _, _, grads = step(b, (tv_on, tv_dense))
    loss_fn = ts1.make_loss_fn(twin, ct, Ks, poses, S1, S1, scene["near"],
                               scene["far"], 1.0)
    loss, _ = loss_fn(_tensors(b), None)
    loss.backward()
    g = twin.feature.grad
    if ct["weight_tv_feature"] > 0 and tv_on:
        g = g + tt.feature_tv_grad(twin, ct["weight_tv_feature"] / 64, g,
                                   tv_dense)
    assert torch.equal(grads["feature"], g)
    assert tv_on == (not torch.equal(grads["feature"], twin.feature.grad))
