"""The port's renderers and command line on a mesh of gloo ranks spawned on
the CPU (the counterpart of tests/test_parallel_render.py).

* ``make_points_renderer(mesh=)`` (exact and shared k-NN, LBS-weight
  images, joints for the overlay) and ``make_backbone_renderer(mesh=)``:
  two views through the image function on 2 ranks, each rank rendering
  its chunks (3 chunks a view: ragged over the ranks) and gathering the
  view, against the single-process render at rtol / atol 1e-5
  (test_parallel_render.py's), on every rank. Against the JAX package's
  render on a 2-device mesh: the points at >= 40 dB
  (test_torch_render.py's points-vs-JAX bound, the JAX side on its CPU
  path), the backbone at 1e-5 (its bound there).
* The chunk guard: a chunk that does not divide over the ranks raises in
  both packages (``ValueError`` here, the JAX package's assertion there).
* ``--train_devices 2`` / ``--render_devices 2`` with fewer cards than
  ranks raise before the data is loaded; two counts above 1 that differ
  raise. The command line on 2 ranks against one process (both stages,
  then the test views).

The single-process references run on one thread, as each rank does.
"""
import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from apnerf.models import temporal_points as jtp
from apnerf.parallel import mesh as jmesh
from apnerf.render import render as jrender
from apnerf.render.renderers import (make_backbone_renderer as jbackbone,
                                     make_points_renderer as jpoints)
from apnerf_torch import cli as tcli
from apnerf_torch.parallel import ranks
from test_torch_render import _tiny_backbone  # noqa
from test_torch_temporal_points import (BASE, MODES, jax_state,  # noqa
                                        port_model, psnr, scene)

H, W, CHUNK = 12, 16, 64          # 192 pixels: 3 chunks a view


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_mesh2():
    return Mesh(np.array(jax.devices("cpu")[:2]), (jmesh.RAY_AXIS,))


def _views(times, z=3.0, f=140.0):
    out = []
    for i, t in enumerate(times):
        c2w = np.eye(4, dtype=np.float32)
        c2w[2, 3] = z
        c2w[0, 3] = 0.03 * i
        K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
        out.append((i, float(t), K, c2w, H, W))
    return out


def _same(got, want, keys):
    for g, w in zip(got["images"], want["images"]):
        for k in keys:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("mode", ["exact", "shared8_cand8"])
def test_points_render_mesh(mode, scene, tmp_path, one_thread):
    model, state = port_model(MODES[mode], scene)
    views = _views([0.0, 1.0])
    poses = np.stack([v[3] for v in views])
    Ks = np.stack([v[2] for v in views])
    kw = dict(model=model, state=state, views=views, chunk=CHUNK,
              renderer_kw=dict(near=0.5, far=6.0, bg=1.0, poses=poses,
                               Ks=Ks),
              extra_keys=("weights",))
    single = ranks.render_views(**kw)
    keys = ("rgb_marched", "depth", "weights", "joints_2d")
    got = ranks.spawn(2, ranks.render_views, store_dir=str(tmp_path),
                      bad_chunk=CHUNK - 1, **kw)
    for res in got:
        _same(res, single, keys)
        assert res["error"].startswith("ValueError")
    img = single["images"][0]
    assert (img["rgb_marched"] < 0.99).any(-1).mean() > 0.2   # foreground
    # the JAX package's sharded render of the same views
    jcfg = jtp.TemporalPointsConfig(**{**BASE, **MODES[mode]})
    jview = jpoints(scene["params"], jcfg, jax_state(jcfg, scene), 0.5, 6.0,
                    1.0, poses=poses, Ks=Ks, mesh=_jax_mesh2())
    for (i, t, K, c2w, h, w), g in zip(views, got[0]["images"]):
        want = jrender.render_image(jview(i, t), K, c2w, h, w, chunk=CHUNK,
                                    extra_keys=("weights",))
        for k in ("rgb_marched", "weights"):
            assert psnr(g[k], want[k]) >= 40.0, k
        assert psnr(g["depth"] / 128.0, want["depth"] / 128.0) >= 40.0
    with pytest.raises(AssertionError):
        jrender.render_image(jview(0, 0.0), views[0][2], views[0][3], H, W,
                             chunk=CHUNK - 1)


def test_backbone_render_mesh(tmp_path, one_thread):
    jcfg, params, model = _tiny_backbone()
    views = _views([0.2, 0.8], z=0.9, f=30.0)
    kw = dict(model=model, views=views, chunk=CHUNK,
              renderer_kw=dict(stepsize=0.5, near=0.05, far=1.53, bg=1.0))
    single = ranks.render_views(**kw)
    got = ranks.spawn(2, ranks.render_views, store_dir=str(tmp_path), **kw)
    for res in got:
        _same(res, single, ("rgb_marched", "depth"))
    jview = jbackbone(params, jcfg, 0.5, 0.05, 1.53, 1.0, mesh=_jax_mesh2())
    for (i, t, K, c2w, h, w), g in zip(views, got[1]["images"]):
        want = jrender.render_image(jview(i, t), K, c2w, h, w, chunk=CHUNK)
        for k in ("rgb_marched", "depth"):
            np.testing.assert_allclose(g[k], want[k], rtol=1e-5, atol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("argv", [["--train_devices", "2"],
                                  ["--render_only", "--render_test",
                                   "--render_devices", "2"]])
@pytest.mark.parametrize("device", [None, "cpu"])
def test_devices_without_cards_raise_before_loading(argv, device,
                                                    monkeypatch):
    def loaded(*a, **k):
        raise AssertionError("the data was loaded")

    monkeypatch.setattr(tcli, "load_everything", loaded)
    monkeypatch.setattr(tcli, "load_config", loaded)
    # a host with one card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--config", "none.py"] + argv, device=device)
    with pytest.raises(ValueError, match="equal"):
        tcli.main(["--config", "none.py", "--train_devices", "2",
                   "--render_devices", "4"], device=device)


def test_cli_on_two_ranks(tmp_path, one_thread):
    """``python -m apnerf_torch.cli`` with ``--train_devices 2`` and then
    ``--render_only --render_test --render_pcd --render_devices 2``, each
    rank ``cli.main`` in a gloo group (as under ``torchrun``), against the
    same command lines in one process on a micro config (2 + 2 steps of a
    16 x 16 arm scene): the same files, written once; the stage-2
    checkpoint's parameters at rtol 2e-4 / atol 1e-6; the test views'
    images at 1e-5 and their PSNRs at rtol 1e-6, on both ranks."""
    import os
    from apnerf_torch.data import synthetic
    from apnerf_torch.utils.checkpoint import load_checkpoint
    scene = synthetic.generate_scene(str(tmp_path / "arm"), n_times=3,
                                     n_test=1, H=16, W=16)
    base = os.path.join(os.path.dirname(tcli.__file__), "config", "configs")
    config = (
        f"_base_ = {base + '/nerf/jumpingjacks.py'!r}\n"
        "expname = 'e2e'\nbasedir = './logs/'\n"
        f"data = dict(datadir={scene!r}, half_res=False)\n"
        "model_and_render = dict(num_voxels=8 ** 3, num_voxels_base=8 ** 3,"
        " voxel_dim=4, defor_depth=2, net_width=16)\n"
        "train_config = dict(N_iters=2, N_rand=32, pg_scale=[], "
        "use_occupancy=False)\n"
        "pcd_model_and_render = dict(canonical_pcd_num=100, bone_length=3.0,"
        " pcd_density_threshold=0.0, skeleton_density_threshold=0.0, "
        "sample_budget=16)\n"
        "pcd_train_config = dict(N_iters=2, N_rand=16, full_t_iter=4)\n")
    train = ["--config", "micro.py", "--i_print", "1", "--i_save", "1000",
             "--train_devices", "2"]
    render = ["--config", "micro.py", "--render_only", "--render_test",
              "--render_pcd", "--eval_psnr", "--load_test_val",
              "--render_devices", "2"]
    runs = {}
    for who in ("single", "mesh"):
        work = tmp_path / who
        work.mkdir()
        (work / "micro.py").write_text(config)
        got = []
        for argv in (train, render):
            if who == "single":
                # one process: the counts at 1
                argv = [a if a != "2" else "1" for a in argv]
                got.append([ranks.cli_main(argv=argv, workdir=str(work))])
            else:
                got.append(ranks.spawn(2, ranks.cli_main,
                                       store_dir=str(tmp_path), argv=argv,
                                       workdir=str(work)))
        runs[who] = got
    out = {who: tmp_path / who / "logs" / "e2e" for who in runs}
    files = {who: sorted(str(p.relative_to(d)) for p in d.rglob("*")
                         if p.is_file())
             for who, d in out.items()}
    assert files["single"] == files["mesh"]
    assert "temporalpoints_last.pkl" in files["mesh"]
    want = load_checkpoint(str(out["single"] / "temporalpoints_last.pkl"))
    got = load_checkpoint(str(out["mesh"] / "temporalpoints_last.pkl"))
    flat_w = jax.tree_util.tree_leaves(want["params"])
    flat_g = jax.tree_util.tree_leaves(got["params"])
    assert len(flat_w) == len(flat_g)
    for a, b in zip(flat_g, flat_w):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-6)
    (ref,) = runs["single"][1]
    for res in runs["mesh"][1]:
        (r_view,), (w_view,) = res["renders"], ref["renders"]
        np.testing.assert_allclose(r_view["rgbs"], w_view["rgbs"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r_view["psnrs"], w_view["psnrs"],
                                   rtol=1e-6)
