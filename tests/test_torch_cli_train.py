"""``apnerf_torch.cli.main`` against ``apnerf.cli.main``, part 1: training
(the scene, config and working directories of torch_cli_scene.py; one
device; the JAX package and the port in directories of their own).

* The parsers: the same flags, defaults, types and actions.
* ``--first_stage_only``, the port's stage-1 init made the JAX one:
  ``args.txt`` and ``config.py`` equal; the logged losses within 1e-4
  relative (test_torch_stage1.py's tolerance for whole runs); every
  parameter of ``fine_last.pkl`` within 0.1 of its group's lr at most and
  0.01 on average (Adam turns fp32 noise in near-zero gradients into up
  to one lr step, see test_torch_stage1.py; measured over the ten steps
  0.045 lr at most, in feature_net's first layer, and 0.0008 on
  average).
* ``--second_stage_only``, the port from a copy of the JAX run's
  ``fine_last.pkl``: the export's ``pcds/*.pkl`` with equal points,
  bones, joints and skeleton points, their features, rgb and alpha within
  1e-5 (test_torch_export.py's tolerance for the alpha volume). Stage 2
  then starts from the JAX export's artifacts, parameters and canonical
  k-NN (the port's ``build_model`` made to return them: the exported
  cloud is a lattice, whose kth and (k+1)th neighbours tie, and the two
  packages break ties apart, which moves the ARAP and weight-TV terms by
  2%; test_torch_stage2_model.py compares the sets where they do not
  tie): the same rays every step, the
  losses within 1e-3 relative (test_torch_stage2_train.py's), and in
  ``temporalpoints_last.pkl`` the state arrays equal and every parameter
  group within 4 lr at most and 0.1 lr on average
  (test_torch_stage2_model.py's bound for four steps).
* ``--train_devices 2`` raises on the CPU (one process a CUDA card).
"""
import pickle
import shutil

import numpy as np
import pytest
import torch

import jax

from apnerf import cli as jcli
from apnerf.data import rays as jrays
from apnerf.models import tineuvox as jt
from apnerf.train import stage1 as js1
from apnerf.train import stage2 as js2
from apnerf_torch import cli as tcli
from apnerf_torch.data import rays as trays
from apnerf_torch.train import export as texport
from apnerf_torch.train import stage1 as ts1
from apnerf_torch.train import stage2 as ts2
from apnerf_torch.utils.checkpoint import params_from_jax
from torch_cli_scene import (one_torch_thread,  # noqa
                             LOG, RUN_DIR, jax_cli, jax_init,  # noqa
                             make_dirs, port_cli)


def record(mp, store, sels):
    """Each package's stage-1 and stage-2 stats and ray selections; the
    port's stage-1 init and stage-2 parameters made the JAX ones."""
    for key, s1, s2, rays in (("jax", js1, js2, jrays),
                              ("port", ts1, ts2, trays)):
        real1, real2, gather = (s1.scene_rep_reconstruction, s2.train_pcd,
                                rays.RayIndex.gather)

        def stage1(*a, _r=real1, _k=key, **k):
            out = _r(*a, **k)
            store[_k]["stage1"] = out[2]
            return out

        def stage2(*a, _r=real2, _k=key, **k):
            out = _r(*a, **k)
            store[_k]["stage2"] = out[3]
            return out

        def record_gather(self, sel, _r=gather, _k=key):
            sels[_k].append(np.array(sel))
            return _r(self, sel)
        mp.setattr(s1, "scene_rep_reconstruction", stage1)
        mp.setattr(s2, "train_pcd", stage2)
        mp.setattr(rays.RayIndex, "gather", record_gather)
    mp.setattr(ts1.tineuvox, "init_model", jax_init)
    real_build = ts2.build_model

    def build_model(cfg, canonical, skeleton, heads, tcfg, **kw):
        mcfg, model, state = real_build(cfg, canonical, skeleton, heads,
                                        tcfg, **kw)
        kw.pop("device")
        _, jparams, jstate = js2.build_model(
            cfg, canonical, skeleton, heads,
            jt.TiNeuVoxConfig(**tcfg.get_kwargs()), **kw)
        model.load_state_dict(params_from_jax(
            jax.tree_util.tree_map(np.asarray, jparams)))
        for key in ("nn_i", "nn_distance", "mean_min_distance"):
            state[key] = torch.tensor(np.asarray(jstate[key])).to(
                state[key].dtype)
        return mcfg, model, state
    mp.setattr(ts2, "build_model", build_model)
    real_export = texport.export_point_cloud

    def export(*a, **k):
        real_export(*a, **k)
        pcds = store["jax"]["pcds"]
        return {"canonical": load(pcds / "canonical.pkl"),
                "skeleton": load(pcds / "skeleton.pkl")}
    mp.setattr(texport, "export_point_cloud", export)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_train")
    _, dirs = make_dirs(root)
    store, sels = {"jax": {}, "port": {}}, {"jax": [], "port": []}
    mp = pytest.MonkeyPatch()
    try:
        record(mp, store, sels)
        jax_cli(dirs["jax"], ["--first_stage_only"] + LOG, root / "cache")
        port_cli(dirs["port"], ["--first_stage_only"] + LOG)
        jrun, trun = dirs["jax"] / RUN_DIR, dirs["port"] / RUN_DIR
        shutil.copy(trun / "fine_last.pkl", root / "port_fine_last.pkl")
        shutil.copy(jrun / "fine_last.pkl", trun / "fine_last.pkl")
        jax_cli(dirs["jax"], ["--second_stage_only"] + LOG, root / "cache")
        store["jax"]["pcds"] = jrun / "pcds"
        port_cli(dirs["port"], ["--second_stage_only"] + LOG)
    finally:
        mp.undo()
    return dict(root=root, dirs=dirs, jrun=jrun, trun=trun, store=store,
                sels=sels)


def load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_parsers_match():
    def actions(p):
        return {a.dest: (tuple(a.option_strings), a.default, a.type,
                         type(a).__name__, a.required, a.nargs)
                for a in p._actions}
    assert actions(tcli.config_parser()) == actions(jcli.config_parser())
    argv = ["--config", "c.py", "--render_only", "--degree_threshold", "30",
            "--i_save", "7"]
    assert vars(tcli.config_parser().parse_args(argv)) == \
        vars(jcli.config_parser().parse_args(argv))


def test_first_stage_vs_jax(runs):
    for name in ("args.txt", "config.py"):
        assert (runs["trun"] / name).read_text() == \
            (runs["jrun"] / name).read_text(), name
    js, ts = runs["store"]["jax"]["stage1"], runs["store"]["port"]["stage1"]
    assert len(ts["loss"]) == len(js["loss"]) == 10
    np.testing.assert_allclose(ts["loss"], js["loss"], rtol=1e-4)
    np.testing.assert_allclose(ts["psnr"], js["psnr"], rtol=1e-4)
    want = load(runs["jrun"] / "fine_last.pkl")
    got = load(runs["root"] / "port_fine_last.pkl")
    assert got["model_kwargs"] == want["model_kwargs"]
    cfg_train = jcli.load_config(str(runs["dirs"]["jax"] / "micro.py")) \
        .train_config
    assert_within_lr(params_from_jax(got["params"]),
                     params_from_jax(want["params"]), cfg_train, 0.1, 0.01)


def assert_within_lr(got, want, cfg_train, at_most, on_average):
    """Every parameter within ``at_most`` of its group's lr, and
    ``on_average``; a group without an lr unchanged."""
    assert set(got) == set(want)
    moved = 0
    for name in want:
        lr = float(cfg_train.get(f"lrate_{name.split('.')[0]}", 0.0))
        diff = np.abs(got[name].numpy() - want[name].numpy())
        if lr == 0:
            assert not diff.any(), name
            continue
        moved += 1
        assert diff.max() <= at_most * lr \
            and diff.mean() <= on_average * lr, (
                name, diff.max() / lr, diff.mean() / lr)
    return moved


def test_export_vs_jax(runs):
    for name in ("canonical.pkl", "skeleton.pkl"):
        want = load(runs["jrun"] / "pcds" / name)
        got = load(runs["trun"] / "pcds" / name)
        assert set(got) - set(want) <= {"sampling_freq"}
        for key, w in want.items():
            if isinstance(w, np.ndarray) and w.dtype.kind == "f" \
                    and key not in ("pcd", "joints", "skeleton_pcd",
                                    "root", "xyz_min", "xyz_max"):
                np.testing.assert_allclose(got[key], w, rtol=0, atol=1e-5,
                                           err_msg=key)
            elif isinstance(w, np.ndarray):
                np.testing.assert_array_equal(got[key], w, err_msg=key)
            else:
                assert got[key] == w, key
    assert len(load(runs["trun"] / "pcds" / "canonical.pkl")["pcd"]) > 100


def test_second_stage_vs_jax(runs):
    sels = runs["sels"]
    # the audit's gather, then one a step (stage 1 draws no gathers here)
    assert len(sels["port"]) == len(sels["jax"])
    for a, b in zip(sels["jax"], sels["port"]):
        np.testing.assert_array_equal(a, b)
    js, ts = runs["store"]["jax"]["stage2"], runs["store"]["port"]["stage2"]
    assert len(ts["loss"]) == len(js["loss"]) == 4
    np.testing.assert_allclose(ts["loss"], js["loss"], rtol=1e-3)
    want = load(runs["jrun"] / "temporalpoints_last.pkl")
    got = load(runs["trun"] / "temporalpoints_last.pkl")
    assert got["model_kwargs"] == want["model_kwargs"]
    assert got["tineuvox_kwargs"] == want["tineuvox_kwargs"]
    for key, w in want["state_arrays"].items():
        g = got["state_arrays"][key]
        if w is None:
            assert g is None, key
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=key)
    cfg_train = jcli.load_config(str(runs["dirs"]["jax"] / "micro.py")) \
        .pcd_train_config
    moved = assert_within_lr(params_from_jax(got["params"]),
                             params_from_jax(want["params"]), cfg_train,
                             4.0, 0.1)
    assert moved >= 20


def test_train_devices_raise(runs):
    # one process a CUDA card: on the CPU there is none
    with pytest.raises(RuntimeError, match="CUDA card"):
        port_cli(runs["dirs"]["port"], ["--first_stage_only",
                                        "--train_devices", "2"])


def test_main_needs_cuda():
    """``device=None`` is the CUDA device; without one ``main`` raises
    before it reads anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--config", "missing.py"])
