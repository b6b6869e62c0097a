"""The stage 1 -> stage 2 export of the port against the JAX package on
the CPU.

* The morphology and skeletonizer copies on the volumes of
  test_kinematics.py (a tube, a thin line, a holed cube with a stray
  voxel, an L of two tubes): thinning, hole filling, largest component,
  ``preprocess_volume`` and ``create_skeleton`` give outputs equal to the
  JAX package's (the same C++ thinning, built by each package from its own
  copy of the source; float outputs to 1e-6). The Python thinning, the
  plain version of the library, gives the library's skeleton.
* ``eval_alpha_volume`` on random stage-1 parameters (the JAX
  ``init_params``, carried over with ``tineuvox_from_jax``) with
  ``want_features`` and a view direction, deformed and ``canonical``:
  alpha, rgb and features within 1e-5.
* ``export_point_cloud`` in both packages with ``eval_alpha_volume``
  replaced (each package's module, by the test's ``monkeypatch``) by the
  analytic arm of ``data.synthetic`` at its hinge's time 0: the same
  sampling-frequency search (the printed sequence), and equal points,
  features, rgb, alpha, bounds, joints, bones and skeleton voxels.
"""
import numpy as np
import pytest

import jax

from apnerf.kinematics import morphology as jm
from apnerf.kinematics import skeletonizer as jsk
from apnerf.models import tineuvox as jtv
from apnerf.train import export as jexport
from apnerf_torch.data.synthetic import density_and_color
from apnerf_torch.kinematics import morphology as tm
from apnerf_torch.kinematics import skeletonizer as tsk
from apnerf_torch.models import tineuvox as ttv
from apnerf_torch.train import export as texport
from apnerf_torch.utils.checkpoint import tineuvox_from_jax


def volumes():
    tube = np.zeros((40, 20, 20), bool)
    tube[4:36, 8:14, 8:14] = True
    line = np.zeros((20, 9, 9), bool)
    line[2:18, 4, 4] = True
    cube = np.zeros((12, 12, 12), bool)
    cube[2:10, 2:10, 2:10] = True
    cube[5, 5, 5] = False
    cube[0, 0, 0] = True
    ell = np.zeros((40, 24, 24), np.float32)
    ell[4:36, 8:14, 8:14] = 1.0
    ell[30:36, 8:20, 8:14] = 1.0
    return dict(tube=tube, line=line, cube=cube, ell=ell)


@pytest.mark.parametrize("name", ["tube", "line", "cube", "ell"])
def test_morphology_vs_jax(name):
    vol = volumes()[name]
    np.testing.assert_array_equal(tm.skeletonize_3d(vol > 0),
                                  jm.skeletonize_3d(vol > 0))
    np.testing.assert_array_equal(
        tm.remove_small_holes(vol > 0, area_threshold=8),
        jm.remove_small_holes(vol > 0, area_threshold=8))
    np.testing.assert_array_equal(tm.largest_component(vol > 0),
                                  jm.largest_component(vol > 0))
    for sigma in (0, 1):
        np.testing.assert_array_equal(
            tm.preprocess_volume(vol, 0.5, sigma=sigma),
            jm.preprocess_volume(vol, 0.5, sigma=sigma))


def test_python_thinning_is_the_library_thinning():
    vol = np.zeros((14, 10, 10), bool)
    vol[2:12, 3:7, 3:7] = True
    vol[9:12, 3:9, 3:7] = True
    sk = tm.skeletonize_3d(vol)
    assert 0 < sk.sum() < vol.sum()
    np.testing.assert_array_equal(tm.skeletonize_python(vol), sk)


def test_create_skeleton_vs_jax():
    vol = volumes()["ell"]
    axes = [np.linspace(-1, 1, s) for s in vol.shape]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1)
    got = tsk.create_skeleton(vol, grid, bone_length=6.0, threshold=0.5)
    want = jsk.create_skeleton(vol, grid, bone_length=6.0, threshold=0.5)
    assert got["bones"] == want["bones"] and len(got["bones"]) >= 3
    for key in ("skeleton_pcd", "root", "joints", "pcd", "weights"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                   atol=1e-7, err_msg=key)


@pytest.mark.parametrize("canonical", [False, True])
def test_eval_alpha_volume_features_vs_jax(canonical):
    kw = dict(xyz_min=(-1.0, -1.2, -0.8), xyz_max=(1.0, 0.9, 1.1),
              num_voxels=12 ** 3, num_voxels_base=12 ** 3, voxel_dim=4,
              defor_depth=3, net_width=32)
    jcfg = jtv.TiNeuVoxConfig(**kw)
    params = jax.tree_util.tree_map(np.asarray, jtv.init_params(
        jax.random.PRNGKey(2), jcfg))
    rng = np.random.default_rng(0)
    params["feature"] = rng.normal(size=params["feature"].shape).astype(
        np.float32)
    model = tineuvox_from_jax(kw, params, device="cpu")
    pts = rng.uniform(-1, 1, (5, 7, 3)).astype(np.float32)
    vd = np.array([0.3, -0.5, 0.8], np.float32)
    got = ttv.eval_alpha_volume(model, pts, 0.4, 0.5, canonical=canonical,
                                want_features=True, viewdir=vd)
    want = jtv.eval_alpha_volume(params, jcfg, pts, 0.4, 0.5,
                                 canonical=canonical, want_features=True,
                                 viewdir=vd)
    assert got[0].shape == (5, 7) and got[1].shape == (5, 7, 3)
    assert got[2].shape == (5, 7, 32)
    for g, w, name in zip(got, want, ("alpha", "rgb", "feat")):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    np.testing.assert_array_equal(
        ttv.eval_alpha_volume(model, pts, 0.4, 0.5, canonical=canonical),
        got[0])
    np.testing.assert_array_equal(ttv.grid_xyz_coords(
        model.cfg, 1.3, world_size=(8, 9, 10)), jtv.grid_xyz_coords(
        jcfg, 1.3, world_size=(8, 9, 10)))


def analytic_volume(grid_xyz, time_sel, stepsize, want_features=False,
                    viewdir=None):
    """The synthetic arm at time 0 as an alpha field (+ rgb and a
    five-wide feature of position and density)."""
    pts = np.asarray(grid_xyz, np.float64).reshape(-1, 3)
    sigma, rgb = density_and_color(pts, 0.0)
    alpha = (1.0 - np.exp(-sigma * 0.02)).astype(np.float32)
    shape = np.asarray(grid_xyz).shape[:-1]
    if not want_features:
        return alpha.reshape(shape)
    feat = np.concatenate([pts, sigma[:, None], alpha[:, None]], -1)
    return (alpha.reshape(shape),
            rgb.astype(np.float32).reshape(*shape, 3),
            feat.astype(np.float32).reshape(*shape, 5))


def test_export_point_cloud_vs_jax(monkeypatch, capsys, tmp_path):
    kw = dict(xyz_min=(-1.0, -0.5, -0.5), xyz_max=(1.0, 0.9, 0.5),
              num_voxels=48 ** 3, num_voxels_base=48 ** 3, voxel_dim=4,
              defor_depth=2, net_width=16)
    monkeypatch.setattr(
        jtv, "eval_alpha_volume",
        lambda params, cfg, grid, t, s, **k: analytic_volume(grid, t, s, **k))
    monkeypatch.setattr(
        ttv, "eval_alpha_volume",
        lambda model, grid, t, s, **k: analytic_volume(grid, t, s, **k))
    model = ttv.TiNeuVox(ttv.TiNeuVoxConfig(**kw))
    run = dict(pcd_density_threshold=0.05, skeleton_density_threshold=0.05,
               bone_length=6.0, canonical_pcd_num=3000, overwrite=True)
    want = jexport.export_point_cloud(None, jtv.TiNeuVoxConfig(**kw),
                                      str(tmp_path / "jax"), 0.0, 0.5, **run)
    jout = capsys.readouterr().out
    got = texport.export_point_cloud(model, str(tmp_path / "port"), 0.0, 0.5,
                                     **run)
    tout = capsys.readouterr().out
    freqs = [[l for l in out.splitlines() if "sampling freq" in l]
             for out in (jout, tout)]
    assert freqs[0] and freqs[0] == freqs[1]
    gc, wc = got["canonical"], want["canonical"]
    assert abs(len(gc["pcd"]) - 3000) < 600
    assert set(gc) == set(wc) | {"sampling_freq"}
    for key in wc:
        np.testing.assert_array_equal(np.asarray(gc[key]),
                                      np.asarray(wc[key]), err_msg=key)
    gs, ws = got["skeleton"], want["skeleton"]
    assert gs["bones"] == ws["bones"] and len(gs["bones"]) >= 1
    for key in ("skeleton_pcd", "root", "joints", "pcd", "weights"):
        np.testing.assert_allclose(gs[key], ws[key], rtol=1e-6, atol=1e-7,
                                   err_msg=key)
    assert (tmp_path / "port" / "pcds" / "canonical.pcd").exists()
    again = texport.export_point_cloud(model, str(tmp_path / "port"), 0.0,
                                       0.5)
    np.testing.assert_array_equal(again["canonical"]["pcd"], gc["pcd"])


def test_export_unported_branches_raise(tmp_path):
    """The branches once left unported now raise only on bad input: a
    ``smpl_joints.npy`` of another shape than [24, 3] beside the cache,
    reference tars that are not ``torch.save`` archives."""
    model = ttv.TiNeuVox(ttv.TiNeuVoxConfig(
        xyz_min=(-1.0,) * 3, xyz_max=(1.0,) * 3, num_voxels=8 ** 3,
        num_voxels_base=8 ** 3))
    np.save(tmp_path / "smpl_joints.npy", np.zeros((23, 3)))
    with pytest.raises(ValueError, match="24, 3"):
        texport.export_point_cloud(
            model, str(tmp_path), 0.0, 0.5, pcd_density_threshold=0.0,
            skeleton_density_threshold=0.0, canonical_pcd_num=50,
            smpl_skeleton_datadir=str(tmp_path / "cache_train.pickle"))
    (tmp_path / "pcds").mkdir(exist_ok=True)
    for name in ("canonical.tar", "skeleton.tar"):
        (tmp_path / "pcds" / name).write_bytes(b"")
    for name in ("canonical.pkl", "skeleton.pkl"):
        (tmp_path / "pcds" / name).unlink(missing_ok=True)
    with pytest.raises(EOFError):
        texport.export_point_cloud(model, str(tmp_path), 0.0, 0.5)
