"""The export's other sources, the port against the JAX package: the
reference's ``torch.save`` tars seed stage 2 (written as
tests/test_torch_load.py writes them), and the ZJU SMPL skeleton prior
(``smpl_joints.npy`` beside the cache, the built-in table matched on the
subject id). Equal outputs; a tar with a foreign global raises."""
import os
import pickle
import zipfile

import numpy as np
import pytest
import torch

from apnerf.kinematics import zju_skeletons as jzs
from apnerf.models import tineuvox as jtv
from apnerf.train import export as jexport
from apnerf_torch.kinematics import zju_skeletons as tzs
from apnerf_torch.models import tineuvox as ttv
from apnerf_torch.train import export as texport
from test_torch_export import analytic_volume


def write_tars(pcd_dir, bf16=False):
    """canonical.tar (tensors, one bf16) and skeleton.tar (numpy arrays,
    tuples), as the reference's export writes them."""
    rng = np.random.default_rng(3)
    os.makedirs(pcd_dir, exist_ok=True)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    feat = torch.tensor(rng.normal(size=(300, 64)).astype(np.float32))
    torch.save({
        "pcd": torch.tensor(pts),
        "rgbs": torch.tensor(rng.random((300, 3)).astype(np.float32)),
        "feat": feat.bfloat16() if bf16 else feat,
        "raw_feat": None,
        "alphas": torch.tensor(rng.random(300).astype(np.float32)),
        "t": 0.0,
        "xyz_min": torch.tensor(pts.min(0)),
        "xyz_max": torch.tensor(pts.max(0)),
        "voxel_size": torch.tensor(0.01),
    }, os.path.join(pcd_dir, "canonical.tar"))
    joints = rng.normal(size=(4, 3))
    torch.save({
        "skeleton_pcd": joints, "joints": joints, "root": joints[0],
        "bones": [(0, 1), (1, 2), (1, 3)], "pcd": None, "weights": None,
        "binary_volume": torch.zeros((4, 4, 4), dtype=torch.bool),
    }, os.path.join(pcd_dir, "skeleton.tar"))


def assert_equal_trees(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_equal_trees(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_equal_trees(g, w)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want and type(got) is type(want)


@pytest.mark.parametrize("bf16", [False, True])
def test_export_from_reference_tars(tmp_path, capsys, bf16):
    write_tars(str(tmp_path / "pcds"), bf16=bf16)
    want = jexport.export_point_cloud(None, None, str(tmp_path), 0.0, 0.5)
    jout = capsys.readouterr().out
    got = texport.export_point_cloud(None, str(tmp_path), 0.0, 0.5)
    assert capsys.readouterr().out == jout
    assert "loaded reference torch artifacts (300 points, 3 bones)" in jout
    assert_equal_trees(got, want)
    assert got["skeleton"]["bones"] == [[0, 1], [1, 2], [1, 3]]
    assert got["canonical"]["feat"].dtype == np.float32


def test_tar_with_a_foreign_global_raises(tmp_path):
    """``weights_only`` refuses what the JAX reader refuses: a global
    that is not a tensor's or numpy's."""

    class Evil:
        def __reduce__(self):
            return (os.system, ("true",))

    pcd = tmp_path / "pcds"
    write_tars(str(pcd))
    with zipfile.ZipFile(pcd / "canonical.tar", "w") as zf:
        zf.writestr("archive/data.pkl", pickle.dumps({"x": Evil()}))
        zf.writestr("archive/version", "3\n")
    with pytest.raises(pickle.UnpicklingError):
        texport.export_point_cloud(None, str(tmp_path), 0.0, 0.5)
    torch.save({"x": os.system}, str(pcd / "canonical.tar"))
    with pytest.raises(pickle.UnpicklingError):
        texport.load_reference_tar(str(pcd / "canonical.tar"))


@pytest.mark.parametrize("path", ["data/zju/377/cache_train.pickle",
                                  "data/zju/20250381/cache_train.pickle",
                                  "data/zju/999/cache_train.pickle"])
def test_smpl_joint_tables_vs_jax(path):
    want = jzs.smpl_skeleton_for(path)
    got = tzs.smpl_skeleton_for(path)
    if want is None:
        assert got is None
        return
    assert_equal_trees(got, want)
    assert got["bones"] == tzs.SMPL_BONES and got["joints"].shape == (24, 3)


def test_smpl_joints_file_beside_the_cache(tmp_path):
    rng = np.random.default_rng(5)
    cache = tmp_path / "subj" / "cache_train.pickle"
    cache.parent.mkdir()
    np.save(cache.parent / "smpl_joints.npy", rng.normal(size=(24, 3)))
    want = jzs.load_subject_joints(str(cache))
    got = tzs.load_subject_joints(str(cache))
    np.testing.assert_array_equal(got, want)
    np.save(cache.parent / "smpl_joints.npy", rng.normal(size=(23, 3)))
    with pytest.raises(ValueError, match="24, 3"):
        tzs.load_subject_joints(str(cache))


def test_export_with_the_smpl_prior_vs_jax(monkeypatch, capsys, tmp_path):
    """Both exports on the analytic arm (test_torch_export.py's), the
    skeleton from subject 377's table: equal artifacts."""
    kw = dict(xyz_min=(-1.0, -0.5, -0.5), xyz_max=(1.0, 0.9, 0.5),
              num_voxels=32 ** 3, num_voxels_base=32 ** 3, voxel_dim=4,
              defor_depth=2, net_width=16)
    monkeypatch.setattr(
        jtv, "eval_alpha_volume",
        lambda params, cfg, grid, t, s, **k: analytic_volume(grid, t, s, **k))
    monkeypatch.setattr(
        ttv, "eval_alpha_volume",
        lambda model, grid, t, s, **k: analytic_volume(grid, t, s, **k))
    run = dict(canonical_pcd_num=1000, overwrite=True,
               smpl_skeleton_datadir="data/zju/377/cache_train.pickle")
    want = jexport.export_point_cloud(None, jtv.TiNeuVoxConfig(**kw),
                                      str(tmp_path / "jax"), 0.0, 0.5, **run)
    jout = capsys.readouterr().out
    got = texport.export_point_cloud(ttv.TiNeuVox(ttv.TiNeuVoxConfig(**kw)),
                                     str(tmp_path / "port"), 0.0, 0.5, **run)
    assert capsys.readouterr().out == jout
    assert "using SMPL joint prior" in jout
    assert_equal_trees(got["skeleton"], want["skeleton"])
    canonical = dict(got["canonical"])
    assert canonical.pop("sampling_freq") > 0
    assert_equal_trees(canonical, want["canonical"])
    with open(tmp_path / "port" / "pcds" / "skeleton.pkl", "rb") as f:
        assert_equal_trees(pickle.load(f), want["skeleton"])
