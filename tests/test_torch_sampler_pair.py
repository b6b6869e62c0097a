"""The non-fused sampler pair of the point model, ``sample_rays_compact``
and ``compact_active``, against the JAX package on the CPU: a 2,000-point
cloud (the scene of test_torch_temporal_points.py), 128 rays, max_steps
128, voxel 0.012, coarse_stride 16, its occupancy grid and k-NN tables
made by each package's own ``prepare_occupancy`` / ``build_point_tables``.

* ``sample_rays_compact`` with the grid and a budget the stride divides
  (the coarse-group branch), a budget it does not (per-step occupancy),
  and no grid: equal valid masks and step indices, positions within 1e-6.
* ``compact_active`` against the JAX kernel path (its Pallas K2 in
  interpret mode: the same Morton ordering of the compacted samples) in
  the group branch with and without the K2 prefilter, and in the
  single-sample branch: equal ``src`` and ``act_ok``, positions within
  1e-6.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apnerf.models import temporal_points as jtp
from apnerf_torch.models import temporal_points as ttp

P = 2000
BASE = dict(n_points=P, n_joints=6, feat_dim=32, stepsize=0.5,
            voxel_size=0.012, max_steps=128, coarse_stride=16,
            active_fraction=0.5, group_pass_fraction=0.55, knn_rt=4)
RADIUS = 0.01


def cloud():
    rng = np.random.default_rng(0)
    joints = np.zeros((6, 3), np.float32)
    joints[:, 1] = np.linspace(-0.2, 0.2, 6)
    seg = rng.integers(0, 6, P)
    return (joints[seg] + rng.normal(size=(P, 3)) * 0.05).astype(np.float32)


def rays():
    jj, ii = np.meshgrid(np.arange(8) * 3 + 188, np.arange(16) * 3 + 176,
                         indexing="ij")
    d = np.stack([(ii.ravel() + .5 - 200) / 555.0,
                  -(jj.ravel() + .5 - 200) / 555.0,
                  -np.ones(ii.size)], -1).astype(np.float32)
    o = np.broadcast_to(np.array([0, 0, 3.0], np.float32), d.shape).copy()
    return o, d


@pytest.fixture
def jax_kernel_path(monkeypatch):
    """The JAX package on its TPU kernel path, Pallas in interpret mode."""
    monkeypatch.setattr(importlib.import_module("apnerf.ops.knn"),
                        "_tpu_default", lambda: True)
    for name in ("apnerf.kernels.knn_pallas",
                 "apnerf.kernels.knn_cells_pallas"):
        monkeypatch.setattr(importlib.import_module(name), "_interpret_mode",
                            lambda: True)
    jax.clear_caches()
    yield
    jax.clear_caches()


def frames(cfg_kw):
    """(JAX cfg, JAX occupancy info, port cfg, port occupancy info)."""
    pcd = cloud()
    jcfg = jtp.TemporalPointsConfig(**{**BASE, **cfg_kw})
    tcfg = ttp.TemporalPointsConfig(**{**BASE, **cfg_kw})
    jinfo = jtp.prepare_occupancy(jcfg, None, jnp.asarray(pcd), RADIUS)
    tinfo = ttp.prepare_occupancy(tcfg, None, torch.tensor(pcd), RADIUS)
    return jcfg, jinfo, tcfg, tinfo


def sample_both(cfg_kw, use_occ=True):
    jcfg, ji, tcfg, ti = frames(cfg_kw)
    o, d = rays()
    occ = (lambda info, k: info[k] if use_occ else None)
    jout = jtp.sample_rays_compact(
        jcfg, jnp.asarray(o), jnp.asarray(d), 0.5, 6.0, ji["bb_min"],
        ji["bb_max"], occ=occ(ji, "occ"), occ_cell=occ(ji, "occ_cell"),
        occ_margin=ji["occ_margin"])
    tout = ttp.sample_rays_compact(
        tcfg, torch.tensor(o), torch.tensor(d), 0.5, 6.0, ti["bb_min"],
        ti["bb_max"], occ=occ(ti, "occ"), occ_cell=occ(ti, "occ_cell"),
        occ_margin=ti["occ_margin"])
    return (jcfg, ji, [np.asarray(x) for x in jout]), \
        (tcfg, ti, tout)


@pytest.mark.parametrize("budget,use_occ", [(96, True), (100, True),
                                            (96, False)])
def test_sample_rays_compact_vs_jax(budget, use_occ):
    (_, _, (jp, jv, js)), (_, _, (tp_, tv, ts)) = sample_both(
        dict(sample_budget=budget), use_occ)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(ts.numpy(), js)
    assert 0.05 < jv.mean() < 0.95
    np.testing.assert_allclose(tp_.numpy()[jv], jp[jv], rtol=0, atol=1e-6)
    assert (tp_.numpy()[~jv] == 1e9).all() == (jp[~jv] == 1e9).all()


@pytest.mark.parametrize("budget,prefilter", [(96, True), (96, False),
                                              (100, True)])
def test_compact_active_vs_jax(budget, prefilter, jax_kernel_path):
    """Group branch (96 = 6 groups a ray) with and without the K2
    prefilter; the single-sample branch (100)."""
    (jcfg, ji, (jp, jv, _)), (tcfg, ti, (tp_, tv, _)) = sample_both(
        dict(sample_budget=budget))
    pcd = cloud()
    jq, jsrc, jok, jgroup = jtp.compact_active(
        jcfg, jnp.asarray(jp), jnp.asarray(jv), ji["bb_min"], ji["bb_max"],
        pcd=jnp.asarray(pcd) if prefilter else None,
        tables=ji["knn_tables"], query_radius=RADIUS if prefilter else None)
    tq, tsrc, tok, grouped = ttp.compact_active(
        tcfg, tp_, tv, ti["bb_min"], ti["bb_max"],
        tables=ti["knn_tables"] if prefilter else None,
        query_radius=RADIUS if prefilter else None)
    assert grouped == (jgroup is not None) == (budget % 16 == 0)
    np.testing.assert_array_equal(tsrc.numpy(), np.asarray(jsrc))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    ok = np.asarray(jok)
    assert 0.05 < ok.mean() <= 1.0
    np.testing.assert_allclose(tq.numpy()[ok], np.asarray(jq)[ok], rtol=0,
                               atol=1e-6)
    if prefilter and grouped:
        # the prefilter dropped groups the unfiltered compaction keeps
        _, _, tok_all, _ = ttp.compact_active(tcfg, tp_, tv, ti["bb_min"],
                                              ti["bb_max"])
        assert tok.sum() < tok_all.sum()
