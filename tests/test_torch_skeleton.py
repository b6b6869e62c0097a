"""Skeleton simplification of the port against the JAX package on the CPU:
``ops.rotations.rotmat_to_rotvec`` / ``geodesic_angle`` (fp32, 1e-6 in
the vector, looser only in the sqrt-conditioned band next to pi), the
port's copy of ``kinematics/treeprune.py`` on random trees (equal), and
``simplify_skeleton`` on a toy tree of 6 joints, 300 points, in which one
bone never moves and two sibling bones move alike. The new state must
change the warp, and the port's warp under it must match the JAX one
(1e-5)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apnerf.kinematics import treeprune as jprune
from apnerf.models import temporal_points as jtp
from apnerf.models import tineuvox as jtv
from apnerf.ops import nn as jnn
from apnerf.ops import rotations as jrot
from apnerf_torch.kinematics import treeprune as tprune
from apnerf_torch.models import temporal_points as ttp
from apnerf_torch.ops import rotations as trot
from apnerf_torch.utils.checkpoint import model_from_jax

P, J, F = 300, 6, 8
BONES = [[0, 1], [1, 2], [1, 3], [2, 4], [3, 5]]   # 2 and 3 are siblings
STATIC, TWIN = 4, (2, 3)
CFG = dict(n_points=P, n_joints=J, feat_dim=F, neighbours=8, stepsize=0.5,
           voxel_size=0.012, sample_budget=32, max_steps=128,
           coarse_stride=16)


def _rotations(angles, rng):
    axis = rng.normal(size=(len(angles), 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    rv = np.concatenate([axis, np.asarray(angles)[:, None]], -1)
    R, _ = jrot.rodrigues(jnp.asarray(rv.astype(np.float32)))
    return np.asarray(R)


def test_rotmat_to_rotvec_vs_jax():
    """Angles over (0, pi) to 1e-6; tiny angles, where sin(theta) < 1e-6
    switches the scale; and next to pi, where both take the axis from the
    diagonal (a sqrt of a difference of rounded numbers: 2e-3 there)."""
    rng = np.random.default_rng(0)
    for angles, atol in ((rng.uniform(0.01, 3.0, 64), 1e-6),
                         (np.array([0.0, 1e-8, 1e-7, 5e-7, 2e-6]), 1e-6),
                         (np.pi - np.array([0.0, 1e-5, 1e-4, 5e-4]), 2e-3)):
        R = _rotations(angles, rng)
        want = np.asarray(jrot.rotmat_to_rotvec(jnp.asarray(R)))
        got = trot.rotmat_to_rotvec(torch.tensor(R)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
        # sanity only: rodrigues' 1e-5 regulariser leaves the axis a little
        # short of unit length, so R is not exactly a rotation by `angles`
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), angles,
                                   rtol=0, atol=5e-3)
    R1, R2 = _rotations(rng.uniform(0, 3, 16), rng), _rotations(
        rng.uniform(0, 3, 16), rng)
    np.testing.assert_allclose(
        trot.geodesic_angle(torch.tensor(R1), torch.tensor(R2)).numpy(),
        np.asarray(jrot.geodesic_angle(jnp.asarray(R1), jnp.asarray(R2))),
        rtol=0, atol=1e-5)


def _random_tree(rng, n):
    parent = {c: int(rng.integers(0, c)) for c in range(1, n)}
    return [[p, c] for c, p in parent.items()]


@pytest.mark.parametrize("seed", range(6))
def test_treeprune_copy_equal(seed):
    """The port's copy gives the JAX package's results on random trees,
    prune masks and similarity matrices, with and without the conversion
    of the merging rules; all-pruned (seed 0) included."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 18))
    bones = _random_tree(rng, n)
    joints = rng.normal(size=(n, 3)).astype(np.float32)
    prune = rng.uniform(size=n) < (1.0 if seed == 0 else 0.4)
    prune[0] = False
    sim = rng.uniform(size=(n, n)) < 0.3
    sim = sim | sim.T | np.eye(n, dtype=bool)
    for convert in (False, True):
        want = jprune.merge_joints(joints, bones, prune, sim,
                                   convert_merging_rules=convert)
        got = tprune.merge_joints(joints, bones, prune, sim,
                                  convert_merging_rules=convert)
        assert len(got) == len(want) == 7
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        if not convert:
            assert (tprune.flatten_merging_rules(got[2])
                    == jprune.flatten_merging_rules(want[2]))
    kids = list(range(1, n))
    got_c = tprune.cluster_children(kids, sim)
    want_c = jprune.cluster_children(kids, sim)
    assert got_c.keys() == want_c.keys()
    for k in got_c:
        np.testing.assert_array_equal(got_c[k], want_c[k])


@pytest.fixture(scope="module")
def toy():
    """A 6-joint tree whose transform_net moves every bone by ~0.5 rad
    over time, except that bone ``STATIC`` never rotates and the sibling
    bones ``TWIN`` get the same rotation."""
    rng = np.random.default_rng(0)
    joints = np.array([[0, 0, 0], [0, .1, 0], [-.1, .2, 0], [.1, .2, 0],
                       [-.2, .3, 0], [.2, .3, 0]], np.float32)
    seg = rng.integers(0, J, P)
    pcd = (joints[seg] + rng.normal(size=(P, 3)) * 0.03).astype(np.float32)
    feat = rng.normal(size=(P, F)).astype(np.float32) * 0.1
    cfg = jtp.TemporalPointsConfig(**CFG)
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    tnv = {"rgbnet": jtv.init_rgbnet(ks[0], F, cfg.views_ch),
           "densitynet": jnn.init_mlp(ks[1], [F, 1]),
           "timenet": jnn.init_mlp(ks[2], [cfg.t_dim, 16, 8])}
    params = jtp.init_params(jax.random.PRNGKey(1), cfg, pcd, joints, BONES,
                             feat, np.full(P, 0.5, np.float32),
                             np.full((P, 3), 0.5, np.float32), tnv)
    params = jax.tree_util.tree_map(np.asarray, params)
    head = params["forward_warp"]["transform_net"]["layers"][-1]
    w = rng.normal(size=head["w"].shape).astype(np.float32) * 0.3
    w = w.reshape(w.shape[0], J + 1, 4)
    w[:, STATIC] = 0.0
    w[:, TWIN[1]] = w[:, TWIN[0]]
    head["w"] = w.reshape(w.shape[0], -1)
    state_args = (pcd, joints, BONES, pcd[::20], pcd.min(0) - .1,
                  pcd.max(0) + .1)
    jstate = jtp.init_state(cfg, *state_args)
    tcfg = ttp.TemporalPointsConfig(**CFG)
    tstate = ttp.init_state(tcfg, *state_args, device="cpu")
    return dict(cfg=cfg, params=params, jstate=jstate,
                model=model_from_jax(tcfg, params, device="cpu"),
                tstate=tstate)


@pytest.mark.parametrize("five_percent", [True, False])
def test_simplify_skeleton_vs_jax(five_percent, toy):
    times = np.linspace(0, 1, 20, dtype=np.float32)
    kw = dict(deg_threshold=5.0, five_percent_heuristic=five_percent)
    jnew, jinfo = jtp.simplify_skeleton(
        jax.tree_util.tree_map(jnp.asarray, toy["params"]), toy["cfg"],
        toy["jstate"], times, **kw)
    tnew, tinfo = ttp.simplify_skeleton(toy["model"], toy["tstate"], times,
                                        **kw)
    # the toy's construction shows: the static bone is pruned and the twins
    # merge; under the 5% heuristic nothing else is (the average heuristic,
    # which squares the angles, also prunes bones that move little)
    assert tinfo["prune_bones"][STATIC] and not tinfo["prune_bones"][0]
    if five_percent:
        assert tinfo["prune_bones"].sum() == 1
        assert tnew["sibling_mask"].tolist() == [0, 1, 2, 2, 4, 5]
    for key in ("prune_bones", "new_bones", "new_joints", "merging_rules",
                "joints_to_keep", "rotations_to_keep"):
        np.testing.assert_array_equal(tinfo[key], jinfo[key], err_msg=key)
    for key in ("merge_mat", "sibling_mask", "rot_mask"):
        np.testing.assert_array_equal(tnew[key].numpy(),
                                      np.asarray(jnew[key]), err_msg=key)
    assert tnew["merge_mat"].dtype == torch.float32
    assert tnew["rot_mask"].dtype == torch.bool
    # the old state is left as it was
    assert torch.equal(toy["tstate"]["merge_mat"], torch.eye(J))


@torch.no_grad()
def test_simplified_state_changes_the_warp(toy):
    """``get_weights`` and ``warp`` read the new state: the merged
    skinning weights move (columns of merged joints empty), the warped
    cloud moves, and both match the JAX package under its new state."""
    times = np.linspace(0, 1, 20, dtype=np.float32)
    model, old = toy["model"], toy["tstate"]
    new, _ = ttp.simplify_skeleton(model, old, times, deg_threshold=5.0,
                                   five_percent_heuristic=True)
    w_old, w_new = ttp.get_weights(model, old), ttp.get_weights(model, new)
    assert float(w_new[:, TWIN[1]].abs().max()) == 0.0
    assert float(w_new[:, STATIC].abs().max()) == 0.0
    assert float((w_new - w_old).abs().max()) > 1e-3
    torch.testing.assert_close(w_new.sum(-1), torch.ones(P), rtol=0,
                               atol=1e-5)
    rot = np.random.default_rng(3).normal(size=(J, 4)).astype(np.float32)
    rot[:, 3] = 0.4
    x_old = ttp.warp(model, old, rot_params=torch.tensor(rot))["xyz"]
    x_new = ttp.warp(model, new, rot_params=torch.tensor(rot))["xyz"]
    assert float((x_new - x_old).abs().max()) > 1e-3
    jparams = jax.tree_util.tree_map(jnp.asarray, toy["params"])
    jnew, _ = jtp.simplify_skeleton(jparams, toy["cfg"], toy["jstate"],
                                    times, deg_threshold=5.0,
                                    five_percent_heuristic=True)
    want = jtp.warp(jparams, toy["cfg"], jnew, rot_params=jnp.asarray(rot))
    np.testing.assert_allclose(x_new.numpy(), np.asarray(want["xyz"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(w_new.detach().numpy(),
                               np.asarray(want["lbs_weights"]), rtol=0,
                               atol=1e-6)


def test_project_points_vs_jax():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(20, 3)).astype(np.float32) * 0.3
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = _rotations(np.array([0.3]), rng)[0]
    c2w[:3, 3] = [0.1, -0.2, 3.0]
    K = np.array([[140, 0, 8], [0, 140, 6], [0, 0, 1]], np.float32)
    want = np.asarray(jtp.project_points(jnp.asarray(pts), jnp.asarray(c2w),
                                         jnp.asarray(K)))
    got = ttp.project_points(torch.tensor(pts), torch.tensor(c2w),
                             torch.tensor(K)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
