"""The port's ray, compaction and marching helpers of stage 1 and its
synthetic arm scene against the JAX package on the CPU: the same numpy
inputs through both, fp32 at rtol 1e-5 / atol 1e-6 unless stated."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apnerf.data import rays as jdr
from apnerf.data import synthetic as jsyn
from apnerf.data.dnerf import pose_spherical as jpose
from apnerf.ops import compaction as jc
from apnerf.ops import marching as jm
from apnerf.ops import rays as jr
from apnerf_torch.data import rays as tdr
from apnerf_torch.data import synthetic as tsyn
from apnerf_torch.ops import compaction as tc
from apnerf_torch.ops import marching as tm
from apnerf_torch.ops import rays as tr

RTOL, ATOL = 1e-5, 1e-6
H, W = 12, 16
K = np.array([[20.0, 0, 8.0], [0, 21.0, 6.0], [0, 0, 1]], np.float32)
LO = np.array([-0.6, -0.5, -0.7], np.float32)
HI = np.array([0.5, 0.6, 0.4], np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _c2w(theta=30.0):
    return np.asarray(jpose(theta, -25.0, 3.0), np.float32)


CONVENTIONS = {
    "opengl_center": dict(),
    "opencv_lefttop": dict(inverse_y=True, mode="lefttop"),
    "flips": dict(flip_x=True, flip_y=True),
    "ndc": dict(ndc=True),
}


@pytest.mark.parametrize("conv", list(CONVENTIONS))
def test_get_rays_of_a_view_vs_jax(conv):
    kw = CONVENTIONS[conv]
    want = jr.get_rays_of_a_view(H, W, K, _c2w(), **kw)
    got = tr.get_rays_of_a_view(H, W, K, _c2w(), **kw)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape == (H, W, 3)
        _close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("conv", ["opengl_center", "opencv_lefttop", "flips"])
def test_pixels_to_rays_and_ray_index_vs_jax(conv):
    """Per-pixel rays of a batch (two cameras), then the training-pixel
    index whose bbox test they feed: the same pixels in the same order."""
    kw = CONVENTIONS[conv]
    Ks = np.stack([K, K * [[1.1], [1.0], [1.0]]]).astype(np.float32)
    poses = np.stack([_c2w(30.0), _c2w(150.0)])
    if kw.get("inverse_y"):
        poses[:, :3, 1:3] *= -1.0          # OpenGL -> OpenCV camera axes
    rng = np.random.default_rng(0)
    cam = rng.integers(0, 2, 50)
    pix = rng.integers(0, H * W, 50)
    want = jdr.pixels_to_rays(jnp.asarray(Ks), jnp.asarray(poses),
                              jnp.asarray(cam), jnp.asarray(pix), H, W, **kw)
    got = tdr.pixels_to_rays(torch.tensor(Ks), torch.tensor(poses),
                             torch.tensor(cam), torch.tensor(pix), H, W, **kw)
    for g, w in zip(got, want):
        _close(g, w)
    flags = {k: v for k, v in kw.items() if k != "mode"}
    images = rng.random((3, H, W, 3)).astype(np.float32)
    masks = (rng.random((3, H, W, 1)) * 255).astype(np.float32)
    args = (list(images), list(masks), np.array([0.0, 0.5, 0.5], np.float32),
            np.array([0, 1, 0]), poses, Ks, H, W, LO * 2, HI * 2, 2.0, 4.0)
    ji = jdr.build_ray_index(*args, **flags)
    ti = tdr.build_ray_index(*args, **flags)
    assert 0 < ti.n < 3 * H * W
    for k in ("rgb", "mask", "pix_id", "img_of", "img_time", "img_cam"):
        np.testing.assert_array_equal(getattr(ti, k), getattr(ji, k), k)
    assert ti.index_to_times == ji.index_to_times
    sel = next(jdr.batch_index_generator(ji.n, 20, seed=4))
    np.testing.assert_array_equal(
        next(tdr.batch_index_generator(ti.n, 20, seed=4)), sel)
    for g, w in zip(ti.gather(sel), ji.gather(sel)):
        np.testing.assert_array_equal(g, w)


def test_sample_pts_on_rays_vs_jax():
    """Dense samples, step counts and bbox hits; ``valid`` is compared away
    from the bbox faces, where the in-bbox test is fp-fragile between
    programs (tests/test_occ_group.py)."""
    rng = np.random.default_rng(1)
    o = np.asarray(_c2w()[:3, 3], np.float32) + rng.normal(
        scale=0.05, size=(64, 3)).astype(np.float32)
    d = (rng.normal(scale=0.3, size=(64, 3)) - o).astype(np.float32)
    d[::9, 1] = 0.0                                  # axis-parallel rays
    S = tr.max_n_steps(LO, HI, 0.07)
    assert S == jr.max_n_steps(LO, HI, 0.07)
    want = jr.sample_pts_on_rays(jnp.asarray(o), jnp.asarray(d), LO, HI, 0.5,
                                 6.0, 0.07, S)
    got = tr.sample_pts_on_rays(torch.tensor(o), torch.tensor(d), LO, HI,
                                0.5, 6.0, 0.07, S)
    _close(got.pts, want.pts, atol=1e-5)
    _close(got.t_min, want.t_min)
    np.testing.assert_array_equal(got.n_steps.numpy(),
                                  np.asarray(want.n_steps))
    np.testing.assert_array_equal(got.step_id.numpy(),
                                  np.asarray(want.step_id))
    pts = np.asarray(want.pts)
    margin = np.minimum(np.abs(pts - LO), np.abs(pts - HI)).min(-1)
    far = margin > 1e-4
    np.testing.assert_array_equal(got.valid.numpy()[far],
                                  np.asarray(want.valid)[far])
    assert got.valid.any() and not got.valid.all()
    hit_j = jr.rays_hit_bbox(jnp.asarray(o), jnp.asarray(d), LO, HI, 0.5, 6.0)
    hit_t = tr.rays_hit_bbox(torch.tensor(o), torch.tensor(d), LO, HI, 0.5,
                             6.0)
    np.testing.assert_array_equal(hit_t.numpy(), np.asarray(hit_j))
    assert hit_t.any() and not hit_t.all()


@pytest.mark.parametrize("budget", [40, 300])
def test_compaction_vs_jax(budget):
    """compact_flat over a budget below and above the valid count,
    scatter_back and its gradient (a gather of the cotangent at the
    filled slots), the dilation and the occupancy lookup: all exact."""
    rng = np.random.default_rng(2)
    valid = rng.random(256) < 0.4
    js, jf = jc.compact_flat(jnp.asarray(valid), budget)
    ts, tf = tc.compact_flat(torch.tensor(valid), budget)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    vals = rng.normal(size=(budget, 3)).astype(np.float32)
    want = jc.scatter_back(jnp.asarray(vals), js, 256, fill=-1.0)
    v = torch.tensor(vals, requires_grad=True)
    got = tc.scatter_back(v, ts, 256, fill=-1.0)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    cot = rng.normal(size=(256, 3)).astype(np.float32)
    (got * torch.tensor(cot)).sum().backward()
    dv = jax.grad(lambda x: (jc.scatter_back(x, js, 256) * cot).sum())(
        jnp.asarray(vals))
    np.testing.assert_array_equal(v.grad.numpy(), np.asarray(dv))

    flags = rng.random((7, 6, 5)) < 0.05
    occ_j = jc.build_occupancy_grid(jnp.asarray(flags))
    occ_t = tc.build_occupancy_grid(torch.tensor(flags))
    np.testing.assert_array_equal(occ_t.numpy(), np.asarray(occ_j))
    pts = rng.uniform(-0.8, 0.7, size=(500, 3)).astype(np.float32)
    want = jc.occupancy_lookup_xyz(occ_j, jnp.asarray(LO), jnp.asarray(HI),
                                   jnp.asarray(pts))
    got = tc.occupancy_lookup_xyz(occ_t, torch.tensor(LO), torch.tensor(HI),
                                  torch.tensor(pts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got.all()


def test_weights_and_distortion_grads_vs_jax():
    """alpha2weights and the distortion loss, values and d/dalpha through
    torch's cumprod backward against JAX's: rays that stop early, rays
    that do not, and one ray with an opaque sample (alpha exactly 1, a zero
    factor in the product). Gradients at rtol 1e-4 / atol 1e-6."""
    rng = np.random.default_rng(3)
    alpha = rng.random((12, 20)).astype(np.float32)
    alpha[:6] *= 0.05
    alpha[11, 4] = 1.0
    valid = rng.random((12, 20)) > 0.2
    valid[11, 4] = True
    s = np.sort(rng.random((12, 20)), -1).astype(np.float32)
    vals = rng.random((12, 20, 3)).astype(np.float32)

    def jloss(a):
        w, last = jm.alpha2weights(a, jnp.asarray(valid))
        rgb = jm.composite(w, jnp.asarray(vals), bg=1.0, alphainv_last=last)
        dist = jm.distortion_loss(w, jnp.asarray(s), 0.01, jnp.asarray(valid))
        return (rgb ** 2).sum() + 3.0 * dist, dist

    (_, dist_j), da_j = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(alpha))
    a = torch.tensor(alpha, requires_grad=True)
    w, last = tm.alpha2weights(a, torch.tensor(valid))
    rgb = tm.composite(w, torch.tensor(vals), bg=1.0, alphainv_last=last)
    dist_t = tm.distortion_loss(w, torch.tensor(s), 0.01, torch.tensor(valid))
    ((rgb ** 2).sum() + 3.0 * dist_t).backward()
    _close(dist_t.item(), float(dist_j))
    assert np.isfinite(a.grad.numpy()).all()
    _close(a.grad, da_j, rtol=1e-4, atol=1e-6)


def test_synthetic_scene_vs_jax():
    """pose_spherical, the analytic density and colour, and a rendered view
    at float64 (1e-12); make_scene's views are those renders on white."""
    c2w = tsyn.pose_spherical(75.0, -25.0, 4.0)
    np.testing.assert_array_equal(c2w, jpose(75.0, -25.0, 4.0))
    pts = np.random.default_rng(4).uniform(-1, 1, size=(400, 3))
    for t in (0.0, 0.7):
        for g, w in zip(tsyn.density_and_color(pts, t),
                        jsyn.density_and_color(pts, t)):
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)
    focal = 0.5 * W / np.tan(0.4)
    got = tsyn.render_image(np.asarray(c2w, np.float64), H, W, focal, 0.4,
                            n_steps=48)
    want = jsyn.render_image(np.asarray(c2w, np.float64), H, W, focal, 0.4,
                             n_steps=48)
    assert (want[..., 3] > 0.5).any() and (want[..., 3] == 0).any()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)

    data = tsyn.make_scene(3, H, W, seed=5)
    assert data["images"].shape == (3, H, W, 3)
    assert data["masks"].shape == (3, H, W, 1)
    np.testing.assert_array_equal(data["times"], [0.0, 0.5, 1.0])
    f = data["hwf"][2]
    for k in range(3):
        rgba = jsyn.render_image(np.asarray(data["poses"][k], np.float64), H,
                                 W, f, float(data["times"][k]))
        rgba = rgba.astype(np.float32)
        np.testing.assert_allclose(
            data["images"][k], rgba[..., :3] * rgba[..., 3:]
            + (1.0 - rgba[..., 3:]), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(data["masks"][k], rgba[..., 3:])
