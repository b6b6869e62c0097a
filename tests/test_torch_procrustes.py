"""P1, special Procrustes (``apnerf_torch/kernels/procrustes.py``), on the
CPU: the plain version against the JAX package's ``special_procrustes``
and its gradient against a float64 central difference, at the inputs the
point model makes (one bone's rotation, blends of two and three bones)
and at random matrices, reflections included."""
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apnerf.ops.rotations import special_procrustes as jax_procrustes
from apnerf_torch.kernels import procrustes as pk
from apnerf_torch.ops.rotations import special_procrustes


def _rotations(rng, n):
    """Random rotations (Rodrigues of a random axis and angle), float64."""
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    th = rng.uniform(0.0, np.pi, n)[:, None, None]
    k = np.zeros((n, 3, 3))
    k[:, 0, 1], k[:, 0, 2], k[:, 1, 2] = -axis[:, 2], axis[:, 1], -axis[:, 0]
    k = k - k.transpose(0, 2, 1)
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * (k @ k)


def _cases(rng, n=64):
    r0, r1, r2 = (_rotations(rng, n) for _ in range(3))
    w = rng.dirichlet([1.0, 1.0, 1.0], n)[:, :, None, None]
    return {
        "rotation": r0,
        "two bones": 0.5 * r0 + 0.5 * r1,
        "three bones": w[:, 0] * r0 + w[:, 1] * r1 + w[:, 2] * r2,
        "random": rng.normal(size=(n, 3, 3)),
        "reflection": -r0 + 0.3 * rng.normal(size=(n, 3, 3)),
    }


def _polar64(m):
    """The JAX function's formula in float64."""
    u, s, vt = np.linalg.svd(m)
    d = np.linalg.det(u @ vt)
    ones = np.ones_like(d)
    return (u * np.stack([ones, ones, d], -1)[:, None, :]) @ vt, s, d


def _fd_grad(m, g, eps=1e-6):
    """Central difference of <polar(M), G> in float64."""
    out = np.zeros_like(m)
    for i in range(3):
        for j in range(3):
            e = np.zeros((3, 3))
            e[i, j] = eps
            out[:, i, j] = ((_polar64(m + e)[0] - _polar64(m - e)[0]) * g
                            ).sum((1, 2)) / (2 * eps)
    return out


def _port_grad(m32, g32):
    m = torch.tensor(m32, requires_grad=True)
    special_procrustes(m).backward(torch.tensor(g32))
    return m.grad.numpy()


@pytest.mark.parametrize("case", ["rotation", "two bones", "three bones",
                                  "random", "reflection"])
def test_forward_vs_jax(case):
    """R against the JAX function on the same fp32 inputs, excluding only
    matrices with s2 + d s3 < 1e-3 (near a rank-deficient reflection R is
    ill-conditioned, by 1 / (s2 + d s3), in either package). Tolerance: 2e-5
    + 1e-7 / (s2 + d s3) absolute, two fp32 SVDs' rounding through that
    condition; both are held to float64 at the same bound."""
    m = _cases(np.random.default_rng(0))[case].astype(np.float32)
    want64, s, d = _polar64(m.astype(np.float64))
    cond = s[:, 1] + d * s[:, 2]
    keep = cond >= 1e-3
    assert keep.sum() >= 0.9 * len(m)
    got = special_procrustes(torch.tensor(m)).numpy()
    ref = np.asarray(jax_procrustes(jnp.asarray(m)))
    tol = (2e-5 + 1e-7 / cond[keep])[:, None, None]
    assert (np.abs(got - ref)[keep] <= tol).all()
    assert (np.abs(got - want64)[keep] <= tol).all()
    assert (np.abs(ref - want64)[keep] <= tol).all()
    np.testing.assert_allclose(np.linalg.det(got[keep]), 1.0, atol=1e-5)


def test_shape_and_factors():
    """[..., 3, 3] in and out; the plain factors rebuild M with s'
    descending in magnitude, the sign of det M on the last, and R = U' V^T
    a rotation."""
    rng = np.random.default_rng(1)
    m = rng.normal(size=(2, 5, 3, 3)).astype(np.float32)
    assert special_procrustes(torch.tensor(m)).shape == (2, 5, 3, 3)
    R, U, s, V = pk.procrustes_plain(torch.tensor(m.reshape(-1, 3, 3)))
    rebuilt = U @ torch.diag_embed(s) @ V.transpose(-1, -2)
    np.testing.assert_allclose(rebuilt.numpy(), m.reshape(-1, 3, 3),
                               atol=2e-5)
    # U' and V orthogonal with one determinant (the kernel's: both +1)
    np.testing.assert_allclose(np.abs(torch.linalg.det(U).numpy()), 1.0,
                               atol=1e-5)
    np.testing.assert_allclose(torch.linalg.det(U).numpy(),
                               torch.linalg.det(V).numpy(), atol=1e-5)
    a = s.abs()
    assert (a[:, 0] >= a[:, 1]).all() and (a[:, 1] >= a[:, 2]).all()
    np.testing.assert_array_equal(
        np.sign(s[:, 2].numpy()), np.sign(np.linalg.det(m.reshape(-1, 3,
                                                                    3))))


def _table_rows(rng):
    """The inputs at which the SVD's derivative fails: an exact rotation
    (singular values 1, 1, 1), blends of two rotations (1, c, c), a
    three-bone blend and a blend with two nearly equal weights."""
    r = [_rotations(rng, 8) for _ in range(4)]
    return {
        "one rotation": r[0],
        "0.5 R0 + 0.5 R1": 0.5 * r[0] + 0.5 * r[1],
        "0.9 R2 + 0.1 R3": 0.9 * r[2] + 0.1 * r[3],
        "three bones": 0.5 * r[0] + 0.3 * r[1] + 0.2 * r[2],
        "0.5 / 0.4999 / 1e-4": 0.5 * r[1] + 0.4999 * r[2] + 1e-4 * r[3],
        "random": rng.normal(size=(8, 3, 3)),
        "reflection": -r[0] + 0.3 * rng.normal(size=(8, 3, 3)),
    }


@pytest.mark.parametrize("row", ["one rotation", "0.5 R0 + 0.5 R1",
                                 "0.9 R2 + 0.1 R3", "three bones",
                                 "0.5 / 0.4999 / 1e-4", "random",
                                 "reflection"])
def test_grad_vs_finite_difference(row):
    """The closed-form backward against a float64 central difference of
    the float64 polar factor at the fp32 input, everywhere: at repeated
    singular values too, where torch.linalg.svd's backward gives NaN and
    jax.grad a wrong gradient. Tolerance: 1e-4 of max |fd| + 1e-4, the
    fp32 factors' rounding times the gradient's scale."""
    rng = np.random.default_rng(2)
    m = _table_rows(rng)[row].astype(np.float32)
    g = rng.normal(size=m.shape).astype(np.float32)
    _, s, d = _polar64(m.astype(np.float64))
    assert (s[:, 1] + d * s[:, 2] > 1e-2).all()
    fd = _fd_grad(m.astype(np.float64), g.astype(np.float64))
    got = _port_grad(m, g)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, fd, atol=1e-4 * np.abs(fd).max() + 1e-4,
                               rtol=0)


def test_grad_vs_jax_where_singular_values_are_distinct():
    """Against jax.grad of the JAX function where every gap between two
    singular values is above 0.05 of the largest, where the SVD's
    derivative is sound: rtol 1e-3, atol 1e-4 (two fp32 SVDs' factors
    divided by gaps of 0.05)."""
    rng = np.random.default_rng(3)
    cases = _cases(rng, n=256)
    m = np.concatenate([cases["three bones"], cases["random"],
                        cases["reflection"]]).astype(np.float32)
    s = np.linalg.svd(m.astype(np.float64), compute_uv=False)
    gaps = np.minimum(s[:, 0] - s[:, 1], s[:, 1] - s[:, 2]) / s[:, 0]
    m = m[gaps > 0.05]
    assert len(m) >= 100
    g = rng.normal(size=m.shape).astype(np.float32)
    want = jax.vmap(jax.grad(lambda x, y: jnp.sum(
        jax_procrustes(x[None])[0] * y)))(jnp.asarray(m), jnp.asarray(g))
    np.testing.assert_allclose(_port_grad(m, g), np.asarray(want),
                               rtol=1e-3, atol=1e-4)


def test_jax_grad_is_wrong_at_repeated_singular_values():
    """A fault of the reference, not carried over: at a blend of two
    rotations (singular values 1, c, c) and at an exact rotation jax.grad
    of the JAX function is off the float64 central difference by more than
    0.1 of its scale, where the port's closed form is within 1e-4."""
    rng = np.random.default_rng(4)
    rows = _table_rows(rng)
    for row in ("one rotation", "0.5 R0 + 0.5 R1"):
        m = rows[row].astype(np.float32)
        g = rng.normal(size=m.shape).astype(np.float32)
        fd = _fd_grad(m.astype(np.float64), g.astype(np.float64))
        scale = np.abs(fd).max()
        jg = np.asarray(jax.vmap(jax.grad(lambda x, y: jnp.sum(
            jax_procrustes(x[None])[0] * y)))(jnp.asarray(m),
                                              jnp.asarray(g)))
        jax_err = np.nan_to_num(np.abs(jg - fd), nan=np.inf).max()
        assert jax_err > 0.1 * scale, row
        assert np.abs(_port_grad(m, g) - fd).max() <= 1e-4 * scale + 1e-4


def test_floored_denominator_keeps_the_gradient_finite():
    """M at a rank-deficient reflection (s = 1, c, c with det < 0, so
    s2 + d s3 = 0): every denominator is floored at DEN_FLOOR, the gradient
    is finite and large, and no larger than the floor allows."""
    rng = np.random.default_rng(5)
    r = _rotations(rng, 16)
    c = np.array([1.0, 1e-3, -1e-3])
    m = (r @ (c[:, None] * _rotations(rng, 16))).astype(np.float32)
    g = rng.normal(size=m.shape).astype(np.float32)
    got = _port_grad(m, g)
    assert np.isfinite(got).all()
    assert np.abs(got).max() > 1e2
    # |K_ij| <= 2 max|A| / DEN_FLOOR, max|A| <= 3 max|G|, dM = U K V^T
    assert np.abs(got).max() <= 9 * 6 * np.abs(g).max() / pk.DEN_FLOOR


def test_cuda_tensor_takes_the_kernels_and_never_the_svd():
    """The dispatch: a tensor that is not on the CPU goes to the kernels'
    wrappers, forward and backward, and never to torch.linalg.svd; a CPU
    tensor never to the kernels. The wrappers stand in for the card."""
    rng = np.random.default_rng(6)
    m = torch.tensor(rng.normal(size=(7, 3, 3)).astype(np.float32),
                     requires_grad=True)
    g = torch.tensor(rng.normal(size=(7, 3, 3)).astype(np.float32))
    want_r = special_procrustes(m)
    want_r.backward(g)
    want_g = m.grad.clone()
    m.grad = None
    plain_fwd = pk.procrustes_plain
    calls = []

    def fwd(x):
        calls.append("fwd")
        with mock.patch.object(torch.linalg, "svd", svd_ok):
            return plain_fwd(x)

    def bwd(*args):
        calls.append("bwd")
        return pk.procrustes_grad_plain(*args)

    real_svd = torch.linalg.svd

    def svd_ok(*a, **k):
        return real_svd(*a, **k)

    def no_svd(*a, **k):
        raise AssertionError("torch.linalg.svd on the kernel path")

    with mock.patch.object(pk, "on_cpu", lambda *t: False), \
            mock.patch.object(pk, "procrustes_cuda", fwd), \
            mock.patch.object(pk, "procrustes_grad_cuda", bwd), \
            mock.patch.object(torch.linalg, "svd", no_svd):
        r = special_procrustes(m)
        r.backward(g)
    assert calls == ["fwd", "bwd"]
    assert torch.equal(r, want_r) and torch.equal(m.grad, want_g)
    with mock.patch.object(pk, "procrustes_cuda", no_svd), \
            mock.patch.object(pk, "procrustes_grad_cuda", no_svd):
        special_procrustes(m).sum().backward()
