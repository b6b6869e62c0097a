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


# ----------------------------------------------------------------------
# A CPU model of the kernels (csrc/procrustes.cu): their arithmetic in
# float32 numpy, one matrix a row: the power-of-two scaling, the one-sided
# Jacobi rotations with the skip test gamma^2 <= 2^-46 alpha beta, the
# sweeps ended by a vote of each warp of 32 matrices (at most
# MODEL_MAX_SWEEPS), the column sort with its negated swaps, the Givens QR
# and the backward's three entries of K. Where the kernel takes the
# special-function unit's estimate of a square root or a quotient, the
# model takes the correctly rounded one: the estimates (with the Newton
# step the kernel gives the cosines) are within about an ulp of it.
# ----------------------------------------------------------------------

F32 = np.float32
MODEL_ORTHO_TOL2 = F32(2.0 ** -46)     # kOrthoTol2
MODEL_TINY = F32(1e-36)                 # kTiny
MODEL_MAX_SWEEPS = 6                    # kMaxSweeps
MODEL_WARP = 32


def _model_forward(m):
    """(R, U', s', V, sweeps a matrix) as the forward kernel makes them."""
    m = np.asarray(m, F32)
    n = len(m)
    finite = np.isfinite(m).reshape(n, 9).all(1)
    mx = np.abs(np.where(np.isfinite(m), m, 0)).reshape(n, 9).max(1)
    _, e = np.frexp(mx)
    e = np.where(mx > 0, e, 0)
    # 2^-e and 2^e in two factors each, as the kernel takes them
    lo, hi = np.ldexp(F32(1), -(e >> 1)), np.ldexp(F32(1), (e >> 1) - e)
    B = m * lo[:, None, None] * hi[:, None, None]
    V = np.tile(np.eye(3, dtype=F32), (n, 1, 1))
    sweeps = np.zeros(n, int)
    live = np.ones(n, bool)
    warps = np.arange(n) // MODEL_WARP
    for _ in range(MODEL_MAX_SWEEPS):
        rotated = np.zeros(n, bool)
        for p, q in ((0, 1), (0, 2), (1, 2)):
            bp, bq = B[:, :, p], B[:, :, q]
            alpha = (bp * bp).sum(1, dtype=F32)
            beta = (bq * bq).sum(1, dtype=F32)
            gamma = (bp * bq).sum(1, dtype=F32)
            g2 = gamma * gamma
            rot = live & (g2 > np.maximum(MODEL_ORTHO_TOL2 * alpha * beta,
                                          MODEL_TINY))
            tau = beta - alpha
            num = np.where(tau >= 0, F32(2) * gamma, F32(-2) * gamma)
            x = np.where(rot, tau * tau + F32(4) * g2, F32(1))
            t = num / (np.abs(tau) + np.sqrt(x))
            c = F32(1) / np.sqrt(t * t + F32(1))
            c, s = np.where(rot, c, F32(1)), np.where(rot, c * t, F32(0))
            for X in (B, V):
                xp, xq = X[:, :, p].copy(), X[:, :, q].copy()
                X[:, :, p] = c[:, None] * xp - s[:, None] * xq
                X[:, :, q] = s[:, None] * xp + c[:, None] * xq
            rotated |= rot
        sweeps += live
        live &= np.isin(warps, warps[rotated])
        if not live.any():
            break
    nrm = (B * B).sum(1, dtype=F32)
    for i, j in ((0, 1), (0, 2), (1, 2)):
        sw = nrm[:, i] < nrm[:, j]
        for X in (B, V):
            xi, xj = X[sw, :, i].copy(), X[sw, :, j].copy()
            X[sw, :, i], X[sw, :, j] = xj, -xi
        nrm[sw, i], nrm[sw, j] = nrm[sw, j], nrm[sw, i].copy()
    Q = np.tile(np.eye(3, dtype=F32), (n, 1, 1))
    for p, q, col in ((0, 1, 0), (0, 2, 0), (1, 2, 1)):
        a, b = B[:, p, col].copy(), B[:, q, col].copy()
        rho2 = a * a + b * b
        ok = rho2 >= MODEL_TINY
        r = F32(1) / np.sqrt(np.where(ok, rho2, F32(1)))
        c, s = np.where(ok, a * r, F32(1)), np.where(ok, b * r, F32(0))
        bp, bq = B[:, p, :].copy(), B[:, q, :].copy()
        B[:, p, :] = c[:, None] * bp + s[:, None] * bq
        B[:, q, :] = c[:, None] * bq - s[:, None] * bp
        qp, qq = Q[:, :, p].copy(), Q[:, :, q].copy()
        Q[:, :, p] = c[:, None] * qp + s[:, None] * qq
        Q[:, :, q] = c[:, None] * qq - s[:, None] * qp
        B[ok, q, col] = 0
    S = (np.stack([B[:, i, i] for i in range(3)], 1)
         * np.ldexp(F32(1), e >> 1)[:, None]
         * np.ldexp(F32(1), e - (e >> 1))[:, None])
    R = Q @ V.transpose(0, 2, 1)
    nan = ~finite
    R[nan], Q[nan], V[nan], S[nan] = np.nan, np.nan, np.nan, np.nan
    return R.astype(F32), Q, S.astype(F32), V, sweeps


def _model_backward(G, U, s, V, floor=F32(pk.DEN_FLOOR)):
    """dM as the backward kernel makes it: K's three entries above the
    diagonal from A = U'^T G V, the denominators floored."""
    A = U.transpose(0, 2, 1) @ np.asarray(G, F32) @ V
    k = np.zeros_like(A)
    for i, j in ((0, 1), (0, 2), (1, 2)):
        k[:, i, j] = (A[:, i, j] - A[:, j, i]) / np.maximum(s[:, i] + s[:, j],
                                                            floor)
        k[:, j, i] = -k[:, i, j]
    return ((U @ k) @ V.transpose(0, 2, 1)).astype(F32)


@pytest.mark.parametrize("case", ["rotation", "two bones", "three bones",
                                  "random", "reflection"])
def test_kernel_model_forward_vs_float64_and_jax(case):
    """The kernels' arithmetic on test_forward_vs_jax's inputs: R against
    the JAX function and against float64 at that test's bound (2e-5 +
    1e-7 / (s2 + d s3)); the factors rebuild M, U' and V are rotations,
    |s'| descends (to an ulp of s'_1, where singular values repeat) and
    s'_3 carries the sign of det M; no warp reaches the
    sweep cap, and exact rotations take one sweep."""
    m = _cases(np.random.default_rng(0))[case].astype(np.float32)
    want64, s64, d = _polar64(m.astype(np.float64))
    cond = s64[:, 1] + d * s64[:, 2]
    keep = cond >= 1e-3
    R, U, S, V, sweeps = _model_forward(m)
    ref = np.asarray(jax_procrustes(jnp.asarray(m)))
    tol = (2e-5 + 1e-7 / cond[keep])[:, None, None]
    assert (np.abs(R - ref)[keep] <= tol).all()
    assert (np.abs(R - want64)[keep] <= tol).all()
    np.testing.assert_allclose(np.linalg.det(R[keep]), 1.0, atol=1e-5)
    rebuilt = U @ (S[:, :, None] * V.transpose(0, 2, 1))
    np.testing.assert_allclose(rebuilt, m, atol=2e-5)
    for X in (U, V):
        np.testing.assert_allclose(X @ X.transpose(0, 2, 1),
                                   np.broadcast_to(np.eye(3), X.shape),
                                   atol=2e-6)
        np.testing.assert_allclose(np.linalg.det(X), 1.0, atol=2e-6)
    a = np.abs(S)
    ulp = 2.0 ** -22 * a[:, 0]     # repeated singular values' rounding
    assert (a[:, 0] >= a[:, 1] - ulp).all()
    assert (a[:, 1] >= a[:, 2] - ulp).all()
    np.testing.assert_array_equal(np.sign(S[:, 2]), np.sign(np.linalg.det(m)))
    assert sweeps.max() < MODEL_MAX_SWEEPS
    if case == "rotation":
        assert (sweeps == 1).all()


@pytest.mark.parametrize("row", ["one rotation", "0.5 R0 + 0.5 R1",
                                 "0.9 R2 + 0.1 R3", "three bones",
                                 "0.5 / 0.4999 / 1e-4", "random",
                                 "reflection"])
def test_kernel_model_grad_vs_finite_difference(row):
    """The backward kernel's arithmetic on the forward model's factors
    against test_grad_vs_finite_difference's float64 central difference,
    at that test's tolerance (1e-4 of max |fd| + 1e-4)."""
    rng = np.random.default_rng(2)
    m = _table_rows(rng)[row].astype(np.float32)
    g = rng.normal(size=m.shape).astype(np.float32)
    fd = _fd_grad(m.astype(np.float64), g.astype(np.float64))
    _, U, S, V, _ = _model_forward(m)
    got = _model_backward(g, U, S, V)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, fd, atol=1e-4 * np.abs(fd).max() + 1e-4,
                               rtol=0)


def test_kernel_model_edge_inputs():
    """Inputs the scaling and the floors are for: M = 0 gives R = I, s' =
    0; a matrix scaled by 2^40 or 2^-40 gives the same R and U', V and s'
    scaled by the same power (the scaling is exact); a NaN comes out as
    NaN, not as the identity. At the ends of the exponent range: a
    denormal M (largest entry below 2^-126) gives the R, U', V of the same
    matrix scaled up by 2^135 and its s' scaled down (rounded once), and
    M = diag(1.5, 1, 0.5) 2^127 (largest exponent 128) its finite s'."""
    rng = np.random.default_rng(7)
    m = rng.normal(size=(4, 3, 3)).astype(np.float32)
    m[0] = 0
    m[3, 1, 2] = np.nan
    R, U, S, V, _ = _model_forward(m)
    np.testing.assert_array_equal(R[0], np.eye(3))
    np.testing.assert_array_equal(S[0], 0)
    assert np.isnan(R[3]).all() and np.isnan(S[3]).all()
    for p in (40, -40):
        R2, U2, S2, V2, _ = _model_forward(m[1:3] * F32(2.0 ** p))
        np.testing.assert_array_equal(R2, R[1:3])
        np.testing.assert_array_equal(U2, U[1:3])
        np.testing.assert_array_equal(S2, S[1:3] * F32(2.0 ** p))
    md = m[1:3] * F32(2.0 ** -135)
    assert np.abs(md).max() < F32(2.0 ** -126)
    Rd, Ud, Sd, Vd, _ = _model_forward(md)
    Ru, Uu, Su, Vu, _ = _model_forward(np.ldexp(md, 135))
    assert np.isfinite(Rd).all() and np.isfinite(Sd).all()
    np.testing.assert_array_equal(Rd, Ru)
    np.testing.assert_array_equal(Ud, Uu)
    np.testing.assert_array_equal(Vd, Vu)
    np.testing.assert_array_equal(Sd, Su * F32(2.0 ** -135))
    big = np.diag(np.array([1.5, 1.0, 0.5], F32))[None] * F32(2.0 ** 127)
    Rb, _, Sb, _, _ = _model_forward(big)
    np.testing.assert_array_equal(Rb[0], np.eye(3))
    np.testing.assert_array_equal(Sb[0], np.diag(big[0]))
