"""P1: special Procrustes, the nearest rotation of 3x3 matrices, with its
gradient (``csrc/procrustes.cu``).

Counterpart of the XLA SVD that ``apnerf/ops/rotations.py:47``
(``special_procrustes``) runs; there is no TPU kernel. For ``M [P, 3, 3]``
= U' diag(s') V^T, with U' and V rotations and the singular values in
descending order, the last one carrying the sign of det M, the forward
returns ``R = U' V^T`` (the JAX function's ``U diag(1, 1, det(U V^T))
V^T``) and keeps U', s' and V for the backward.

The backward is the polar factor's derivative in closed form:
``A = U'^T G V``, ``K_ij = (A_ij - A_ji) / max(s'_i + s'_j, DEN_FLOOR)``
off the diagonal, ``dM = U' K V^T``. The SVD's own derivative divides by
``s_i^2 - s_j^2``, which is 0 at an exact rotation and at a blend of two
rotations: ``torch.linalg.svd``'s backward gives NaN there, ``jax.grad``
of the JAX function a wrong gradient. The floor keeps the gradient finite
at M near a rank-deficient reflection (``s2 + d s3`` -> 0).

``special_procrustes`` takes the plain version (``torch.linalg.svd`` and
the closed form in PyTorch) for CPU tensors and the kernels for CUDA
tensors; ``procrustes_cuda`` / ``procrustes_grad_cuda`` count their
launches as ``procrustes`` / ``procrustes_grad``.
"""
from __future__ import annotations

import torch

from . import LAUNCHES, check, on_cpu, raise_on_error, stream_handle

DEN_FLOOR = 1e-6     # csrc/procrustes.cu kDenFloor


def procrustes_plain(M: torch.Tensor):
    """Plain PyTorch version of the forward: ``M [P, 3, 3]`` -> (R, U',
    s' [P, 3], V), from ``torch.linalg.svd`` and ``det(U V^T)`` as the
    JAX function takes them. U' and V are orthogonal with one determinant,
    which may be -1 here (the kernel's are rotations); R is the same."""
    u, s, vt = torch.linalg.svd(M)
    det = torch.linalg.det(u @ vt)
    d = torch.cat([torch.ones_like(s[:, :2]), det[:, None]], -1)
    u = u * d[:, None, :]
    return u @ vt, u, s * d, vt.transpose(-1, -2)


def procrustes_grad_plain(G: torch.Tensor, U: torch.Tensor, s: torch.Tensor,
                          V: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the backward: ``G = dL/dR`` and the
    forward's factors -> ``dL/dM``."""
    A = U.transpose(-1, -2) @ G @ V
    den = torch.clamp(s[:, :, None] + s[:, None, :], min=DEN_FLOOR)
    K = (A - A.transpose(-1, -2)) / den      # diagonal: exactly 0
    return U @ K @ V.transpose(-1, -2)


def procrustes_cuda(M: torch.Tensor):
    """Launch the forward kernel on ``M``'s CUDA device -> (R, U', s',
    V)."""
    P = M.shape[0]
    check(M, "M", torch.float32, (P, 3, 3))
    from .build import load_library
    lib = load_library()
    R = torch.empty_like(M)
    U = torch.empty_like(M)
    V = torch.empty_like(M)
    s = torch.empty((P, 3), dtype=torch.float32, device=M.device)
    if P:
        LAUNCHES["procrustes"] += 1
        raise_on_error(lib.procrustes_launch(
            M.data_ptr(), P, R.data_ptr(), U.data_ptr(), s.data_ptr(),
            V.data_ptr(), stream_handle(M)), "procrustes")
    return R, U, s, V


def procrustes_grad_cuda(G: torch.Tensor, U: torch.Tensor, s: torch.Tensor,
                         V: torch.Tensor) -> torch.Tensor:
    """Launch the backward kernel on the tensors' CUDA device -> dM."""
    P = G.shape[0]
    for t, name in ((G, "G"), (U, "U"), (V, "V")):
        check(t, name, torch.float32, (P, 3, 3))
    check(s, "s", torch.float32, (P, 3))
    from .build import load_library
    lib = load_library()
    dM = torch.empty_like(G)
    if P:
        LAUNCHES["procrustes_grad"] += 1
        raise_on_error(lib.procrustes_grad_launch(
            G.data_ptr(), U.data_ptr(), s.data_ptr(), V.data_ptr(), P,
            dM.data_ptr(), stream_handle(G)), "procrustes_grad")
    return dM


class _Procrustes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, M):
        fwd = procrustes_plain if on_cpu(M) else procrustes_cuda
        R, U, s, V = fwd(M)
        ctx.save_for_backward(U, s, V)
        return R

    @staticmethod
    def backward(ctx, G):
        U, s, V = ctx.saved_tensors
        bwd = procrustes_grad_plain if on_cpu(G) else procrustes_grad_cuda
        return bwd(G.contiguous(), U, s, V)


def special_procrustes(M: torch.Tensor) -> torch.Tensor:
    """Nearest rotation of each matrix of ``M [..., 3, 3]`` (fp32), with
    the closed-form gradient: the kernels on a CUDA tensor, the plain
    version on a CPU tensor."""
    shape = M.shape
    R = _Procrustes.apply(M.reshape(-1, 3, 3).contiguous())
    return R.reshape(shape)
