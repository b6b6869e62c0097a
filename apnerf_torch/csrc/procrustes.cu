// P1: special Procrustes, the nearest rotation of each 3x3 matrix, and its
// gradient.
//
// Counterpart of the XLA SVD that apnerf/ops/rotations.py:47
// (special_procrustes) runs under jit; the JAX package has no TPU kernel
// for it. For M = U' diag(s') V^T with U' and V rotations and
// s' = (s1, s2, d s3), s1 >= s2 >= s3 >= 0, d the sign of det M, the
// forward returns R = U' V^T: the JAX function's U diag(1, 1, det(U V^T))
// V^T. It also writes U', s' and V, which the backward reads.
//
// Forward, one thread a matrix, in registers, fp32:
//  * V from kSweeps cyclic Jacobi sweeps on M^T M, taken one-sided
//    (Hestenes): each rotation is computed from the columns of B = M V, so
//    a small singular value keeps its relative accuracy (M^T M is never
//    formed);
//  * the columns of B sorted by norm, a swap negating one column so that V
//    stays a rotation; the smallest singular value comes last, the one
//    whose sign carries det M;
//  * a Givens QR of B (McAdams et al., "Computing the Singular Value
//    Decomposition of 3x3 matrices with minimal branching and elementary
//    floating point operations", 2011): Q = U' is orthogonal by
//    construction, also where s3 is 0 (M v3 / s3 is never formed), its
//    determinant is +1, and R's diagonal is s' with d on the last entry.
// Backward, one thread a matrix: A = U'^T G V,
// K_ij = (A_ij - A_ji) / max(s'_i + s'_j, kDenFloor) off the diagonal,
// dM = U' K V^T, the derivative of the polar factor in closed form. It
// stays right where two singular values are equal (an exact rotation, a
// blend of two rotations), where the SVD's own derivative divides by
// s_i^2 - s_j^2.
//
// Bound: bytes. The forward reads 36 B and writes 36 B of R and 84 B of
// factors a matrix, the backward reads 120 B and writes 36 B; some 10^3
// flops a matrix. At the main path's 10^4 matrices that is 1.6 MB, about
// 0.5 us at 3.35 TB/s: launch latency sets the time. The kernels allocate
// nothing and read nothing back, so a CUDA graph captures them.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSweeps = 6;
// the floor of the backward's denominators s'_i + s'_j: M near a
// rank-deficient reflection (s2 + d s3 -> 0) gets a large, finite
// gradient; kernels/procrustes.py DEN_FLOOR is the same number
constexpr float kDenFloor = 1e-6f;
// a column pair whose cosine is below this is orthogonal: no rotation
constexpr float kOrthoTol = 1e-7f;

__device__ __forceinline__ void jacobi_pair(float (&B)[3][3],
                                            float (&V)[3][3], int p, int q) {
  float alpha = 0.f, beta = 0.f, gamma = 0.f;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    alpha = fmaf(B[r][p], B[r][p], alpha);
    beta = fmaf(B[r][q], B[r][q], beta);
    gamma = fmaf(B[r][p], B[r][q], gamma);
  }
  if (fabsf(gamma) <= kOrthoTol * sqrtf(alpha) * sqrtf(beta)) return;
  // the rotation that makes columns p and q orthogonal, the smaller angle
  const float zeta = (beta - alpha) / (2.f * gamma);
  const float t = copysignf(1.f, zeta) /
                  (fabsf(zeta) + sqrtf(fmaf(zeta, zeta, 1.f)));
  const float c = 1.f / sqrtf(fmaf(t, t, 1.f));
  const float s = c * t;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float bp = B[r][p], bq = B[r][q];
    B[r][p] = c * bp - s * bq;
    B[r][q] = s * bp + c * bq;
    const float vp = V[r][p], vq = V[r][q];
    V[r][p] = c * vp - s * vq;
    V[r][q] = s * vp + c * vq;
  }
}

// swap columns i and j of B and V and negate the new column j: M V = B
// and det V = +1 still hold
__device__ __forceinline__ void swap_columns(float (&B)[3][3],
                                             float (&V)[3][3],
                                             float (&n)[3], int i, int j) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float b = B[r][i], v = V[r][i];
    B[r][i] = B[r][j];
    V[r][i] = V[r][j];
    B[r][j] = -b;
    V[r][j] = -v;
  }
  const float t = n[i];
  n[i] = n[j];
  n[j] = t;
}

// rows p and q of B rotated so that B[q][col] becomes 0 and B[p][col]
// sqrt(B[p][col]^2 + B[q][col]^2) >= 0; Q takes the transposed rotation
// (B = Q R throughout)
__device__ __forceinline__ void givens(float (&B)[3][3], float (&Q)[3][3],
                                       int p, int q, int col) {
  const float a = B[p][col], b = B[q][col];
  const float rho = sqrtf(fmaf(a, a, b * b));
  if (rho == 0.f) return;
  const float c = a / rho, s = b / rho;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float bp = B[p][k], bq = B[q][k];
    B[p][k] = c * bp + s * bq;
    B[q][k] = c * bq - s * bp;
    const float qp = Q[k][p], qq = Q[k][q];
    Q[k][p] = c * qp + s * qq;
    Q[k][q] = c * qq - s * qp;
  }
  B[q][col] = 0.f;
}

__global__ void __launch_bounds__(kThreads)
procrustes_kernel(const float* __restrict__ M, int P, float* __restrict__ R,
                  float* __restrict__ U, float* __restrict__ S,
                  float* __restrict__ V) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  float B[3][3], Vm[3][3], Q[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      B[i][j] = M[9 * p + 3 * i + j];
      Vm[i][j] = i == j ? 1.f : 0.f;
      Q[i][j] = i == j ? 1.f : 0.f;
    }
  }
#pragma unroll 1
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    jacobi_pair(B, Vm, 0, 1);
    jacobi_pair(B, Vm, 0, 2);
    jacobi_pair(B, Vm, 1, 2);
  }
  float n[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    n[j] = fmaf(B[0][j], B[0][j], fmaf(B[1][j], B[1][j], B[2][j] * B[2][j]));
  if (n[0] < n[1]) swap_columns(B, Vm, n, 0, 1);
  if (n[0] < n[2]) swap_columns(B, Vm, n, 0, 2);
  if (n[1] < n[2]) swap_columns(B, Vm, n, 1, 2);
  givens(B, Q, 0, 1, 0);
  givens(B, Q, 0, 2, 0);
  givens(B, Q, 1, 2, 1);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      R[9 * p + 3 * i + j] = fmaf(Q[i][0], Vm[j][0],
                                  fmaf(Q[i][1], Vm[j][1], Q[i][2] * Vm[j][2]));
      U[9 * p + 3 * i + j] = Q[i][j];
      V[9 * p + 3 * i + j] = Vm[i][j];
    }
    S[3 * p + i] = B[i][i];
  }
}

__global__ void __launch_bounds__(kThreads)
procrustes_grad_kernel(const float* __restrict__ G,
                       const float* __restrict__ U,
                       const float* __restrict__ S,
                       const float* __restrict__ V, int P,
                       float* __restrict__ dM) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  float g[3][3], u[3][3], v[3][3], s[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      g[i][j] = G[9 * p + 3 * i + j];
      u[i][j] = U[9 * p + 3 * i + j];
      v[i][j] = V[9 * p + 3 * i + j];
    }
    s[i] = S[3 * p + i];
  }
  float t[3][3], a[3][3], k[3][3], w[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)  // t = G V
#pragma unroll
    for (int j = 0; j < 3; ++j)
      t[i][j] = fmaf(g[i][0], v[0][j], fmaf(g[i][1], v[1][j], g[i][2] * v[2][j]));
#pragma unroll
  for (int i = 0; i < 3; ++i)  // a = U'^T G V
#pragma unroll
    for (int j = 0; j < 3; ++j)
      a[i][j] = fmaf(u[0][i], t[0][j], fmaf(u[1][i], t[1][j], u[2][i] * t[2][j]));
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      k[i][j] = i == j ? 0.f
                       : (a[i][j] - a[j][i]) / fmaxf(s[i] + s[j], kDenFloor);
#pragma unroll
  for (int i = 0; i < 3; ++i)  // w = U' K
#pragma unroll
    for (int j = 0; j < 3; ++j)
      w[i][j] = fmaf(u[i][0], k[0][j], fmaf(u[i][1], k[1][j], u[i][2] * k[2][j]));
#pragma unroll
  for (int i = 0; i < 3; ++i)  // dM = U' K V^T
#pragma unroll
    for (int j = 0; j < 3; ++j)
      dM[9 * p + 3 * i + j] =
          fmaf(w[i][0], v[j][0], fmaf(w[i][1], v[j][1], w[i][2] * v[j][2]));
}

}  // namespace

// M [P, 3, 3] fp32 -> R [P, 3, 3], U' [P, 3, 3], s' [P, 3], V [P, 3, 3]
extern "C" int procrustes_launch(const float* M, int P, float* R, float* U,
                                 float* S, float* V, void* stream) {
  if (P <= 0) return 0;
  procrustes_kernel<<<(P + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(M, P, R, U, S, V);
  return static_cast<int>(cudaGetLastError());
}

// G = dL/dR [P, 3, 3] and the forward's U', s', V -> dM [P, 3, 3]
extern "C" int procrustes_grad_launch(const float* G, const float* U,
                                      const float* S, const float* V, int P,
                                      float* dM, void* stream) {
  if (P <= 0) return 0;
  procrustes_grad_kernel<<<(P + kThreads - 1) / kThreads, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(G, U, S, V,
                                                                P, dM);
  return static_cast<int>(cudaGetLastError());
}
