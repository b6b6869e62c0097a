// P1: special Procrustes, the nearest rotation of each 3x3 matrix, and its
// gradient (P1').
//
// Counterpart of the XLA SVD that apnerf/ops/rotations.py:47
// (special_procrustes) runs under jit; the JAX package has no TPU kernel
// for it. For M = U' diag(s') V^T with U' and V rotations and
// s' = (s1, s2, d s3), s1 >= s2 >= s3 >= 0, d the sign of det M, the
// forward returns R = U' V^T: the JAX function's U diag(1, 1, det(U V^T))
// V^T. It also writes U', s' and V, which the backward reads.
//
// Forward, one thread a matrix, in registers, fp32:
//  * M scaled by a power of two to entries below 1 in magnitude (exact,
//    denormal M too; R does not change, s' is scaled back), so that the
//    squared tests below neither overflow nor underflow;
//  * V from cyclic one-sided Jacobi sweeps (Hestenes) on B = M V: each
//    rotation is computed from the columns of B, so a small singular value
//    keeps its relative accuracy (M^T M is never formed). A pair is
//    skipped when gamma^2 <= 2^-46 alpha beta (its cosine is at most
//    2^-23, an ulp of 1); the sweeps stop when no lane of the warp
//    rotated in a sweep (a warp vote, so the lanes never diverge on the
//    loop), at most kMaxSweeps;
//  * the columns of B sorted by norm, a swap negating one column so that V
//    stays a rotation; the smallest singular value comes last, the one
//    whose sign carries det M;
//  * a Givens QR of B (McAdams et al., "Computing the Singular Value
//    Decomposition of 3x3 matrices with minimal branching and elementary
//    floating point operations", 2011): Q = U' is orthogonal by
//    construction, also where s3 is 0 (M v3 / s3 is never formed), its
//    determinant is +1, and R's diagonal is s' with d on the last entry.
// Every square root and division on that chain is the special-function
// unit's estimate: the rotations' cosines and the QR's 1 / rho take one
// Newton step (within about an ulp, which keeps c^2 + s^2 = 1 as the IEEE
// sqrtf and division did), the Jacobi angle's sqrt and division none (an
// angle a few ulp off leaves a residue that the next sweep's test sees).
// Backward, one thread a matrix: A = U'^T G V,
// K_ij = (A_ij - A_ji) / max(s'_i + s'_j, kDenFloor) off the diagonal
// (three entries; K is skew), dM = U' K V^T, the derivative of the polar
// factor in closed form. It stays right where two singular values are
// equal (an exact rotation, a blend of two rotations), where the SVD's
// own derivative divides by s_i^2 - s_j^2.
//
// Bound: bytes. The forward reads 36 B and writes 36 B of R and 84 B of
// factors a matrix, the backward reads 120 B and writes 36 B: at the main
// path's 10^4 matrices 1.6 MB, 0.47 us at 3.35 TB/s, below a launch's
// latency, so there a kernel's time is its launch, one load's latency and
// one matrix's dependent chain; at 2^20 matrices 164 MB, 49 us.
// What held the first kernels back (128 threads a block, six fixed sweeps
// with IEEE sqrtf and division, each thread's 9 + 30 / 30 + 9 scalar
// accesses at a 36-byte stride; ptxas: 40 / 46 registers, no stack frame,
// no spills, so not local memory), read on an H100 by chip_smoke.py's
// phase 3 on a tree holding their source: at 10^4 8.3 / 3.0 us a launch
// inside a CUDA graph (their 22 / 17 us "queued" was the wrapper's host
// work a call); at 2^20 0.32 / 0.080 ms, 15% / 61% of the bound, the
// forward held by its chain (18 rotations' IEEE sequences a matrix) and
// both by the strided accesses. What this design does about it:
//  * the chain: the sweeps stop at convergence (in the CPU model of
//    tests/test_torch_procrustes.py a warp of exact rotations takes one
//    sweep, of blends of two or three bones three to five, the last
//    finding nothing to rotate), and the special-function estimates
//    replace the IEEE sequences;
//  * the accesses: a block's matrices are staged through shared memory,
//    every global access coalesced and every load of a tile issued before
//    its first use (9 / 3 floats a thread at an odd stride in shared
//    memory: no bank conflicts);
//  * 64 threads a block: 157 blocks at 10^4, so every SM has work.
// Read the same way: 3.7 / 2.5 us at 10^4, 0.059 / 0.060 ms at 2^20 (82%
// / 81% of the bound); ptxas: 48 / 53 registers, no spills. The kernels
// allocate nothing and read nothing back, so a CUDA graph captures them.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kMaxSweeps = 6;
// the floor of the backward's denominators s'_i + s'_j: M near a
// rank-deficient reflection (s2 + d s3 -> 0) gets a large, finite
// gradient; kernels/procrustes.py DEN_FLOOR is the same number
constexpr float kDenFloor = 1e-6f;
// a column pair with gamma^2 <= kOrthoTol2 alpha beta is orthogonal
constexpr float kOrthoTol2 = 0x1p-46f;
// a squared quantity below this is 0 (B's entries start below 1)
constexpr float kTiny = 1e-36f;

// 1 / sqrt(x): the special-function unit's estimate and one Newton step
__device__ __forceinline__ float rsqrt_nr(float x) {
  const float r = rsqrtf(x);
  const float h = 0.5f * x * r;
  return fmaf(r, fmaf(-h, r, 0.5f), r);
}

// rotate columns p and q of B (and of V) to make them orthogonal, the
// smaller angle; false when they already are
__device__ __forceinline__ bool jacobi_pair(float (&B)[3][3],
                                            float (&V)[3][3], int p, int q) {
  float alpha = 0.f, beta = 0.f, gamma = 0.f;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    alpha = fmaf(B[r][p], B[r][p], alpha);
    beta = fmaf(B[r][q], B[r][q], beta);
    gamma = fmaf(B[r][p], B[r][q], gamma);
  }
  const float g2 = gamma * gamma;
  if (!(g2 > fmaxf(kOrthoTol2 * alpha * beta, kTiny))) return false;
  // t = tan(theta), the root of t^2 + 2 zeta t - 1 = 0 of smaller
  // magnitude, zeta = (beta - alpha) / (2 gamma), written without zeta
  const float tau = beta - alpha;
  const float num = tau >= 0.f ? 2.f * gamma : -2.f * gamma;
  const float x = fmaf(tau, tau, 4.f * g2);
  const float t = __fdividef(num, fabsf(tau) + x * rsqrtf(x));
  const float c = rsqrt_nr(fmaf(t, t, 1.f));
  const float s = c * t;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float bp = B[r][p], bq = B[r][q];
    B[r][p] = fmaf(c, bp, -s * bq);
    B[r][q] = fmaf(s, bp, c * bq);
    const float vp = V[r][p], vq = V[r][q];
    V[r][p] = fmaf(c, vp, -s * vq);
    V[r][q] = fmaf(s, vp, c * vq);
  }
  return true;
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
  const float rho2 = fmaf(a, a, b * b);
  if (!(rho2 >= kTiny)) return;
  const float r = rsqrt_nr(rho2);
  const float c = a * r, s = b * r;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float bp = B[p][k], bq = B[q][k];
    B[p][k] = fmaf(c, bp, s * bq);
    B[q][k] = fmaf(c, bq, -s * bp);
    const float qp = Q[k][p], qq = Q[k][q];
    Q[k][p] = fmaf(c, qp, s * qq);
    Q[k][q] = fmaf(c, qq, -s * qp);
  }
  B[q][col] = 0.f;
}

// A block's tile: kPer floats for each of its n <= kThreads matrices,
// moved by the whole block, coalesced (thread t takes floats t,
// t + kThreads, ...). load() issues all of a thread's loads before anything
// uses them, so the tiles a kernel reads are in flight together, the last
// block's part tile too.
template <int kPer>
struct Tile {
  float r[kPer];

  __device__ __forceinline__ void load(const float* __restrict__ src,
                                       int n) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < kPer * n) r[k] = src[i];
    }
  }

  __device__ __forceinline__ void store(float* __restrict__ dst,
                                        int n) const {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < kPer * n) dst[i] = r[k];
    }
  }
};

__global__ void __launch_bounds__(kThreads)
procrustes_kernel(const float* __restrict__ M, int P, float* __restrict__ R,
                  float* __restrict__ U, float* __restrict__ S,
                  float* __restrict__ V) {
  // M in, then R; U'; V; s'
  __shared__ float tm[9 * kThreads];
  __shared__ float tu[9 * kThreads];
  __shared__ float tv[9 * kThreads];
  __shared__ float ts[3 * kThreads];
  const int base = blockIdx.x * kThreads;
  const int n = min(kThreads, P - base);
  const int me = threadIdx.x;
  const bool active = me < n;
  {
    Tile<9> m;
    m.load(M + 9 * base, n);
    m.store(tm, n);
  }
  __syncthreads();
  // lanes past P take the identity (already orthogonal: no rotation), so
  // every lane of a warp reaches the votes
  float B[3][3], Vm[3][3], Q[3][3];
  float mx = 0.f;
  bool finite = true;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      B[i][j] = active ? tm[9 * me + 3 * i + j] : (i == j ? 1.f : 0.f);
      mx = fmaxf(mx, fabsf(B[i][j]));
      finite &= isfinite(B[i][j]);
      Vm[i][j] = i == j ? 1.f : 0.f;
      Q[i][j] = i == j ? 1.f : 0.f;
    }
  }
  int e = 0;
  frexpf(mx, &e);
  if (!(mx > 0.f)) e = 0;
  // 2^-e in two factors: e runs from -148 (a denormal) to 128, and a
  // single 2^-e or 2^e would overflow at either end
  const float scale_lo = ldexpf(1.f, -(e >> 1));
  const float scale_hi = ldexpf(1.f, (e >> 1) - e);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) B[i][j] = B[i][j] * scale_lo * scale_hi;
#pragma unroll 1
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    bool rotated = jacobi_pair(B, Vm, 0, 1);
    rotated |= jacobi_pair(B, Vm, 0, 2);
    rotated |= jacobi_pair(B, Vm, 1, 2);
    if (!__any_sync(0xffffffffu, rotated)) break;
  }
  float nrm[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    nrm[j] = fmaf(B[0][j], B[0][j], fmaf(B[1][j], B[1][j], B[2][j] * B[2][j]));
  if (nrm[0] < nrm[1]) swap_columns(B, Vm, nrm, 0, 1);
  if (nrm[0] < nrm[2]) swap_columns(B, Vm, nrm, 0, 2);
  if (nrm[1] < nrm[2]) swap_columns(B, Vm, nrm, 1, 2);
  givens(B, Q, 0, 1, 0);
  givens(B, Q, 0, 2, 0);
  givens(B, Q, 1, 2, 1);
  const float unscale_lo = ldexpf(1.f, e >> 1);
  const float unscale_hi = ldexpf(1.f, e - (e >> 1));
  if (!finite) {  // NaN out, as an SVD gives (the scaling would hide it)
    const float nan = __int_as_float(0x7fc00000);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) B[i][j] = Q[i][j] = Vm[i][j] = nan;
  }
  __syncthreads();  // every lane has read its M from tm
  if (active) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        tm[9 * me + 3 * i + j] =
            fmaf(Q[i][0], Vm[j][0], fmaf(Q[i][1], Vm[j][1], Q[i][2] * Vm[j][2]));
        tu[9 * me + 3 * i + j] = Q[i][j];
        tv[9 * me + 3 * i + j] = Vm[i][j];
      }
      ts[3 * me + i] = B[i][i] * unscale_lo * unscale_hi;
    }
  }
  __syncthreads();
  Tile<9> r, u, v;
  Tile<3> sv;
  r.load(tm, n);
  u.load(tu, n);
  v.load(tv, n);
  sv.load(ts, n);
  r.store(R + 9 * base, n);
  u.store(U + 9 * base, n);
  v.store(V + 9 * base, n);
  sv.store(S + 3 * base, n);
}

__global__ void __launch_bounds__(kThreads)
procrustes_grad_kernel(const float* __restrict__ G,
                       const float* __restrict__ U,
                       const float* __restrict__ S,
                       const float* __restrict__ V, int P,
                       float* __restrict__ dM) {
  __shared__ float tg[9 * kThreads];  // G in, then dM
  __shared__ float tu[9 * kThreads];
  __shared__ float tv[9 * kThreads];
  __shared__ float ts[3 * kThreads];
  const int base = blockIdx.x * kThreads;
  const int n = min(kThreads, P - base);
  const int me = threadIdx.x;
  {
    Tile<9> g, u, v;
    Tile<3> sv;
    g.load(G + 9 * base, n);
    u.load(U + 9 * base, n);
    v.load(V + 9 * base, n);
    sv.load(S + 3 * base, n);
    g.store(tg, n);
    u.store(tu, n);
    v.store(tv, n);
    sv.store(ts, n);
  }
  __syncthreads();
  const bool active = me < n;
  float g[3][3], u[3][3], v[3][3], s[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      g[i][j] = active ? tg[9 * me + 3 * i + j] : 0.f;
      u[i][j] = active ? tu[9 * me + 3 * i + j] : 0.f;
      v[i][j] = active ? tv[9 * me + 3 * i + j] : 0.f;
    }
    s[i] = active ? ts[3 * me + i] : 1.f;
  }
  float t[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)  // t = G V
#pragma unroll
    for (int j = 0; j < 3; ++j)
      t[i][j] = fmaf(g[i][0], v[0][j], fmaf(g[i][1], v[1][j], g[i][2] * v[2][j]));
  // A = U'^T t off the diagonal, K's three entries above it
  float a[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      a[i][j] = i == j ? 0.f
                       : fmaf(u[0][i], t[0][j],
                              fmaf(u[1][i], t[1][j], u[2][i] * t[2][j]));
  const float k01 =
      __fdividef(a[0][1] - a[1][0], fmaxf(s[0] + s[1], kDenFloor));
  const float k02 =
      __fdividef(a[0][2] - a[2][0], fmaxf(s[0] + s[2], kDenFloor));
  const float k12 =
      __fdividef(a[1][2] - a[2][1], fmaxf(s[1] + s[2], kDenFloor));
  // w = U' K, K = [[0, k01, k02], [-k01, 0, k12], [-k02, -k12, 0]]
  float w[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    w[i][0] = -fmaf(u[i][1], k01, u[i][2] * k02);
    w[i][1] = fmaf(u[i][0], k01, -u[i][2] * k12);
    w[i][2] = fmaf(u[i][0], k02, u[i][1] * k12);
  }
  __syncthreads();  // every lane has read its G from tg
  if (active) {
#pragma unroll
    for (int i = 0; i < 3; ++i)  // dM = w V^T
#pragma unroll
      for (int j = 0; j < 3; ++j)
        tg[9 * me + 3 * i + j] =
            fmaf(w[i][0], v[j][0], fmaf(w[i][1], v[j][1], w[i][2] * v[j][2]));
  }
  __syncthreads();
  Tile<9> d;
  d.load(tg, n);
  d.store(dM + 9 * base, n);
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
