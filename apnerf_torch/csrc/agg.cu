// K6: fused subgroup-shared neighbour aggregation.
//
// Replaces apnerf/kernels/agg_pallas.py:fused_subgroup_agg (_kernel). Per
// subgroup of `share` member samples and `kc` shared candidate points:
//   to_nn[m,k] = |q[m] - nbr[k]|^2          (each op rounded, no FMA)
//   top        = the K smallest of the kc, ties by candidate position
//   kd2[m]     = max over top of to_nn      (floor -3.4e38)
//   w[m,k]     = top ? 1 / (to_nn + eps) : 0, over max(sum_k, 1e-30)
//   rc[m,k]    = rot[k] (q[m] - nbr[k])     (canonical-frame offset)
//   h[m]       = sum_k w[m,k] * feat_net(poc_fre(rc[m,k]) ++ feat[k])
// feat_net as in K4 (bf16 x bf16 -> fp32, fp32 bias, leaky-ReLU 0.01 after
// every layer, bf16 round between layers) except that the last layer's
// output stays fp32. The MLP runs on all kc candidates; the losers get
// weight 0. Invalid candidates arrive at the 2e9 sentinel position: they
// rank last, and their rows stay finite (sinf/cosf reduce any finite
// argument), so 0 * row is 0.
// Bound on the H100: at the bench shape (4480 subgroups x 16 members x 8
// candidates = 573,440 MLP rows, F = 128) 84 GFLOP of bf16 tensor-core work
// against ~12 MB of candidate rows in and ~37 MB of features out: the
// tensor cores bound it, as long as nothing but h and kd2 leaves the chip.
// Design: the flat member index g = s * share + m; a block of 8 warps takes
// kRows / kc whole members (16 at kc = 8: one subgroup; 10 at kc = 12, 8 of
// the 128 rows idle), one row per (member, candidate). One thread per row
// forms to_nn and rc, then its rank among the member's kc distances held in
// shared memory; one thread per member normalises the weights and writes
// kd2. The rows' layer-1 operands are built in shared memory and go through
// the chain of featmlp_chain.cuh (shared with K4); the fp32 result is
// reduced over each member's candidates and written as h[g]. The ragged
// last block is bound-checked, nothing is padded. wgmma/TMA come later.
#include "featmlp_chain.cuh"

using namespace featmlp;

namespace {

size_t agg_smem_bytes(int F, int P_pad) {
  // the chain's A, W, C, then rc [kRows, 3], to_nn [kRows], w [kRows] fp32
  // and the top flags [kRows]
  return chain_smem_bytes(F, P_pad) + kRows * 5 * sizeof(float) + kRows;
}

template <int F>
__global__ void __launch_bounds__(kThreads) agg_kernel(
    const float* __restrict__ q, const float* __restrict__ nbr,
    const float* __restrict__ rot, const bf16* __restrict__ feat,
    const bf16* __restrict__ w1, const float* __restrict__ b1,
    const bf16* __restrict__ wl, const float* __restrict__ bl, int n_members,
    int share, int kc, int K, float eps, int n_pe, int P_pad, int n_layers,
    float* __restrict__ h, float* __restrict__ kd2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int kd1 = P_pad + F;
  bf16* A = reinterpret_cast<bf16*>(smem);
  bf16* W = A + kRows * kd1;
  float* C = reinterpret_cast<float*>(W + kd1 * F);
  float* rc = C + kRows * F;
  float* tn = rc + kRows * 3;
  float* wt = tn + kRows;
  unsigned char* top = reinterpret_cast<unsigned char*>(wt + kRows);
  const int mpb = kRows / kc;               // members per block
  const int g0 = blockIdx.x * mpb;
  const int live = min(mpb, n_members - g0) * kc;   // rows in use

  // ---- distances and canonical-frame offsets, one thread per row
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    float t = 0.f, x0 = 0.f, x1 = 0.f, x2 = 0.f;
    if (r < live) {
      const int ml = r / kc;
      const int g = g0 + ml;
      const size_t cand = (size_t)(g / share) * kc + (r - ml * kc);
      const float dx = q[(size_t)g * 3 + 0] - nbr[cand * 3 + 0];
      const float dy = q[(size_t)g * 3 + 1] - nbr[cand * 3 + 1];
      const float dz = q[(size_t)g * 3 + 2] - nbr[cand * 3 + 2];
      t = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                    __fmul_rn(dz, dz));
      const float* R = rot + cand * 9;
      x0 = R[0] * dx + R[1] * dy + R[2] * dz;
      x1 = R[3] * dx + R[4] * dy + R[5] * dz;
      x2 = R[6] * dx + R[7] * dy + R[8] * dz;
    }
    tn[r] = t;
    rc[3 * r + 0] = x0;
    rc[3 * r + 1] = x1;
    rc[3 * r + 2] = x2;
  }
  __syncthreads();

  // ---- rank among the member's kc candidates; raw inverse-distance weight
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    float wr = 0.f;
    unsigned char is_top = 0;
    if (r < live) {
      const int ml = r / kc;
      const int k = r - ml * kc;
      const float t = tn[r];
      int rank = 0;
      for (int j = 0; j < kc; ++j) {
        const float tj = tn[ml * kc + j];
        rank += (t > tj) || (t == tj && k > j);
      }
      is_top = rank < K;
      if (is_top) wr = 1.0f / (t + eps);
    }
    wt[r] = wr;
    top[r] = is_top;
  }
  __syncthreads();

  // ---- per member: kth distance and weight normalisation
  for (int ml = threadIdx.x; ml * kc < live; ml += kThreads) {
    float sum = 0.f, kth = -3.4e38f;
    for (int k = 0; k < kc; ++k) {
      sum += wt[ml * kc + k];
      if (top[ml * kc + k]) kth = fmaxf(kth, tn[ml * kc + k]);
    }
    const float den = fmaxf(sum, 1e-30f);
    for (int k = 0; k < kc; ++k) wt[ml * kc + k] = wt[ml * kc + k] / den;
    kd2[g0 + ml] = kth;
  }

  // ---- layer-1 operand: [rc, sin(rc_a 2^i), cos(rc_a 2^i), 0 pad | feat]
  for (int t = threadIdx.x; t < kRows * kd1; t += kThreads) {
    const int r = t / kd1;
    const int c = t - r * kd1;
    bf16 v = __float2bfloat16(0.f);
    if (r < live) {
      if (c >= P_pad) {
        const int ml = r / kc;
        const size_t cand = (size_t)((g0 + ml) / share) * kc + (r - ml * kc);
        v = feat[cand * F + (c - P_pad)];
      } else {
        v = pe_value(rc + 3 * r, c, n_pe);
      }
    }
    A[t] = v;
  }

  mlp_chain<F, false>(A, W, C, w1, b1, wl, bl, kd1, n_layers);
  __syncthreads();

  // ---- weighted reduction over each member's kc candidates
  for (int t = threadIdx.x; t < mpb * F; t += kThreads) {
    const int ml = t / F;
    const int f = t - ml * F;
    if (ml * kc >= live) continue;
    float s = 0.f;
    for (int k = 0; k < kc; ++k) {
      s += C[(ml * kc + k) * F + f] * wt[ml * kc + k];
    }
    h[(size_t)(g0 + ml) * F + f] = s;
  }
}

template <int F>
int launch(const float* q, const float* nbr, const float* rot,
           const bf16* feat, const bf16* w1, const float* b1, const bf16* wl,
           const float* bl, int n_members, int share, int kc, int K,
           float eps, int n_pe, int P_pad, int n_layers, float* h, float* kd2,
           cudaStream_t stream) {
  const size_t smem = agg_smem_bytes(F, P_pad);
  cudaError_t err = cudaFuncSetAttribute(
      agg_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int mpb = kRows / kc;
  const dim3 grid((n_members + mpb - 1) / mpb);
  agg_kernel<F><<<grid, kThreads, smem, stream>>>(
      q, nbr, rot, feat, w1, b1, wl, bl, n_members, share, kc, K, eps, n_pe,
      P_pad, n_layers, h, kd2);
  return (int)cudaGetLastError();
}

}  // namespace

// q [S*share, 3] f32, nbr [S*kc, 3] f32 (invalid slots at the sentinel),
// rot [S*kc, 9] f32 row-major, feat [S*kc, F] bf16, the weights as
// featmlp_launch takes them, h [S*share, F] f32, kd2 [S*share] f32.
// Needs 1 <= K <= kc <= 128, P_pad % 16 == 0, F in {32, 64, 128}.
extern "C" int agg_launch(const void* q, const void* nbr, const void* rot,
                          const void* feat, const void* w1, const void* b1,
                          const void* wl, const void* bl, int S, int share,
                          int kc, int K, float eps, int F, int n_pe,
                          int P_pad, int n_layers, void* h, void* kd2,
                          void* stream) {
  if (S <= 0) return 0;
  if (share < 1 || K < 1 || kc < K || kc > kRows || P_pad % 16 != 0 ||
      n_layers < 1) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  const auto* qq = static_cast<const float*>(q);
  const auto* nb = static_cast<const float*>(nbr);
  const auto* ro = static_cast<const float*>(rot);
  const auto* fe = static_cast<const bf16*>(feat);
  const auto* a1 = static_cast<const bf16*>(w1);
  const auto* c1 = static_cast<const float*>(b1);
  const auto* al = static_cast<const bf16*>(wl);
  const auto* cl = static_cast<const float*>(bl);
  auto* ho = static_cast<float*>(h);
  auto* ko = static_cast<float*>(kd2);
  const int n = S * share;
  switch (F) {
    case 32: return launch<32>(qq, nb, ro, fe, a1, c1, al, cl, n, share, kc, K, eps, n_pe, P_pad, n_layers, ho, ko, s);
    case 64: return launch<64>(qq, nb, ro, fe, a1, c1, al, cl, n, share, kc, K, eps, n_pe, P_pad, n_layers, ho, ko, s);
    case 128: return launch<128>(qq, nb, ro, fe, a1, c1, al, cl, n, share, kc, K, eps, n_pe, P_pad, n_layers, ho, ko, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
