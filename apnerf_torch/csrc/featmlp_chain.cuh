// The feat_net chain shared by K4 (featmlp.cu) and K6 (agg.cu): 128 rows a
// block held in shared memory, one layer's bf16 weights streamed in at a
// time, bf16 x bf16 -> fp32 WMMA GEMMs (each of the 8 warps owns 16 rows x F
// columns), the bias added in fp32, leaky-ReLU (slope 0.01) after every
// layer. The callers build the layer-1 operand [PE (padded to P_pad) | feat]
// in A and read the result back: K4 from A (bf16, every layer rounded), K6
// from C (fp32, the last layer not rounded).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace featmlp {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kRows = 128;             // rows (query-neighbour pairs) per block
constexpr int kWarps = kRows / 16;     // one warp per 16 rows
constexpr int kThreads = 32 * kWarps;

// A: layer operand, W: one layer's weights, C: fp32 GEMM result
inline size_t chain_smem_bytes(int F, int P_pad) {
  const size_t kd1 = P_pad + F;
  return kRows * kd1 * sizeof(bf16) + kd1 * F * sizeof(bf16) +
         (size_t)kRows * F * sizeof(float);
}

// Column c (< P_pad) of the positional encoding of x[0..2]:
// [x, sin(x_a 2^i), cos(x_a 2^i), 0 pad], channel a * n_pe + i inside the
// sin and cos blocks. sinf/cosf, not the fast-math intrinsics: arguments
// reach x * 2^9 (and ~1e12 on K6's sentinel rows, which must stay finite).
__device__ inline bf16 pe_value(const float* x, int c, int n_pe) {
  const int P = 3 * (1 + 2 * n_pe);
  if (c < 3) return __float2bfloat16(x[c]);
  if (c >= P) return __float2bfloat16(0.f);
  int cc = c - 3;
  const bool is_cos = cc >= 3 * n_pe;
  if (is_cos) cc -= 3 * n_pe;
  const int a = cc / n_pe;
  const float v = x[a] * (float)(1 << (cc - a * n_pe));
  return __float2bfloat16(is_cos ? cosf(v) : sinf(v));
}

// Runs the n_layers chain on the operand in A ([kRows, kd1] bf16). With
// kRoundLast the result is in A as [kRows, F] bf16; without, the last
// layer's bias + leaky-ReLU stays in C as [kRows, F] fp32. Ends with every
// thread's writes done but not yet synchronised.
template <int F, bool kRoundLast>
__device__ inline void mlp_chain(bf16* A, bf16* W, float* C,
                                 const bf16* __restrict__ w1,
                                 const float* __restrict__ b1,
                                 const bf16* __restrict__ wl,
                                 const float* __restrict__ bl, int kd1,
                                 int n_layers) {
  const int warp = threadIdx.x / 32;
  for (int l = 0; l < n_layers; ++l) {
    const int kd = l == 0 ? kd1 : F;
    const bf16* wsrc = l == 0 ? w1 : wl + (size_t)(l - 1) * F * F;
    const float* bias = l == 0 ? b1 : bl + (size_t)(l - 1) * F;
    __syncthreads();  // A written; the previous layer no longer reads W
    const int n_vec = kd * F / 8;  // 16-byte vectors
    for (int t = threadIdx.x; t < n_vec; t += kThreads) {
      reinterpret_cast<int4*>(W)[t] = reinterpret_cast<const int4*>(wsrc)[t];
    }
    __syncthreads();

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[F / 16];
#pragma unroll
    for (int j = 0; j < F / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
    const bf16* a_rows = A + warp * 16 * kd;
    for (int k0 = 0; k0 < kd; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, a_rows + k0, kd);
#pragma unroll
      for (int j = 0; j < F / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, W + k0 * F + 16 * j, F);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < F / 16; ++j) {
      wmma::store_matrix_sync(C + warp * 16 * F + 16 * j, acc[j], F,
                              wmma::mem_row_major);
    }
    __syncthreads();  // all warps done reading A before it is overwritten
    const bool keep_fp32 = !kRoundLast && l == n_layers - 1;
    for (int t = threadIdx.x; t < kRows * F; t += kThreads) {
      float v = C[t] + bias[t % F];
      v = v >= 0.f ? v : 0.01f * v;
      if (keep_fp32) {
        C[t] = v;
      } else {
        A[t] = __float2bfloat16(v);  // next operand
      }
    }
  }
}

}  // namespace featmlp
