// K4: fused positional encoding + feat_net MLP + weighted K-reduction.
//
// Replaces apnerf/kernels/featmlp_pallas.py:featmlp_agg (_kernel,
// _run_kernel):
//   h[m] = sum_k w[m,k] * feat_net(poc_fre(rel[m,k]) ++ feat[m,k])
// with bf16 x bf16 -> fp32 GEMMs, the bias added in fp32, leaky-ReLU
// (slope 0.01) and a bf16 rounding after every layer; a pose embedding is
// folded into the layer-1 bias by the host.
// Bound on the H100: at the bench shape (573,440 rows, F = 128, 4 layers)
// about 85 GFLOP of bf16 tensor-core work against ~155 MB of input, so
// the chain is compute-bound only if the activations never leave the chip;
// the unfused chain writes and reads [rows, F] per layer.
// Design: one block of 8 warps per 128 rows (16 output rows m at K = 8).
// The block builds the layer-1 operand [PE (padded to P_pad) | feat] in
// shared memory (sinf/cosf in registers: arguments reach x * 2^9, so no
// fast-math sine), then runs the chain of featmlp_chain.cuh (shared with
// K6, agg.cu): for each layer that layer's bf16 weights are streamed into
// shared memory, the GEMM runs on WMMA fragments (each warp owns 16 rows x
// F columns), and bias + leaky-ReLU is written back as the next bf16
// operand. Activations stay in shared memory; only the [M, F] fp32
// reduction is written. Shared memory (about 160 KB at F = 128) is above
// the 48 KB default, so the launch opts in. wgmma/TMA come later.
#include "featmlp_chain.cuh"

using namespace featmlp;

namespace {

template <int F>
__global__ void __launch_bounds__(kThreads) featmlp_kernel(
    const float* __restrict__ rel, const bf16* __restrict__ feat,
    const float* __restrict__ w, const bf16* __restrict__ w1,
    const float* __restrict__ b1, const bf16* __restrict__ wl,
    const float* __restrict__ bl, int rows_total, int K, int n_pe, int P_pad,
    int n_layers, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int kd1 = P_pad + F;
  bf16* A = reinterpret_cast<bf16*>(smem);
  bf16* W = A + kRows * kd1;
  float* C = reinterpret_cast<float*>(W + kd1 * F);
  const int row0 = blockIdx.x * kRows;

  // ---- layer-1 operand: [x, sin(x_a 2^i), cos(x_a 2^i), 0 pad | feat]
  for (int t = threadIdx.x; t < kRows * kd1; t += kThreads) {
    const int r = t / kd1;
    const int c = t - r * kd1;
    const int gr = row0 + r;
    bf16 v = __float2bfloat16(0.f);
    if (gr < rows_total) {
      v = c >= P_pad ? feat[(size_t)gr * F + (c - P_pad)]
                     : pe_value(rel + (size_t)gr * 3, c, n_pe);
    }
    A[t] = v;
  }

  mlp_chain<F, true>(A, W, C, w1, b1, wl, bl, kd1, n_layers);
  __syncthreads();

  // ---- weighted reduction over the K neighbours of each output row
  const int m_per_block = kRows / K;
  for (int t = threadIdx.x; t < m_per_block * F; t += kThreads) {
    const int ml = t / F;
    const int f = t - ml * F;
    const int r0 = ml * K;
    if (row0 + r0 >= rows_total) continue;
    float s = 0.f;
    for (int k = 0; k < K; ++k) {
      s += __bfloat162float(A[(r0 + k) * F + f]) * w[row0 + r0 + k];
    }
    out[(size_t)(blockIdx.x * m_per_block + ml) * F + f] = s;
  }
}

template <int F>
int launch(const float* rel, const bf16* feat, const float* w, const bf16* w1,
           const float* b1, const bf16* wl, const float* bl, int M, int K,
           int n_pe, int P_pad, int n_layers, float* out,
           cudaStream_t stream) {
  const size_t smem = chain_smem_bytes(F, P_pad);
  cudaError_t err = cudaFuncSetAttribute(
      featmlp_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = M * K;
  const dim3 grid((rows + kRows - 1) / kRows);
  featmlp_kernel<F><<<grid, kThreads, smem, stream>>>(
      rel, feat, w, w1, b1, wl, bl, rows, K, n_pe, P_pad, n_layers, out);
  return (int)cudaGetLastError();
}

}  // namespace

// rel [M*K, 3] f32, feat [M*K, F] bf16, w [M*K] f32,
// w1 [P_pad + F, F] bf16 (PE rows, zero pad rows, feature rows),
// b1 [F] f32, wl [n_layers - 1, F, F] bf16, bl [n_layers - 1, F] f32,
// out [M, F] f32. Needs K | 128, P_pad % 16 == 0, F in {32, 64, 128}.
extern "C" int featmlp_launch(const void* rel, const void* feat,
                              const void* w, const void* w1, const void* b1,
                              const void* wl, const void* bl, int M, int K,
                              int F, int n_pe, int P_pad, int n_layers,
                              void* out, void* stream) {
  if (M <= 0) return 0;
  if (K <= 0 || kRows % K != 0 || P_pad % 16 != 0 || n_layers < 1) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const float*>(rel);
  const auto* fe = static_cast<const bf16*>(feat);
  const auto* ww = static_cast<const float*>(w);
  const auto* a1 = static_cast<const bf16*>(w1);
  const auto* c1 = static_cast<const float*>(b1);
  const auto* al = static_cast<const bf16*>(wl);
  const auto* cl = static_cast<const float*>(bl);
  auto* o = static_cast<float*>(out);
  switch (F) {
    case 32: return launch<32>(r, fe, ww, a1, c1, al, cl, M, K, n_pe, P_pad, n_layers, o, s);
    case 64: return launch<64>(r, fe, ww, a1, c1, al, cl, M, K, n_pe, P_pad, n_layers, o, s);
    case 128: return launch<128>(r, fe, ww, a1, c1, al, cl, M, K, n_pe, P_pad, n_layers, o, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
