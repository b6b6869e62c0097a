// K1: exact brute-force k-NN (k <= 16) of M queries against P points.
//
// Replaces apnerf/kernels/knn_pallas.py:knn_pallas (via knn_pallas_sorted),
// the canonical-cloud k-NN of init_state, run once per model load.
// Bound on the H100: about M*P distance evaluations (10^8 at P = 10^4), a
// few milliseconds of fp32 work; there is nothing to prune or tile for.
// Design: one thread per query keeps a sorted top-k in registers; the block
// stages the point cloud through shared memory in tiles that every thread
// of the block reads. Points are visited in their original order, so the
// indices are the original ones and ties go to the lower index -- no Morton
// sort (the TPU kernel sorted only to make its bbox pruning effective).
#include "knn_common.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kTile = 1024;  // points staged per round (12 KB)

template <int K>
__global__ void __launch_bounds__(kThreads) knn_brute_kernel(
    const float* __restrict__ q, const float* __restrict__ p, int M, int P,
    float* __restrict__ out_d, int* __restrict__ out_i) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile];
  const int m = blockIdx.x * kThreads + threadIdx.x;
  const bool live = m < M;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    qx = q[3 * m];
    qy = q[3 * m + 1];
    qz = q[3 * m + 2];
  }
  float bd[K];
  int bi[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    bd[j] = __int_as_float(0x7f800000);  // +inf
    bi[j] = 0;
  }
  for (int base = 0; base < P; base += kTile) {
    const int n = min(kTile, P - base);
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += kThreads) {
      sx[t] = p[3 * (base + t)];
      sy[t] = p[3 * (base + t) + 1];
      sz[t] = p[3 * (base + t) + 2];
    }
    __syncthreads();
    if (live) {
      for (int t = 0; t < n; ++t) {
        topk_insert<K>(bd, bi, sq_dist(qx, qy, qz, sx[t], sy[t], sz[t]),
                       base + t);
      }
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      out_d[(size_t)m * K + j] = bd[j];
      out_i[(size_t)m * K + j] = bi[j];
    }
  }
}

}  // namespace

extern "C" int knn_brute_launch(const float* q, const float* p, int M, int P,
                                int k, float* out_d, int* out_i,
                                void* stream) {
  if (M <= 0) return 0;
  const dim3 grid((M + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KNN_BRUTE_CALL(K) \
  knn_brute_kernel<K><<<grid, kThreads, 0, s>>>(q, p, M, P, out_d, out_i)
  KNN_DISPATCH_K(k, KNN_BRUTE_CALL)
#undef KNN_BRUTE_CALL
  return (int)cudaGetLastError();
}
