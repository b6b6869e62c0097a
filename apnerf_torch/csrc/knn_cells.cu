// K2 (knn_count) and K3 (knn_radius): radius-bounded queries over
// candidate tiles of a Morton-sorted point cloud.
//
// Replaces apnerf/kernels/knn_cells_pallas.py:knn_count_pallas
// (_count_kernel) and :knn_radius_pallas (_kernel/_block). The host side
// (kernels/knn_cells.py) sorts the points into tiles of pts_per_tile and
// lists, for every block of kQB consecutive queries, the tiles whose bbox
// lies within the radius of the block's bbox, in ascending tile order.
// Bound on the H100: distance evaluations over the listed tiles (about a
// quarter of all tiles at the bench shape) -- fp32 ALU and shared-memory
// reads; the outputs are a few bytes per query.
// Design: one block per query block, one thread per query. The block
// stages up to kStage candidate tiles at a time in shared memory; each
// thread scans them in index order.
//   K2 counts points with d2 <= r2 (exact fp32; see sq_dist).
//   K3 keeps an ascending register top-k of the points with d2 <= r2,
//   exact fp32 d2 (the TPU kernel's 11-bit packed keys are not
//   reproduced), ties to the lower sorted index, empty slots (+inf, 0).
#include "knn_common.cuh"

namespace {

constexpr int kQB = 256;    // queries per block (the host's block size)
constexpr int kStage = 8;   // candidate tiles staged per round

// Stage tiles [c0, c0 + n) of this block's candidate list into sp as
// n consecutive [3, pts] slabs.
__device__ __forceinline__ void stage_tiles(float* sp, const float* pts_t,
                                            const int* list, int c0, int n,
                                            int pts) {
  const int per = 3 * pts;
  for (int t = threadIdx.x; t < n * per; t += kQB) {
    const int s = t / per;
    sp[t] = pts_t[(size_t)list[c0 + s] * per + (t - s * per)];
  }
}

__global__ void __launch_bounds__(kQB) knn_count_kernel(
    const float* __restrict__ q, int M, const float* __restrict__ pts_t,
    int T, int pts, const int* __restrict__ tile_list,
    const int* __restrict__ tile_cnt, float r2, int* __restrict__ out) {
  extern __shared__ float sp[];
  const int b = blockIdx.x;
  const int m = b * kQB + threadIdx.x;
  const bool live = m < M;
  const float qx = live ? q[3 * m] : 0.f;
  const float qy = live ? q[3 * m + 1] : 0.f;
  const float qz = live ? q[3 * m + 2] : 0.f;
  const int* list = tile_list + (size_t)b * T;
  const int n_cand = tile_cnt[b];
  int cnt = 0;
  for (int c0 = 0; c0 < n_cand; c0 += kStage) {
    const int n = min(kStage, n_cand - c0);
    __syncthreads();
    stage_tiles(sp, pts_t, list, c0, n, pts);
    __syncthreads();
    if (live) {
      for (int s = 0; s < n; ++s) {
        const float* px = sp + s * 3 * pts;
        for (int j = 0; j < pts; ++j) {
          cnt += sq_dist(qx, qy, qz, px[j], px[pts + j], px[2 * pts + j]) <= r2;
        }
      }
    }
  }
  if (live) out[m] = cnt;
}

template <int K>
__global__ void __launch_bounds__(kQB) knn_radius_kernel(
    const float* __restrict__ q, int M, const float* __restrict__ pts_t,
    int T, int pts, const int* __restrict__ tile_list,
    const int* __restrict__ tile_cnt, float r2, float* __restrict__ out_d,
    int* __restrict__ out_i) {
  extern __shared__ float sp[];
  const int b = blockIdx.x;
  const int m = b * kQB + threadIdx.x;
  const bool live = m < M;
  const float qx = live ? q[3 * m] : 0.f;
  const float qy = live ? q[3 * m + 1] : 0.f;
  const float qz = live ? q[3 * m + 2] : 0.f;
  const int* list = tile_list + (size_t)b * T;
  const int n_cand = tile_cnt[b];
  float bd[K];
  int bi[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    bd[j] = __int_as_float(0x7f800000);  // +inf
    bi[j] = 0;
  }
  for (int c0 = 0; c0 < n_cand; c0 += kStage) {
    const int n = min(kStage, n_cand - c0);
    __syncthreads();
    stage_tiles(sp, pts_t, list, c0, n, pts);
    __syncthreads();
    if (live) {
      for (int s = 0; s < n; ++s) {
        const float* px = sp + s * 3 * pts;
        const int base = list[c0 + s] * pts;
        for (int j = 0; j < pts; ++j) {
          const float d =
              sq_dist(qx, qy, qz, px[j], px[pts + j], px[2 * pts + j]);
          if (d <= r2) topk_insert<K>(bd, bi, d, base + j);
        }
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

extern "C" int knn_count_launch(const float* q, int M, const float* pts_t,
                                int T, int pts, const int* tile_list,
                                const int* tile_cnt, float r2, int* out,
                                void* stream) {
  if (M <= 0) return 0;
  const dim3 grid((M + kQB - 1) / kQB);
  const size_t smem = sizeof(float) * kStage * 3 * pts;
  knn_count_kernel<<<grid, kQB, smem, static_cast<cudaStream_t>(stream)>>>(
      q, M, pts_t, T, pts, tile_list, tile_cnt, r2, out);
  return (int)cudaGetLastError();
}

extern "C" int knn_radius_launch(const float* q, int M, const float* pts_t,
                                 int T, int pts, const int* tile_list,
                                 const int* tile_cnt, float r2, int k,
                                 float* out_d, int* out_i, void* stream) {
  if (M <= 0) return 0;
  const dim3 grid((M + kQB - 1) / kQB);
  const size_t smem = sizeof(float) * kStage * 3 * pts;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KNN_RADIUS_CALL(K)                                            \
  knn_radius_kernel<K><<<grid, kQB, smem, s>>>(q, M, pts_t, T, pts,   \
                                               tile_list, tile_cnt, r2, \
                                               out_d, out_i)
  KNN_DISPATCH_K(k, KNN_RADIUS_CALL)
#undef KNN_RADIUS_CALL
  return (int)cudaGetLastError();
}
