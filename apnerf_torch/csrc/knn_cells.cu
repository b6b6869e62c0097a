// K2 (knn_count) and K3 (knn_radius): radius-bounded queries over
// candidate tiles of a Morton-sorted point cloud.
//
// Replaces apnerf/kernels/knn_cells_pallas.py:knn_count_pallas
// (_count_kernel) and :knn_radius_pallas (_kernel/_block). The host side
// (kernels/knn_cells.py) sorts the points into tiles of pts_per_tile with
// their boxes, once a frame. Each kernel lists its own candidate tiles
// (knn_tiles.cuh): a block reduces its queries' box by shuffles and tests
// the tile boxes in parallel, so a call is one launch with no tensor
// operation before it.
//
// K2 counts the points with d2 <= r2 (exact fp32; see sq_dist), 40 launches
// an exact frame. Bound on the H100: the distance evaluations, which the
// exact compare keeps on the fp32 pipes without FMA (3 subtractions, 3
// products, 2 additions, a compare and a count a pair) and off the tensor
// cores; the bytes are a few MB. What a kernel can lose beyond that is
// pairs it need not look at, shared-memory reads per pair, barriers with
// no copy in flight, and SMs without a block. Design:
//   * a block of 256 threads takes 64 Morton-ordered queries, four lanes a
//     query; a call of fewer than kFewQueries queries takes 16 queries a
//     block, sixteen lanes a query, so that 7,392 queries are 462 blocks
//     and not 29. A tighter box lists fewer tiles than 256 queries would,
//     and a warp (8 or 2 queries) skips a listed tile that lies beyond the
//     radius of its own box.
//   * a query's lanes take the groups of four points of a tile in turn,
//     each with three 16-byte shared-memory reads (x, y, z of four points):
//     0.75 reads a pair, the lanes' reads side by side in one segment; the
//     lanes' counts meet by shuffles.
//   * tiles are staged by cp.async in rounds of 1,024 points, the next
//     round's copy in flight while this round is scanned.
//   * counts are integers, so every split of the work is exact.
// K3 keeps the exact top-k of the points with d2 <= r2 (exact fp32 d2; the
// TPU kernel's 11-bit packed keys are not reproduced), ascending, ties to
// the lower sorted index, empty slots (+inf, 0): the top-k scan of
// knn_scan.cuh, several lanes a query, each lane's partial top-k merged
// exactly, tiles beyond a warp's kth distance skipped. Bound on the H100:
// the distance evaluations of the pairs it must look at, as K2's; what it
// adds is a compare and, rarely, an insert a pair, and the lanes' merge.
#include "knn_scan.cuh"

namespace {

constexpr int kLanesMany = 4;  // K2: lanes per query,
constexpr int kLanesFew = 16;  // and in a call of fewer than kFewQueries

template <int kLanes>
__global__ void __launch_bounds__(kThreads) knn_count_kernel(
    const float* __restrict__ q, int M, const float* __restrict__ pts_t,
    const float* __restrict__ t_lo, const float* __restrict__ t_hi, int T,
    int pts, float r2, int* __restrict__ out) {
  __shared__ __align__(16) float s_buf[2][3 * kRoundPts];
  __shared__ TileScratch<kThreads> sc;
  const int sub = threadIdx.x % kLanes;
  const int m = blockIdx.x * (kThreads / kLanes) + threadIdx.x / kLanes;
  const bool live = m < M;
  const float qx = live ? q[3 * m] : 0.f;
  const float qy = live ? q[3 * m + 1] : 0.f;
  const float qz = live ? q[3 * m + 2] : 0.f;
  const Box warp = query_boxes<kThreads>(qx, qy, qz, live, sc);
  const int lane = threadIdx.x & 31;
  const int per_round = min(32, max(1, kRoundPts / pts));  // tiles a round
  int cnt = 0;
  for (int t0 = 0; t0 < T; t0 += kListCap) {
    const int n_list = list_tiles<kThreads>(t_lo, t_hi, t0, T, r2, sc);
    const int n_rounds = (n_list + per_round - 1) / per_round;
    if (n_rounds) {
      stage_async(s_buf[0], pts_t, sc.list, 0, min(per_round, n_list), pts);
    }
    for (int r = 0; r < n_rounds; ++r) {
      const int c0 = r * per_round, n = min(per_round, n_list - c0);
      if (r + 1 < n_rounds) {
        stage_async(s_buf[(r + 1) & 1], pts_t, sc.list, c0 + per_round,
                    min(per_round, n_list - c0 - per_round), pts);
      }
      // the round's tiles within the radius of the warp's own box, one
      // lane a tile
      unsigned near = __ballot_sync(
          0xffffffffu, lane < n && box_in_radius(warp, t_lo, t_hi,
                                                 sc.list[c0 + min(lane, n - 1)],
                                                 r2));
      if (r + 1 < n_rounds) {
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::);
      }
      __syncthreads();  // this round's tiles have landed for every thread
      const float* buf = s_buf[r & 1];
      for (; near; near &= near - 1) {
        const float* px = buf + (__ffs(near) - 1) * 3 * pts;
        if ((pts & 3) == 0) {
          const int n4 = pts >> 2;
          const float4* x4 = reinterpret_cast<const float4*>(px);
#pragma unroll 2
          for (int f = sub; f < n4; f += kLanes) {
            const float4 X = x4[f], Y = x4[n4 + f], Z = x4[2 * n4 + f];
            cnt += (sq_dist(qx, qy, qz, X.x, Y.x, Z.x) <= r2) +
                   (sq_dist(qx, qy, qz, X.y, Y.y, Z.y) <= r2) +
                   (sq_dist(qx, qy, qz, X.z, Y.z, Z.z) <= r2) +
                   (sq_dist(qx, qy, qz, X.w, Y.w, Z.w) <= r2);
          }
        } else {
          for (int j = sub; j < pts; j += kLanes) {
            cnt += sq_dist(qx, qy, qz, px[j], px[pts + j], px[2 * pts + j])
                   <= r2;
          }
        }
      }
      __syncthreads();  // done with s_buf[r & 1] and, at the end, the list
    }
  }
#pragma unroll
  for (int d = kLanes / 2; d > 0; d >>= 1) {
    cnt += __shfl_xor_sync(0xffffffffu, cnt, d);
  }
  if (live && sub == 0) out[m] = cnt;
}

}  // namespace

// K2's queries per block in a call of M queries
extern "C" int knn_count_block(int M) {
  return kThreads / (M < kFewQueries ? kLanesFew : kLanesMany);
}

// q [M, 3]; pts_t [T, 3, pts]; t_lo, t_hi [T, 3]: the tiles' boxes; out [M].
extern "C" int knn_count_launch(const float* q, int M, const float* pts_t,
                                const float* t_lo, const float* t_hi, int T,
                                int pts, float r2, int* out, void* stream) {
  if (M <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((M + knn_count_block(M) - 1) / knn_count_block(M));
  if (M < kFewQueries) {
    knn_count_kernel<kLanesFew><<<grid, kThreads, 0, s>>>(
        q, M, pts_t, t_lo, t_hi, T, pts, r2, out);
  } else {
    knn_count_kernel<kLanesMany><<<grid, kThreads, 0, s>>>(
        q, M, pts_t, t_lo, t_hi, T, pts, r2, out);
  }
  return (int)cudaGetLastError();
}

// K3's lanes per query in a call of M queries (queries a block: 256 /
// lanes)
extern "C" int knn_radius_lanes(int M) { return topk_lanes(M); }

// q [M, 3] (Morton-ordered); the tables as K2's; out_d, out_i [M, k];
// tiles_out: null, or the tiles each warp scanned.
extern "C" int knn_radius_launch(const float* q, int M, const float* pts_t,
                                 const float* t_lo, const float* t_hi, int T,
                                 int pts, float r2, int k, float* out_d,
                                 int* out_i, int* tiles_out, void* stream) {
  return launch_topk<false>(q, nullptr, nullptr, M, pts_t, t_lo, t_hi, T,
                            pts, 0, nullptr, r2, k, out_d, out_i, tiles_out,
                            stream);
}
