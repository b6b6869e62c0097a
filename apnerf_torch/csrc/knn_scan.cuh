// The staged tile scan of the k-NN kernels over a Morton-sorted cloud:
// cp.async rounds of [3, pts] tile slabs (K2, K3, K1), and the top-k scan
// that K3 (knn_radius, knn_cells.cu) and K1 (knn_brute, knn_brute.cu)
// share.
//
// The top-k scan. A block of 256 threads takes 256 / kLanes consecutive
// (Morton-ordered) queries, kLanes lanes a query. The block lists the tiles
// within its radius of its queries' box (knn_tiles.cuh), starts its walk at
// the listed tile nearest its middle query (wrapping round the list), and
// stages the tiles by cp.async in rounds of 1,024 points, the next round in
// flight while this one is scanned. At the head of a round a query's bound
// is the least of its radius, the smallest kth distance any of its lanes
// holds and the largest c-th (c = ceil(k / lanes): lanes * c >= k points
// lie that near); no point beyond it can be among the query's k, so a lane
// takes only the points within it, as the bound stands before each tile.
// Each warp tests the round's tiles
// against its own box by ballot and keeps a tile when gap^2 <= the largest
// bound of its queries. The prune is strict: a skipped tile's points all
// lie at d2 >= gap^2 > bound >= the query's kth, so none can enter, not
// even at a tie. Inside a tile a query's lanes take the groups of four
// points in turn, each with three 16-byte shared reads (x, y, z of four
// points), so the lanes' reads lie side by side. Each lane keeps an
// ascending register top-k of the points it took, by (d2, index)
// lexicographically, so the order of the walk does not matter; at the end
// the lanes are merged by shuffles (a butterfly: each step merges the
// partner's list into the own, by the same order), and every lane ends
// with the same exact top-k. kernels/knn_cells.topk_scan_model is this
// work in PyTorch, the tiles each warp scans included.
//
// K3 (kBrute false): a point enters when d2 <= r2; indices are the sorted
// ones, ties to the lower: the plain version's stable sort, bit for bit.
// K1 (kBrute true): every query first forms a seed, the largest d2 over
// the k sorted points around its own Morton position (k real points, so
// the true kth is no larger); the block lists the tiles within the largest
// seed of its queries, and a point enters when d2 <= the query's seed. The
// tables are K2's and K3's (kernels/knn_cells.build_point_tables); a
// candidate's original index is read from perm (sorted row -> row) once it
// is within the lane's threshold: the indices are the original ones, ties
// to the lower original index, and the pad rows (sorted index >= P) never
// enter. Results go to the caller's row order.
#pragma once

#include "knn_tiles.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRoundPts = 1024;     // points staged per round
constexpr int kFewQueries = 32768;  // K1 / K2 / K3: a call of fewer queries
constexpr int kTopLanesFew = 8;     // K1 / K3: lanes per query in such a
constexpr int kTopLanesMany = 4;    // call, and in a call of more

// one asynchronous copy of kBytes (4 or 16) from global to shared memory
template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  if (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(gmem));
  }
}

// Start the copy of tiles list[c0 .. c0 + n) into buf as n consecutive
// [3, pts] slabs (16 bytes a copy when pts is a multiple of 4).
__device__ __forceinline__ void stage_async(float* buf, const float* pts_t,
                                            const int* list, int c0, int n,
                                            int pts) {
  const int per = 3 * pts;
  if ((pts & 3) == 0) {
    const int per4 = per >> 2;
    for (int t = threadIdx.x; t < n * per4; t += kThreads) {
      const int s = t / per4, o = (t - s * per4) << 2;
      cp_async<16>(buf + s * per + o,
                   pts_t + (size_t)list[c0 + s] * per + o);
    }
  } else {
    for (int t = threadIdx.x; t < n * per; t += kThreads) {
      const int s = t / per, o = t - s * per;
      cp_async<4>(buf + s * per + o,
                  pts_t + (size_t)list[c0 + s] * per + o);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ bool lex_less(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

// Insert (d, idx) into the ascending list bd/bi by (d2, index); the caller
// has checked that it comes before the last entry.
template <int K>
__device__ __forceinline__ void topk_insert_lex(float (&bd)[K], int (&bi)[K],
                                                float d, int idx) {
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    if (lex_less(d, idx, bd[s - 1], bi[s - 1])) {
      bd[s] = bd[s - 1];
      bi[s] = bi[s - 1];
    } else if (lex_less(d, idx, bd[s], bi[s])) {
      bd[s] = d;
      bi[s] = idx;
    }
  }
  if (lex_less(d, idx, bd[0], bi[0])) {
    bd[0] = d;
    bi[0] = idx;
  }
}

// Rotate the block's list (n tiles) so that it starts at the listed tile
// nearest the point m (the first of those at the least gap^2): the tiles
// around the block's queries come first, and their kth distances prune the
// rest. Every thread of the block calls this; it ends in a barrier.
__device__ __forceinline__ void rotate_nearest(const float (&m)[3], int n,
                                               int* list,
                                               const float* __restrict__ t_lo,
                                               const float* __restrict__ t_hi,
                                               unsigned long long* s_key) {
  const Box at = {{m[0], m[1], m[2]}, {m[0], m[1], m[2]}};
  unsigned long long best = ~0ull;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float g2 = box_gap2(at, t_lo, t_hi, list[i]);
    best = min(best, ((unsigned long long)__float_as_uint(g2) << 32) |
                         (unsigned)i);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    best = min(best, __shfl_xor_sync(0xffffffffu, best, d));
  }
  if ((threadIdx.x & 31) == 0) s_key[threadIdx.x >> 5] = best;
  __syncthreads();
  for (int w = 0; w < kThreads / 32; ++w) best = min(best, s_key[w]);
  const int start = n ? (int)(best & 0xffffffffu) : 0;
  int keep[kListCap / kThreads];
#pragma unroll
  for (int u = 0; u < kListCap / kThreads; ++u) {
    const int i = u * kThreads + threadIdx.x;
    if (i < n) keep[u] = list[(i + start) % n];
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kListCap / kThreads; ++u) {
    const int i = u * kThreads + threadIdx.x;
    if (i < n) list[i] = keep[u];
  }
  __syncthreads();
}

// The query's bound on its kth distance: the least of its radius rq, the
// smallest kth distance its lanes hold, and the largest c-th (c = ceil(K /
// kLanes): kLanes * c >= K points lie that near). Every lane of the warp
// calls this.
template <int K, int kLanes>
__device__ __forceinline__ float query_bound(float rq, const float (&bd)[K]) {
  float bound = fminf(rq, bd[K - 1]);
  float spread = bd[(K + kLanes - 1) / kLanes - 1];
#pragma unroll
  for (int d = kLanes / 2; d > 0; d >>= 1) {
    bound = fminf(bound, __shfl_xor_sync(0xffffffffu, bound, d));
    spread = fmaxf(spread, __shfl_xor_sync(0xffffffffu, spread, d));
  }
  return fminf(bound, spread);
}

// Offer (d, sorted index j) to the lane's list, K1 under the original
// index perm[j]; rq is the query's bound before this tile, thr min(rq, the
// list's last d2), kept up to date here.
template <int K, bool kBrute>
__device__ __forceinline__ void consider(float d, int j,
                                         const long long* __restrict__ perm,
                                         float rq, int P, float& thr,
                                         float (&bd)[K], int (&bi)[K]) {
  if (d <= thr && (!kBrute || j < P)) {
    const int idx = kBrute ? (int)perm[j] : j;
    if (lex_less(d, idx, bd[K - 1], bi[K - 1])) {
      topk_insert_lex<K>(bd, bi, d, idx);
      thr = fminf(rq, bd[K - 1]);
    }
  }
}

// Scan the points of one staged [3, pts] slab (sorted indices base ...)
// with this lane's share of them: a group of four points is offered only
// when one of them is within thr.
template <int K, int kLanes, bool kBrute>
__device__ __forceinline__ void scan_tile(const float* px, int base, int pts,
                                          int sub, float qx, float qy,
                                          float qz, float rq, int P,
                                          const long long* __restrict__ perm,
                                          float& thr, float (&bd)[K],
                                          int (&bi)[K]) {
  if ((pts & 3) == 0) {
    const int n4 = pts >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(px);
#pragma unroll 2
    for (int f = sub; f < n4; f += kLanes) {
      const float4 X = x4[f], Y = x4[n4 + f], Z = x4[2 * n4 + f];
      const float d0 = sq_dist(qx, qy, qz, X.x, Y.x, Z.x);
      const float d1 = sq_dist(qx, qy, qz, X.y, Y.y, Z.y);
      const float d2 = sq_dist(qx, qy, qz, X.z, Y.z, Z.z);
      const float d3 = sq_dist(qx, qy, qz, X.w, Y.w, Z.w);
      if (fminf(fminf(d0, d1), fminf(d2, d3)) <= thr) {
        const int j = base + 4 * f;
        consider<K, kBrute>(d0, j, perm, rq, P, thr, bd, bi);
        consider<K, kBrute>(d1, j + 1, perm, rq, P, thr, bd, bi);
        consider<K, kBrute>(d2, j + 2, perm, rq, P, thr, bd, bi);
        consider<K, kBrute>(d3, j + 3, perm, rq, P, thr, bd, bi);
      }
    }
  } else {
    for (int o = sub; o < pts; o += kLanes) {
      const float d = sq_dist(qx, qy, qz, px[o], px[pts + o], px[2 * pts + o]);
      consider<K, kBrute>(d, base + o, perm, rq, P, thr, bd, bi);
    }
  }
}

// q [*, 3]; K1: qorder [M] (the query row of sorted query m), qpos [M] or
// null (the sorted point position near query m; null: m, a self-query);
// pts_t [T, 3, pts] with the tiles' boxes t_lo, t_hi [T, 3]; K1: P real
// points, perm [P] (sorted row -> original row); r2 (K3 only); out_d,
// out_i [*, K] in the caller's row order; tiles_out:
// null, or the tiles each warp scanned [grid * 8] (for checking the prune
// against its model).
// (two blocks an SM as a floor: without it ptxas held some instances to
// 80 registers and spilled)
template <int K, int kLanes, bool kBrute>
__global__ void __launch_bounds__(kThreads, 2) knn_topk_kernel(
    const float* __restrict__ q, const long long* __restrict__ qorder,
    const long long* __restrict__ qpos, int M,
    const float* __restrict__ pts_t, const float* __restrict__ t_lo,
    const float* __restrict__ t_hi, int T, int pts, int P,
    const long long* __restrict__ perm, float r2, float* __restrict__ out_d,
    int* __restrict__ out_i, int* __restrict__ tiles_out) {
  __shared__ __align__(16) float s_buf[2][3 * kRoundPts];
  __shared__ TileScratch<kThreads> sc;
  __shared__ float s_seed[kThreads / 32];
  __shared__ unsigned long long s_key[kThreads / 32];
  const float inf = __int_as_float(0x7f800000);
  const int sub = threadIdx.x % kLanes;
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const int m = blockIdx.x * (kThreads / kLanes) + threadIdx.x / kLanes;
  const bool live = m < M;
  const long long row = kBrute ? (live ? qorder[m] : 0) : m;
  const float qx = live ? q[3 * row] : 0.f;
  const float qy = live ? q[3 * row + 1] : 0.f;
  const float qz = live ? q[3 * row + 2] : 0.f;
  const Box warp = query_boxes<kThreads>(qx, qy, qz, live, sc);
  float rq = live ? r2 : -inf;  // the query's radius
  // the block's middle query, where its walk of the tiles starts
  const int mid = min((int)blockIdx.x * (kThreads / kLanes) +
                      kThreads / kLanes / 2, M - 1);
  const long long mid_row = kBrute ? qorder[mid] : mid;
  const float at[3] = {q[3 * mid_row], q[3 * mid_row + 1],
                       q[3 * mid_row + 2]};
  if constexpr (kBrute) {
    // the seed: the largest d2 over the K sorted points around the query's
    // own position, the lanes taking them in turn
    const long long pos = live ? (qpos ? qpos[m] : m) : 0;
    const long long lo = pos - K / 2;
    const int s0 = (int)(lo < 0 ? 0 : lo > P - K ? P - K : lo);
    float worst = 0.f;
    for (int i = sub; i < K; i += kLanes) {
      const int s = s0 + i, t = s / pts, o = s - t * pts;
      const float* p = pts_t + (size_t)t * 3 * pts + o;
      worst = fmaxf(worst, sq_dist(qx, qy, qz, p[0], p[pts], p[2 * pts]));
    }
#pragma unroll
    for (int d = kLanes / 2; d > 0; d >>= 1) {
      worst = fmaxf(worst, __shfl_xor_sync(0xffffffffu, worst, d));
    }
    rq = live ? worst : -inf;
    // the block lists the tiles within the largest seed of its queries
    float top = rq;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, d));
    }
    if (lane == 0) s_seed[wi] = top;
    __syncthreads();
    r2 = s_seed[0];
    for (int i = 1; i < kThreads / 32; ++i) r2 = fmaxf(r2, s_seed[i]);
  }
  float bd[K];
  int bi[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    bd[j] = inf;
    bi[j] = 0;
  }
  float thr;  // min(the query's bound, bd[K - 1])
  int scanned = 0;
  const int per_round = min(32, max(1, kRoundPts / pts));  // tiles a round
  for (int t0 = 0; t0 < T; t0 += kListCap) {
    const int n_list = list_tiles<kThreads>(t_lo, t_hi, t0, T, r2, sc);
    rotate_nearest(at, n_list, sc.list, t_lo, t_hi, s_key);
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
      // the warp's bound: the largest of its queries'
      float bound = query_bound<K, kLanes>(rq, bd);
#pragma unroll
      for (int d = 16; d >= kLanes; d >>= 1) {
        bound = fmaxf(bound, __shfl_xor_sync(0xffffffffu, bound, d));
      }
      unsigned near = __ballot_sync(
          0xffffffffu, lane < n && box_in_radius(warp, t_lo, t_hi,
                                                 sc.list[c0 + min(lane, n - 1)],
                                                 bound));
      scanned += __popc(near);
      if (r + 1 < n_rounds) {
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::);
      }
      __syncthreads();  // this round's tiles have landed for every thread
      const float* buf = s_buf[r & 1];
      for (; near; near &= near - 1) {
        const int slot = __ffs(near) - 1;
        // a lane takes only points within its query's bound as it stands
        // before this tile: no point beyond it can be among the query's k
        const float qr = query_bound<K, kLanes>(rq, bd);
        thr = fminf(qr, bd[K - 1]);
        scan_tile<K, kLanes, kBrute>(buf + slot * 3 * pts,
                                     sc.list[c0 + slot] * pts, pts, sub, qx,
                                     qy, qz, qr, P, perm, thr, bd, bi);
      }
      __syncthreads();  // done with s_buf[r & 1] and, at the end, the list
    }
  }
  // merge the query's lanes: a butterfly of exact (d2, index) merges
#pragma unroll
  for (int d = 1; d < kLanes; d <<= 1) {
    float pd[K];
    int pi[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      pd[j] = __shfl_xor_sync(0xffffffffu, bd[j], d);
      pi[j] = __shfl_xor_sync(0xffffffffu, bi[j], d);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (lex_less(pd[j], pi[j], bd[K - 1], bi[K - 1])) {
        topk_insert_lex<K>(bd, bi, pd[j], pi[j]);
      }
    }
  }
  if (live) {
    // the query's lanes write its K entries in turn
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (j % kLanes == sub) {
        out_d[(size_t)row * K + j] = bd[j];
        out_i[(size_t)row * K + j] = bi[j];
      }
    }
  }
  if (tiles_out && lane == 0) {
    tiles_out[blockIdx.x * (kThreads / 32) + wi] = scanned;
  }
}

// K1's / K3's lanes per query in a call of M queries (queries a block:
// 256 / lanes)
int topk_lanes(int M) {
  return M < kFewQueries ? kTopLanesFew : kTopLanesMany;
}

// Launch the top-k scan for a runtime k in [1, 16], topk_lanes(M) lanes a
// query.
template <bool kBrute>
int launch_topk(const float* q, const long long* qorder,
                const long long* qpos, int M, const float* pts_t,
                const float* t_lo, const float* t_hi, int T, int pts, int P,
                const long long* perm, float r2, int k, float* out_d,
                int* out_i, int* tiles_out, void* stream) {
  if (M <= 0) return 0;
  const int lanes = topk_lanes(M);
  const dim3 grid((M + kThreads / lanes - 1) / (kThreads / lanes));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KNN_TOPK_CALL(K)                                                    \
  if (lanes == kTopLanesFew) {                                              \
    knn_topk_kernel<K, kTopLanesFew, kBrute><<<grid, kThreads, 0, s>>>(     \
        q, qorder, qpos, M, pts_t, t_lo, t_hi, T, pts, P, perm, r2, out_d,  \
        out_i, tiles_out);                                                  \
  } else {                                                                  \
    knn_topk_kernel<K, kTopLanesMany, kBrute><<<grid, kThreads, 0, s>>>(    \
        q, qorder, qpos, M, pts_t, t_lo, t_hi, T, pts, P, perm, r2, out_d,  \
        out_i, tiles_out);                                                  \
  }
  KNN_DISPATCH_K(k, KNN_TOPK_CALL)
#undef KNN_TOPK_CALL
  return (int)cudaGetLastError();
}

}  // namespace
