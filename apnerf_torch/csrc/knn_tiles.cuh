// The candidate-tile listing of K2 (knn_count) and K3 (knn_radius), as
// device functions called at the head of their kernels: a block finds its
// queries' bounding box, then lists the tiles of the Morton-sorted cloud
// whose own box lies within the radius of it, in ascending tile order.
// kernels/knn_cells.py:candidate_tiles is the plain version of this listing
// and forms the same numbers: per axis gap = max(q_lo - t_hi, t_lo - q_hi,
// 0), gap^2 = (gx*gx + gy*gy) + gz*gz with every operation rounded on its
// own (no FMA), listed when gap^2 <= r2. In fp32 gap^2 <= d2 holds for
// every query in the box and every point in the tile (each rounding is
// monotone), so a tile that holds a point at exactly d2 == r2 is listed.
#pragma once

#include "knn_common.cuh"

constexpr int kListCap = 1024;  // tiles listed at a time (shared memory)

// Scratch of the listing for a block of kThreads threads.
template <int kThreads>
struct TileScratch {
  float red[kThreads / 32][6];  // the warps' boxes
  int warp_cnt[kThreads / 32];
  int list[kListCap];
};

struct Box {
  float lo[3], hi[3];
};

__device__ __forceinline__ float box_gap2(const Box& b,
                                          const float* __restrict__ t_lo,
                                          const float* __restrict__ t_hi,
                                          int tile) {
  float g[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    g[a] = fmaxf(fmaxf(__fsub_rn(b.lo[a], t_hi[3 * tile + a]),
                       __fsub_rn(t_lo[3 * tile + a], b.hi[a])), 0.f);
  }
  return __fadd_rn(__fadd_rn(__fmul_rn(g[0], g[0]), __fmul_rn(g[1], g[1])),
                   __fmul_rn(g[2], g[2]));
}

__device__ __forceinline__ bool box_in_radius(const Box& b,
                                              const float* __restrict__ t_lo,
                                              const float* __restrict__ t_hi,
                                              int tile, float r2) {
  return box_gap2(b, t_lo, t_hi, tile) <= r2;
}

// The box of the warp's live queries (empty: lo = +inf, hi = -inf, within
// the radius of nothing); the warps' boxes stay in sc.red for list_tiles.
// Every thread of the block calls this; it ends in a barrier.
template <int kThreads>
__device__ __forceinline__ Box query_boxes(float qx, float qy, float qz,
                                           bool live,
                                           TileScratch<kThreads>& sc) {
  const float inf = __int_as_float(0x7f800000);
  const float q[3] = {qx, qy, qz};
  Box w;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    w.lo[a] = live ? q[a] : inf;
    w.hi[a] = live ? q[a] : -inf;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      w.lo[a] = fminf(w.lo[a], __shfl_xor_sync(0xffffffffu, w.lo[a], d));
      w.hi[a] = fmaxf(w.hi[a], __shfl_xor_sync(0xffffffffu, w.hi[a], d));
    }
  }
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      sc.red[wi][a] = w.lo[a];
      sc.red[wi][3 + a] = w.hi[a];
    }
  }
  __syncthreads();
  return w;
}

// List the tiles of [t0, min(t0 + kListCap, T)) within the radius of the
// block's box (of the warps' boxes that query_boxes left in sc.red) into
// sc.list, ascending; returns their number. Every thread of the block
// calls this; sc.list is the block's to read after it returns, and must
// not be in use when it is called (the caller's barrier).
template <int kThreads>
__device__ __forceinline__ int list_tiles(const float* __restrict__ t_lo,
                                          const float* __restrict__ t_hi,
                                          int t0, int T, float r2,
                                          TileScratch<kThreads>& sc) {
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  Box box;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    box.lo[a] = sc.red[0][a];
    box.hi[a] = sc.red[0][3 + a];
    for (int i = 1; i < kThreads / 32; ++i) {
      box.lo[a] = fminf(box.lo[a], sc.red[i][a]);
      box.hi[a] = fmaxf(box.hi[a], sc.red[i][3 + a]);
    }
  }
  const int t1 = min(t0 + kListCap, T);
  int n_list = 0;
  for (int tb = t0; tb < t1; tb += kThreads) {
    const int t = tb + threadIdx.x;
    const bool hit = t < t1 && box_in_radius(box, t_lo, t_hi, t, r2);
    const unsigned hits = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) sc.warp_cnt[wi] = __popc(hits);
    __syncthreads();
    int at = n_list;
    for (int i = 0; i < kThreads / 32; ++i) {
      const int c = sc.warp_cnt[i];
      if (i < wi) at += c;
      n_list += c;
    }
    if (hit) sc.list[at + __popc(hits & ((1u << lane) - 1u))] = t;
    __syncthreads();
  }
  return n_list;
}
