// The feat_net chain shared by K4 (featmlp.cu) and K6 (agg.cu), written for
// Hopper: persistent blocks, the weights resident in shared memory, wgmma
// products with the accumulators in registers, the layers chained through
// registers.
//
// What bounds it on the H100: at the bench shape (573,440 MLP rows, F = 128,
// 4 layers) 84 GFLOP of bf16 tensor-core work against 49-193 MB of operands,
// so the tensor cores are the limit provided that nothing but the operands
// and the reduced result crosses device memory, the weights are not re-read
// per tile, and the activations never pass through shared memory.
// Design:
// - One block an SM, kGroups warpgroups a block. A warpgroup owns 64-row
//   tiles of MLP rows and walks over them on its own (its barriers are named
//   barriers of 128 threads), so one warpgroup's encoding and epilogues
//   overlap the others' products.
// - All layers' bf16 weights are copied once a block into shared memory as
//   the image `pack_weights` lays out host-side: per layer, 64-wide K chunks
//   of [F rows (n)] x [64 k] in the K-major 128-byte-swizzled layout wgmma
//   reads as B (wgmma_sm90.cuh). Layer 1's K order is [feature rows | PE
//   rows], each padded to whole chunks. Layers that do not fit beside the
//   operand tiles (F = 128 with 5 or more layers) are streamed through one
//   more slot, the block in lock step for those layers only (plan_chain).
// - Layer 1's feature half takes A from registers: a lane loads its two
//   rows' features from device memory as 16-byte vectors straight into A
//   fragments (load_feat; the K order this gives is folded into the weight
//   image), one step ahead. The PE half is the only operand built in shared
//   memory: a swizzled tile a warpgroup, computed once per (row, axis,
//   frequency) with sincosf. The next step's rows are prepared and encoded
//   in slices while the current step's hidden-layer products are in flight
//   (wgmma is asynchronous), so the encoding overlaps the products instead
//   of preceding them.
// - Layers 2.. take A from registers: bias, leaky-ReLU (0.01) and the bf16
//   round are applied to the accumulator fragment, whose pairs are exactly
//   the next product's A fragment.
// - The weighted reduction over a member's rows: 8 adjacent rows sit in the
//   8 lane groups of one warp, so at 8 rows a member (and F >= 64) it is a
//   shuffle butterfly that also halves the columns a lane holds at every
//   step; any other row count goes through a small shared tile, 16 columns
//   at a time. Only the reduced fp32 rows are written.
// The callers supply a front end (`Front`): where a row's 3-vector, weight
// and feature row come from (K4: global arrays or, in its gathering front,
// the frame's point tables; K6: the subgroup geometry it forms in shared
// memory).
#pragma once

#include <type_traits>

#include "wgmma_sm90.cuh"

namespace featmlp {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kGroups = 3;             // warpgroups a block
constexpr int kGroupThreads = 128;
constexpr int kThreads = kGroups * kGroupThreads;
constexpr int kTileRows = 64;          // rows of one wgmma, a warpgroup's tile
constexpr int kChunkBytes = 128;       // one swizzled row: 64 bf16 of K
constexpr int kTileChunkBytes = kTileRows * kChunkBytes;
constexpr int kMaxMemberRows = 128;    // rows reduced into one output row
constexpr int kSmemLimit = 232448;     // dynamic shared memory a block may have
constexpr int kReduceCols = 16;        // columns a pass of the shared reduce
constexpr int kReduceStride = kReduceCols + 1;

// Per row slot of a member group the 3-vector to encode and the reduction
// weight: two a warpgroup, the current step's and the next's.
struct RowData {
  float x[kMaxMemberRows * 3];
  float wrow[kMaxMemberRows];
};

// A warpgroup's transient scratch: K6's geometry while a step is prepared,
// the shared reduction's tile at a step's end.
struct Scratch {
  float tn[kMaxMemberRows];            // K6: squared distances
  float cand[kMaxMemberRows * 12];     // K6: candidate positions, rotations
  float wraw[kMaxMemberRows];          // K6: weights before normalisation
  unsigned char top[kMaxMemberRows];   // K6: among the K nearest
};

constexpr int kGroupScratchBytes = 2 * sizeof(RowData) + sizeof(Scratch);
// kernels/featmlp.py:SCRATCH_BYTES adds up the same fields
static_assert(sizeof(RowData) == kMaxMemberRows * (3 + 1) * 4 &&
                  sizeof(Scratch) == kMaxMemberRows * (4 + 12 * 4 + 4 + 1),
              "featmlp.py:SCRATCH_BYTES assumes these fields, unpadded");

// Shared-memory layout of a launch; the same rule in Python:
// apnerf_torch/kernels/featmlp.py:chain_plan.
struct ChainPlan {
  int n_layers;
  int resident;      // layers 0 .. resident - 1 stay in shared memory
  int w1_bytes;      // weight image of layer 1, of a hidden layer
  int wh_bytes;
  int pe_bytes;      // a warpgroup's PE operand tile
  int off_stream;    // slot of the streamed layers (if resident < n_layers)
  int off_operand;
  int off_scratch;
  int smem_bytes;
};

// False when not even layer 1 and a streaming slot fit (a huge P_pad).
inline bool plan_chain(int F, int P_pad, int n_layers, ChainPlan* p) {
  const int chunks_f = (F + 63) / 64, chunks_p = (P_pad + 63) / 64;
  p->n_layers = n_layers;
  p->w1_bytes = (chunks_f + chunks_p) * F * kChunkBytes;
  p->wh_bytes = chunks_f * F * kChunkBytes;
  p->pe_bytes = chunks_p * kTileChunkBytes;
  const int fixed = kGroups * (p->pe_bytes + kGroupScratchBytes);
  for (int r = n_layers; r >= 1; --r) {
    const long long weights = (long long)p->w1_bytes +
                              (long long)(r - 1) * p->wh_bytes +
                              (r < n_layers ? p->wh_bytes : 0);
    if (weights + fixed > kSmemLimit) continue;
    p->resident = r;
    p->off_stream = p->w1_bytes + (r - 1) * p->wh_bytes;
    p->off_operand = (int)weights;
    p->off_scratch = p->off_operand + kGroups * p->pe_bytes;
    p->smem_bytes = p->off_scratch + kGroups * kGroupScratchBytes;
    return true;
  }
  return false;
}

// How the MLP rows group into members (the rows reduced into one output
// row): a tile holds `mpt` whole members of `kc` rows; a member of more
// than 64 rows takes two passes of one tile.
struct Rows {
  int n_members;
  int kc;
  int mpt;
  int n_pass;
  int n_tiles;
  float inv_kc;      // 1 / kc: (r + 0.5) * inv_kc truncates to r / kc, r < 128
};

inline Rows make_rows(int n_members, int kc) {
  Rows r;
  r.n_members = n_members;
  r.kc = kc;
  r.mpt = kc <= kTileRows ? kTileRows / kc : 1;
  r.n_pass = kc <= kTileRows ? 1 : 2;
  r.n_tiles = (n_members + r.mpt - 1) / r.mpt;
  r.inv_kc = 1.0f / (float)kc;
  return r;
}

// Row r of pass `pass` of the tile whose first member is g0: its member
// (local index ml) and its position k inside the member; false for a row
// that holds nothing.
__device__ __forceinline__ bool row_member(const Rows& rows, int r, int pass,
                                           int g0, int& ml, int& k) {
  if (rows.n_pass == 1) {
    ml = __float2int_rz(((float)r + 0.5f) * rows.inv_kc);
    k = r - ml * rows.kc;
    return ml < rows.mpt && g0 + ml < rows.n_members;
  }
  ml = 0;
  k = pass * kTileRows + r;
  return k < rows.kc;
}

__device__ __forceinline__ float leaky(float v) {
  return fmaxf(v, 0.01f * v);          // v >= 0 ? v : 0.01 v
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// acc <- leaky(acc + bias) on the accumulator fragment (columns 8 j + 2 (l %
// 4) + {0, 1} of two rows); kRound: rounded to bf16 and back.
template <int F, bool kRound>
__device__ __forceinline__ void bias_act(float (&acc)[F / 2],
                                         const float* __restrict__ bias,
                                         int lane) {
#pragma unroll
  for (int j = 0; j < F / 8; ++j) {
    const float2 b =
        __ldg(reinterpret_cast<const float2*>(bias + 8 * j + 2 * (lane & 3)));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = leaky(acc[4 * j + i] + ((i & 1) ? b.y : b.x));
      if (kRound) v = __bfloat162float(__float2bfloat16(v));
      acc[4 * j + i] = v;
    }
  }
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// acc += a column vector (layer 1's pose term, before its round).
template <int F>
__device__ __forceinline__ void add_columns(float (&acc)[F / 2],
                                            const float* __restrict__ v,
                                            int lane) {
#pragma unroll
  for (int j = 0; j < F / 8; ++j) {
    const float2 d =
        __ldg(reinterpret_cast<const float2*>(v + 8 * j + 2 * (lane & 3)));
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[4 * j + i] += (i & 1) ? d.y : d.x;
  }
}

// featnet_plain's rounding on the accumulator fragment, as PyTorch computes
// x @ w.t() + b and leaky_relu in bf16: the product rounded to bf16, the
// bias (bf16 values) added and rounded, leaky-ReLU applied and rounded.
template <int F>
__device__ __forceinline__ void plain_act(float (&acc)[F / 2],
                                          const float* __restrict__ bias,
                                          int lane) {
#pragma unroll
  for (int j = 0; j < F / 8; ++j) {
    const float2 b =
        __ldg(reinterpret_cast<const float2*>(bias + 8 * j + 2 * (lane & 3)));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v =
          bf16_round(bf16_round(acc[4 * j + i]) + ((i & 1) ? b.y : b.x));
      acc[4 * j + i] = bf16_round(leaky(v));
    }
  }
}

// Optional properties of a front, false unless it declares them true:
// kPlainRound, every layer in featnet_plain's rounding (plain_act, after
// layer 1's pose term `front.pose` where there is one) instead of
// bias_act's fp32 bias; kLivePrefix, only the members before the count at
// `front.live` (when given) are worked on, the front clearing the others'
// outputs (`clear_tail`).
template <class Fr, class = void>
struct plain_round : std::false_type {};
template <class Fr>
struct plain_round<Fr, std::void_t<decltype(Fr::kPlainRound)>>
    : std::bool_constant<Fr::kPlainRound> {};
template <class Fr, class = void>
struct live_prefix : std::false_type {};
template <class Fr>
struct live_prefix<Fr, std::void_t<decltype(Fr::kLivePrefix)>>
    : std::bool_constant<Fr::kLivePrefix> {};

// The members a launch works on: all, or those of the live prefix.
template <class Front>
__device__ __forceinline__ Rows live_rows(const Front& front,
                                          const Rows& rows) {
  if constexpr (live_prefix<Front>::value) {
    if (front.live != nullptr) {
      Rows r = rows;
      r.n_members = min(max(__ldg(front.live), 0), rows.n_members);
      r.n_tiles = (r.n_members + r.mpt - 1) / r.mpt;
      return r;
    }
  }
  return rows;
}

// Column c of a row of a warpgroup's PE tile; row_ptr = tile + 128 r, swz =
// (r % 8) * 16 (the swizzle moves bits 4-6 of the offset inside the row).
__device__ __forceinline__ void pe_store(unsigned char* row_ptr, int swz,
                                         int c, float v) {
  *reinterpret_cast<bf16*>(row_ptr + (c >> 6) * kTileChunkBytes +
                           ((((c << 1) & 127)) ^ swz)) = __float2bfloat16(v);
}

// Slice `slice` of `n_slices` of the PE tile of the 64 rows whose 3-vectors
// are x[0 .. 64 * 3): [x, sin(x_a 2^i), cos(x_a 2^i), 0 pad], channel a *
// n_pe + i inside the sin and cos blocks. Two threads a row, each half of
// the frequencies; a slice is a share of a thread's frequencies (slice 0
// also writes x and the zero pad). sincosf, not the fast-math intrinsics:
// arguments reach x * 2^9 (and ~1e12 on K6's sentinel rows, which must stay
// finite).
__device__ __forceinline__ void encode_pe(unsigned char* pe_buf,
                                          const float* x, int n_pe, int P_pad,
                                          int t, int slice, int n_slices) {
  const int r = t & (kTileRows - 1);
  const int half = t / kTileRows;
  unsigned char* row_ptr = pe_buf + r * kChunkBytes;
  const int swz = (r & 7) << 4;
  const float xs[3] = {x[3 * r + 0], x[3 * r + 1], x[3 * r + 2]};
  if (slice == 0) {
    if (half == 0) {
#pragma unroll
      for (int a = 0; a < 3; ++a) pe_store(row_ptr, swz, a, xs[a]);
    } else {
      for (int c = 3 * (1 + 2 * n_pe); c < P_pad; ++c) {
        pe_store(row_ptr, swz, c, 0.f);
      }
    }
  }
  const int h0 = half ? n_pe / 2 : 0;
  const int hn = half ? n_pe - n_pe / 2 : n_pe / 2;
  const int f0 = h0 + hn * slice / n_slices;
  const int f1 = h0 + hn * (slice + 1) / n_slices;
  for (int f = f0; f < f1; ++f) {
    const float scale = (float)(1 << f);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float sn, cs;
      sincosf(xs[a] * scale, &sn, &cs);
      pe_store(row_ptr, swz, 3 + a * n_pe + f, sn);
      pe_store(row_ptr, swz, 3 + 3 * n_pe + a * n_pe + f, cs);
    }
  }
}

// Order in which a feature row's columns enter layer 1's K dimension. A
// lane loads its two rows' features from device memory as 16-byte vectors
// (lane quad index q takes vectors q, q + 4, ...: a warp reads 64 contiguous
// bytes of each of 8 rows) straight into A fragments: vector q + 4 i fills
// the k16 steps 2 i and 2 i + 1. K position p of the fragments therefore
// holds column feat_k_order(p); pack_weights orders layer 1's feature rows
// the same way (kernels/featmlp.py:feat_k_order). A row that holds nothing
// reads feature row 0: its result is never stored, and a select on the
// loaded value would make the load synchronous.
//   p = 32 i + 16 u + 8 v + 2 q + e  ->  column 8 (q + 4 i) + 4 u + 2 v + e
template <int F, class Front>
__device__ __forceinline__ void load_feat(const Front& front, const Rows& rows,
                                          int g0, int pass,
                                          uint32_t (&a)[F / 16][4], int warp,
                                          int lane) {
  const int q = lane & 3;
  const auto ctx = front.ctx(rows, g0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + (lane >> 2) + 8 * h;
    int ml, k;
    const bool live = row_member(rows, r, pass, g0, ml, k);
    const uint4* src = reinterpret_cast<const uint4*>(front.feat);
    if (live) src += front.feat_row(ctx, ml, k, rows.kc) * (F / 8);
#pragma unroll
    for (int i = 0; i < F / 32; ++i) {
      const uint4 u = __ldg(src + q + 4 * i);
      a[2 * i][h] = u.x;
      a[2 * i][2 + h] = u.y;
      a[2 * i + 1][h] = u.z;
      a[2 * i + 1][2 + h] = u.w;
    }
  }
}

// Weighted sum over the 8 rows of each member, held by the 8 lane groups of
// a warp: three shuffle steps, each of which also halves the column blocks
// a lane keeps. acc already carries the row weights. Writes out[g, :].
template <int F>
__device__ __forceinline__ void reduce8_store(float (&acc)[F / 2],
                                              float* __restrict__ out, int g0,
                                              int n_members, int warp,
                                              int lane) {
  static_assert(F >= 64, "needs at least 8 column blocks");
  constexpr int NJ = F / 8;
  const bool hi1 = lane & 16, hi2 = lane & 8, hi3 = lane & 4;
  float r1[NJ * 2];
#pragma unroll
  for (int i = 0; i < NJ * 2; ++i) {
    const float keep = hi1 ? acc[NJ * 2 + i] : acc[i];
    const float send = hi1 ? acc[i] : acc[NJ * 2 + i];
    r1[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
  float r2[NJ];
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    const float keep = hi2 ? r1[NJ + i] : r1[i];
    const float send = hi2 ? r1[i] : r1[NJ + i];
    r2[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  float r3[NJ / 2];
#pragma unroll
  for (int i = 0; i < NJ / 2; ++i) {
    const float keep = hi3 ? r2[NJ / 2 + i] : r2[i];
    const float send = hi3 ? r2[i] : r2[NJ / 2 + i];
    r3[i] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
  }
  const int j0 = (hi1 ? NJ / 2 : 0) + (hi2 ? NJ / 4 : 0) + (hi3 ? NJ / 8 : 0);
#pragma unroll
  for (int jj = 0; jj < NJ / 8; ++jj) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int g = g0 + 2 * warp + h;
      if (g < n_members) {
        *reinterpret_cast<float2*>(out + (size_t)g * F + 8 * (j0 + jj) +
                                   2 * (lane & 3)) =
            make_float2(r3[4 * jj + 2 * h], r3[4 * jj + 2 * h + 1]);
      }
    }
  }
}

// The same sum for any member size, through a [64, 16] fp32 tile in the
// warpgroup's scratch, 16 columns a pass.
// A second pass of a member of more than 64 rows adds to the first's.
template <int F>
__device__ __forceinline__ void reduce_any_store(
    float (&acc)[F / 2], float* red, float* __restrict__ out, const Rows& rows,
    int g0, int pass, int bar, int t) {
  const int warp = t >> 5, lane = t & 31;
  const int r0 = 16 * warp + (lane >> 2);
  const int col = t % kReduceCols;
  const int cnt = rows.n_pass == 1 ? rows.kc
                                   : min(kTileRows, rows.kc - pass * kTileRows);
#pragma unroll
  for (int jp = 0; jp < F / kReduceCols; ++jp) {
    named_barrier(bar, kGroupThreads);   // the previous pass has been read
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = 2 * jp + jj;
      const int c = 8 * jj + 2 * (lane & 3);
      red[r0 * kReduceStride + c] = acc[4 * j + 0];
      red[r0 * kReduceStride + c + 1] = acc[4 * j + 1];
      red[(r0 + 8) * kReduceStride + c] = acc[4 * j + 2];
      red[(r0 + 8) * kReduceStride + c + 1] = acc[4 * j + 3];
    }
    named_barrier(bar, kGroupThreads);
    for (int ml = t / kReduceCols; ml < rows.mpt; ml += kGroupThreads / kReduceCols) {
      const int g = g0 + ml;
      if (g >= rows.n_members) break;
      const int rbeg = rows.n_pass == 1 ? ml * rows.kc : 0;
      float s = 0.f;
      for (int k = 0; k < cnt; ++k) s += red[(rbeg + k) * kReduceStride + col];
      float* o = out + (size_t)g * F + kReduceCols * jp + col;
      *o = pass ? *o + s : s;
    }
  }
  named_barrier(bar, kGroupThreads);     // the tile is free for the next step
}

// One launch: every warpgroup of every block walks over its tiles.
// Front: kRoundLast (the last layer rounded to bf16, K4; not read under
// kPlainRound) | the optional kPlainRound / kLivePrefix (above) | feat | out |
// ctx(rows, g0), feat_row(ctx, ml, k, kc): the feature row of position k of
// the tile's member ml | Pre, fetch(pre, scratch, rows, g0, pass, t): starts
// a step's loads from device memory (into registers or, by cp.async, into
// the scratch) | prepare(row_data, scratch, pre, rows, g0, pass, t, bar):
// fills row_data.x / .wrow of the pass's 64 row slots (at pass * 64).
template <int F, class Front>
__global__ void __launch_bounds__(kThreads, 1)
    chain_kernel(const Front front, const ChainPlan plan, const Rows all_rows,
                 const unsigned char* __restrict__ image,
                 const float* __restrict__ b1, const float* __restrict__ bl,
                 int n_pe, int P_pad) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const Rows rows = live_rows(front, all_rows);
  constexpr int kChunksF = (F + 63) / 64;
  constexpr int kChunkW = F * kChunkBytes;   // one K chunk of a weight image
  const uint32_t base = smem_u32(smem);
  if (base & 1023) __trap();                 // the swizzle needs 1024 bytes
  const int wg = threadIdx.x / kGroupThreads;
  const int t = threadIdx.x % kGroupThreads;
  const int warp = t >> 5, lane = t & 31;
  const int bar = 1 + wg;
  unsigned char* pe_buf = smem + plan.off_operand + wg * plan.pe_bytes;
  const uint32_t pe_addr = smem_u32(pe_buf);
  unsigned char* scratch = smem + plan.off_scratch + wg * kGroupScratchBytes;
  RowData* row_data = reinterpret_cast<RowData*>(scratch);      // [2]
  Scratch& sc = *reinterpret_cast<Scratch*>(scratch + 2 * sizeof(RowData));

  // ---- the resident layers, once a block
  const int resident_bytes =
      plan.w1_bytes + (plan.resident - 1) * plan.wh_bytes;
  for (int u = threadIdx.x * 16; u < resident_bytes; u += kThreads * 16) {
    cp_async16(base + u, image + u);
  }
  cp_async_commit();
  if constexpr (live_prefix<Front>::value) {   // while the weights arrive
    front.clear_tail(rows, all_rows.n_members, F,
                     blockIdx.x * kThreads + threadIdx.x,
                     gridDim.x * kThreads);
  }
  cp_async_wait_all();
  fence_async_proxy();
  __syncthreads();

  // A warpgroup's steps: its tiles (every `workers`-th), each of n_pass
  // passes. A tile's passes share one RowData.
  const int workers = gridDim.x * kGroups;
  const int worker = blockIdx.x * kGroups + wg;
  const int local_steps =
      (rows.n_tiles + workers - 1) / workers * rows.n_pass;
  const bool butterfly = F >= 64 && rows.kc == 8;
  const int L = plan.n_layers;
  const int n_slices = L > 1 ? L - 1 : 1;
  auto step_tile = [&](int ls, int& it, int& pass) {
    it = ls / rows.n_pass;
    pass = ls - it * rows.n_pass;
    const int tile = worker + it * workers;
    return ls < local_steps && tile < rows.n_tiles ? tile : -1;
  };

  // layer 1's feature operand (then each hidden layer's operand): the next
  // step's features are loaded into it once the last hidden layer has run
  uint32_t a[F / 16][4];
  typename Front::Pre pre;
  if (worker < rows.n_tiles) {               // step 0, nothing to hide behind
    const int g0 = worker * rows.mpt;
    load_feat<F>(front, rows, g0, 0, a, warp, lane);
    front.fetch(pre, sc, rows, g0, 0, t);
    front.prepare(row_data[0], sc, pre, rows, g0, 0, t, bar);
    named_barrier(bar, kGroupThreads);
    encode_pe(pe_buf, row_data[0].x, n_pe, P_pad, t, 0, 1);
  }

  for (int ls = 0; ls < local_steps; ++ls) {
    int it, pass, nit, npass;
    const int tile = step_tile(ls, it, pass);
    const int ntile = step_tile(ls + 1, nit, npass);
    const bool has = tile >= 0;              // uniform over the warpgroup
    const bool has_next = ntile >= 0;
    const int g0 = tile * rows.mpt;
    const int ng0 = ntile * rows.mpt;
    const RowData& cur = row_data[it & 1];
    RowData& next = row_data[nit & 1];
    float acc[F / 2];

    if (has) {
      if (has_next) front.fetch(pre, sc, rows, ng0, npass, t);
      fence_async_proxy();
      named_barrier(bar, kGroupThreads);     // this step's PE tile is written

      // ---- layer 1: features from registers, then the PE tile
#pragma unroll
      for (int s = 0; s < F / 16; ++s) pin_registers(a[s]);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < F / 16; ++s) {
        wgmma_rs(acc, a[s],
                 operand_desc(base + (s >> 2) * kChunkW + (s & 3) * 32), s > 0);
      }
      for (int s = 0; s < P_pad / 16; ++s) {
        const uint32_t off = (s >> 2) * kTileChunkBytes + (s & 3) * 32;
        const uint32_t woff = (kChunksF + (s >> 2)) * kChunkW + (s & 3) * 32;
        wgmma_ss(acc, operand_desc(pe_addr + off), operand_desc(base + woff),
                 1);
      }
      wgmma_commit();
      if (has_next) {                        // under layer 1's products
        front.prepare(next, sc, pre, rows, ng0, npass, t, bar);
        named_barrier(bar, kGroupThreads);
      }
      wgmma_wait<0>();
      pin_registers(acc);
#pragma unroll
      for (int s = 0; s < F / 16; ++s) pin_registers(a[s]);  // read till here
      if (has_next && L == 1) {              // no hidden layer to hide behind
        named_barrier(bar, kGroupThreads);   // every warp is past layer 1
        encode_pe(pe_buf, next.x + 3 * npass * kTileRows, n_pe, P_pad, t, 0, 1);
      }
    }

    // ---- layers 2..: A from the accumulator registers
    for (int l = 1; l < L; ++l) {
      uint32_t w_addr = base + plan.w1_bytes + (l - 1) * plan.wh_bytes;
      if (l >= plan.resident) {              // streamed: the block in lock step
        w_addr = base + plan.off_stream;
        const unsigned char* src = image + plan.w1_bytes +
                                   (size_t)(l - 1) * plan.wh_bytes;
        __syncthreads();                     // the slot's last readers are done
        for (int u = threadIdx.x * 16; u < plan.wh_bytes; u += kThreads * 16) {
          cp_async16(w_addr + u, src + u);
        }
        cp_async_commit();
        cp_async_wait_all();
        fence_async_proxy();
        __syncthreads();
      }
      if (!has) continue;
      // (the bf16 round of this layer's output is the packing below)
      if constexpr (plain_round<Front>::value) {
        if (l == 1 && front.pose != nullptr) {
          add_columns<F>(acc, front.pose, lane);
        }
        plain_act<F>(acc, l == 1 ? b1 : bl + (size_t)(l - 2) * F, lane);
      } else {
        bias_act<F, false>(acc, l == 1 ? b1 : bl + (size_t)(l - 2) * F, lane);
      }
#pragma unroll
      for (int s = 0; s < F / 16; ++s) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[s][i] = pack_bf16(acc[8 * s + 2 * i], acc[8 * s + 2 * i + 1]);
        }
        pin_registers(a[s]);
      }
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < F / 16; ++s) {
        wgmma_rs(acc, a[s],
                 operand_desc(w_addr + (s >> 2) * kChunkW + (s & 3) * 32),
                 s > 0);
      }
      wgmma_commit();
      if (has_next) {                        // under this layer's products
        if (l == 1) named_barrier(bar, kGroupThreads);  // all past layer 1
        encode_pe(pe_buf, next.x + 3 * npass * kTileRows, n_pe, P_pad, t,
                  l - 1, n_slices);
      }
      wgmma_wait<0>();
      pin_registers(acc);
#pragma unroll
      for (int s = 0; s < F / 16; ++s) pin_registers(a[s]);  // read till here
    }
    if (!has) continue;

    // ---- the next step's features, in flight until its layer 1
    if (has_next) load_feat<F>(front, rows, ng0, npass, a, warp, lane);

    // ---- last layer's epilogue, row weights, reduction over the members
    if constexpr (plain_round<Front>::value) {
      if (L == 1 && front.pose != nullptr) {
        add_columns<F>(acc, front.pose, lane);
      }
      plain_act<F>(acc, L == 1 ? b1 : bl + (size_t)(L - 2) * F, lane);
    } else {
      bias_act<F, Front::kRoundLast>(
          acc, L == 1 ? b1 : bl + (size_t)(L - 2) * F, lane);
    }
    const int slot0 = pass * kTileRows;
    const float w0 = cur.wrow[slot0 + 16 * warp + (lane >> 2)];
    const float w1 = cur.wrow[slot0 + 16 * warp + (lane >> 2) + 8];
#pragma unroll
    for (int j = 0; j < F / 8; ++j) {
      acc[4 * j + 0] *= w0;
      acc[4 * j + 1] *= w0;
      acc[4 * j + 2] *= w1;
      acc[4 * j + 3] *= w1;
    }
    if constexpr (F >= 64) {
      if (butterfly) {
        reduce8_store<F>(acc, front.out, g0, rows.n_members, warp, lane);
        continue;
      }
    }
    reduce_any_store<F>(acc, sc.cand, front.out, rows, g0, pass, bar, t);
  }
}

// The SMs of the current device into *count.
inline cudaError_t sm_count(int* count) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(count, cudaDevAttrMultiProcessorCount, dev);
}

// One block an SM (fewer when there are fewer tiles than warpgroups).
template <int F, class Front>
int launch_chain(const Front& front, const Rows& rows, int n_pe, int P_pad,
                 int n_layers, const void* image, const float* b1,
                 const float* bl, cudaStream_t stream) {
  ChainPlan plan;
  if (!plan_chain(F, P_pad, n_layers, &plan)) return (int)cudaErrorInvalidValue;
  auto kernel = chain_kernel<F, Front>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const int blocks = min(sms, (rows.n_tiles + kGroups - 1) / kGroups);
  kernel<<<blocks, kThreads, plan.smem_bytes, stream>>>(
      front, plan, rows, static_cast<const unsigned char*>(image), b1, bl,
      n_pe, P_pad);
  return (int)cudaGetLastError();
}

}  // namespace featmlp
