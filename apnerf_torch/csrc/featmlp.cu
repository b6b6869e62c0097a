// K4: fused positional encoding + feat_net MLP + weighted K-reduction.
//
// Replaces apnerf/kernels/featmlp_pallas.py:featmlp_agg (_kernel,
// _run_kernel):
//   h[m] = sum_k w[m,k] * feat_net(poc_fre(rel[m,k]) ++ feat[m,k])
// with bf16 x bf16 -> fp32 GEMMs, the bias added in fp32, leaky-ReLU
// (slope 0.01) and a bf16 rounding after every layer; a pose embedding is
// folded into the layer-1 bias by the host.
// Bound on the H100: at the bench shape (573,440 rows, F = 128, 4 layers)
// 84 GFLOP of bf16 tensor-core work (0.085 ms at the peak) against 193 MB of
// operands (0.058 ms), so the tensor cores bound it as long as the
// activations never leave the SM and the 147 KB of weights are read once a
// block, not once a tile.
// Design: the persistent wgmma chain of featmlp_chain.cuh (shared with K6,
// agg.cu). K4's front end is the plain one: a member is one output row m
// with its K neighbour rows; a row's 3-vector and weight come from rel and
// w, fetched into registers a step ahead, its feature row from feat
// straight into the A fragments of layer 1. The last layer is rounded to
// bf16 like the others; at K = 8 the K-reduction is the chain's shuffle
// butterfly. The ragged last tile is bound-checked, nothing is padded.
//
// K4's gathering front (featmlp_gather_launch) is the exact render path's
// aggregation in one launch, in place of the gathers, the offsets, the
// weights, the rotation, featnet_plain and the weighted K-sum of
// models/temporal_points.py:_exact_slots (the JAX package runs the same
// XLA formulation there: apnerf/train/stage2.py:99, featmlp_kernel off):
//   d[m,k]   = q[m] - pos[idx[m,k]]               (each op rounded, no FMA)
//   d2[m,k]  = (d.x d.x + d.z d.z) + d.y d.y,  kth[m] = max_k d2[m,k]
//   w[m,k]   = 1 / (d2 + eps), over its sum along k (a pairwise tree)
//   h[m]     = sum_k w[m,k] * feat_net(poc_fre(rot[idx] d) ++ feat[idx])
// with every layer in featnet_plain's rounding: the fp32 product (plus the
// pose embedding's layer-1 term) rounded to bf16, the bf16 bias added and
// rounded, leaky-ReLU, rounded. d2 and the weights' sum are added in the
// order PyTorch's reduction adds the plain path's on the card (a row of 3
// or K <= 32 on a power of two of threads, then shuffles of offset 1, 2,
// 4, ...: (x + z) + y; ((w0 + w1) + (w2 + w3)) + ...), so kth, and with it
// the radius cutoff, keeps the samples the plain path keeps, and the
// weights are the plain path's. That order is the installed PyTorch build's
// (read from torch 2.11.0+cu128, CUDA 12.8), not the formulation's: after
// an upgrade of torch, rerun chip_smoke.py phase 3, whose "kth bit-equal"
// gate is the check that the order still holds.
// Bound on the H100: at the render's chunk (141,824 slots, K = 8, F = 128,
// 4 layers) 167 GFLOP of bf16 products (0.17 ms at the peak) against
// ~84 MB of slots, indices and results; the 10^4-point tables (0.5 MB of
// geometry, 2.6 MB of bf16 features) stay in L2. The plain path moved every
// intermediate ([n K, 191] / [n K, 128] a layer) through device memory.
// Design: a row's table row is fetched a step ahead, its slot's position
// and its geometry gathered while the step's layer 1 runs, the member's
// weights normalised through the warpgroup's scratch; the feature rows are
// loaded by their table row straight into layer 1's A fragments.
// The slots come compacted, the passing ones first (_budget_compact): the
// kernel reads their count on the device and skips the tiles past it,
// whose outputs it clears (h 0, kth +inf, w 0).
#include "featmlp_chain.cuh"

using namespace featmlp;

namespace {

struct RowFront {
  const float* __restrict__ rel;
  const float* __restrict__ w;
  const bf16* __restrict__ feat;
  float* __restrict__ out;
  static constexpr bool kRoundLast = true;

  struct Ctx {
    long long row0;
  };
  __device__ __forceinline__ Ctx ctx(const Rows& rows, int g0) const {
    return Ctx{(long long)g0 * rows.kc};
  }
  __device__ __forceinline__ long long feat_row(const Ctx& c, int ml, int k,
                                                int kc) const {
    return c.row0 + ml * kc + k;
  }

  struct Pre {
    float x0, x1, x2, w;
  };

  __device__ __forceinline__ void fetch(Pre& p, Scratch&, const Rows& rows,
                                        int g0, int pass, int t) const {
    p.x0 = p.x1 = p.x2 = p.w = 0.f;
    int ml, k;
    if (t < kTileRows && row_member(rows, t, pass, g0, ml, k)) {
      const size_t row = (size_t)(g0 + ml) * rows.kc + k;
      p.x0 = rel[row * 3 + 0];
      p.x1 = rel[row * 3 + 1];
      p.x2 = rel[row * 3 + 2];
      p.w = w[row];
    }
  }

  __device__ __forceinline__ void prepare(RowData& rd, Scratch&, const Pre& p,
                                          const Rows&, int /*g0*/, int pass,
                                          int t, int /*bar*/) const {
    if (t >= kTileRows) return;
    const int slot = pass * kTileRows + t;
    rd.x[3 * slot + 0] = p.x0;
    rd.x[3 * slot + 1] = p.x1;
    rd.x[3 * slot + 2] = p.x2;
    rd.wrow[slot] = p.w;
  }
};

struct GatherRowFront {
  const float* __restrict__ q;       // [n, 3]
  const int* __restrict__ idx;       // [n, K]: rows of the tables
  const float* __restrict__ geo;     // [Pp, 12]: position, rotation (row-major)
  const bf16* __restrict__ feat;     // [Pp, F]
  const float* __restrict__ pose;    // [F] or null: layer 1's pose term
  const int* __restrict__ live;      // [1] or null: members of the prefix
  float* __restrict__ out;           // h [n, F]
  float* __restrict__ kth;           // [n]
  float* __restrict__ wout;          // [n, K] or null
  float eps;
  static constexpr bool kPlainRound = true;
  static constexpr bool kLivePrefix = true;

  struct Ctx {
    long long row0;
  };
  __device__ __forceinline__ Ctx ctx(const Rows& rows, int g0) const {
    return Ctx{(long long)g0 * rows.kc};
  }
  __device__ __forceinline__ long long feat_row(const Ctx& c, int ml, int k,
                                                int kc) const {
    return __ldg(idx + c.row0 + ml * kc + k);
  }

  // The row's table row (i < 0: a row that holds nothing), fetched a step
  // ahead.
  struct Pre {
    int i;
  };

  __device__ __forceinline__ void fetch(Pre& p, Scratch&, const Rows& rows,
                                        int g0, int pass, int t) const {
    p.i = -1;
    int ml, k;
    if (t < kTileRows && row_member(rows, t, pass, g0, ml, k)) {
      p.i = idx[(size_t)(g0 + ml) * rows.kc + k];
    }
  }

  // One thread a row: the gathered geometry, d2 into the scratch, the
  // canonical offset into row_data; the member's raw weights summed over
  // its K lanes (K divides 32: a member is one pass, inside one warp); every
  // row normalises its weight and a member's first row writes kth.
  __device__ __forceinline__ void prepare(RowData& rd, Scratch& sc,
                                          const Pre& p, const Rows& rows,
                                          int g0, int /*pass*/, int t,
                                          int bar) const {
    float wr = 0.f;
    if (t < kTileRows) {
      float d2 = 0.f, x0 = 0.f, x1 = 0.f, x2 = 0.f;
      if (p.i >= 0) {
        const float* qm = q + 3 * ((size_t)g0 + t / rows.kc);
        const float4* gp = reinterpret_cast<const float4*>(geo) + 3 * p.i;
        const float4 a = __ldg(gp), b = __ldg(gp + 1), c = __ldg(gp + 2);
        const float dx = __fsub_rn(__ldg(qm + 0), a.x);
        const float dy = __fsub_rn(__ldg(qm + 1), a.y);
        const float dz = __fsub_rn(__ldg(qm + 2), a.z);
        d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dz, dz)),
                       __fmul_rn(dy, dy));
        wr = __fdiv_rn(1.0f, __fadd_rn(d2, eps));
        // rotation rows (a.w b.x b.y), (b.z b.w c.x), (c.y c.z c.w)
        x0 = __fadd_rn(__fadd_rn(__fmul_rn(a.w, dx), __fmul_rn(b.x, dy)),
                       __fmul_rn(b.y, dz));
        x1 = __fadd_rn(__fadd_rn(__fmul_rn(b.z, dx), __fmul_rn(b.w, dy)),
                       __fmul_rn(c.x, dz));
        x2 = __fadd_rn(__fadd_rn(__fmul_rn(c.y, dx), __fmul_rn(c.z, dy)),
                       __fmul_rn(c.w, dz));
      }
      sc.tn[t] = d2;
      rd.x[3 * t + 0] = x0;
      rd.x[3 * t + 1] = x1;
      rd.x[3 * t + 2] = x2;
    }
    const int kc = rows.kc;
    const int k = t % kc;
    float sum = wr;                    // warps 0 and 1, whole
    if (t < kTileRows) {
      for (int off = 1; off < kc; off <<= 1) {
        sum = __fadd_rn(sum, __shfl_down_sync(0xffffffffu, sum, off));
      }
      sum = __shfl_sync(0xffffffffu, sum, (t & 31) - k);
    }
    named_barrier(bar, kGroupThreads);   // the member's d2 are in the scratch
    if (t < kTileRows) {
      float w = 0.f;
      if (p.i >= 0) {
        const int r0 = t - k;
        float kd = sc.tn[r0];
        for (int j = 1; j < kc; ++j) kd = fmaxf(kd, sc.tn[r0 + j]);
        w = __fdiv_rn(wr, sum);
        const size_t g = (size_t)g0 + r0 / kc;
        if (k == 0) kth[g] = kd;
        if (wout != nullptr) wout[g * kc + k] = w;
      }
      rd.wrow[t] = w;
    }
  }

  // The members past the live prefix (rows.n_members .. n_all): h 0, kth
  // +inf, w 0. Thread `i` of `stride`.
  __device__ __forceinline__ void clear_tail(const Rows& rows, int n_all,
                                             int F, int i, int stride) const {
    const size_t n_live = (size_t)rows.n_members;
    const size_t n4 = ((size_t)n_all - n_live) * F / 4;
    float4* h4 = reinterpret_cast<float4*>(out + n_live * F);
    for (size_t u = i; u < n4; u += stride) {
      h4[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (size_t m = n_live + i; m < (size_t)n_all; m += stride) {
      kth[m] = __int_as_float(0x7f800000);
    }
    if (wout == nullptr) return;
    for (size_t u = n_live * rows.kc + i; u < (size_t)n_all * rows.kc;
         u += stride) {
      wout[u] = 0.f;
    }
  }
};

}  // namespace

// rel [M*K, 3] f32, feat [M*K, F] bf16, w [M*K] f32, image: the weights as
// pack_weights lays them out for the chain (featmlp_chain.cuh), b1 [F] f32,
// bl [n_layers - 1, F] f32, out [M, F] f32. Needs K | 128, P_pad % 16 == 0,
// F in {32, 64, 128}.
extern "C" int featmlp_launch(const void* rel, const void* feat,
                              const void* w, const void* image,
                              const void* b1, const void* bl, int M, int K,
                              int F, int n_pe, int P_pad, int n_layers,
                              void* out, void* stream) {
  if (M <= 0) return 0;
  if (K <= 0 || kMaxMemberRows % K != 0 || P_pad % 16 != 0 ||
      P_pad < 3 * (1 + 2 * n_pe) || n_layers < 1) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  const RowFront front{static_cast<const float*>(rel),
                       static_cast<const float*>(w),
                       static_cast<const bf16*>(feat),
                       static_cast<float*>(out)};
  const Rows rows = make_rows(M, K);
  const auto* c1 = static_cast<const float*>(b1);
  const auto* cl = static_cast<const float*>(bl);
  switch (F) {
    case 32: return launch_chain<32>(front, rows, n_pe, P_pad, n_layers, image, c1, cl, s);
    case 64: return launch_chain<64>(front, rows, n_pe, P_pad, n_layers, image, c1, cl, s);
    case 128: return launch_chain<128>(front, rows, n_pe, P_pad, n_layers, image, c1, cl, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The chain's shared-memory plan for (F, P_pad, n_layers): resident layers
// and bytes; returns 0 when the shape is refused. The Python rule
// (kernels/featmlp.py:chain_plan) is held against this on the card.
extern "C" int featmlp_plan(int F, int P_pad, int n_layers, int* resident,
                            int* smem_bytes) {
  ChainPlan plan;
  if (!plan_chain(F, P_pad, n_layers, &plan)) return 0;
  *resident = plan.resident;
  *smem_bytes = plan.smem_bytes;
  return 1;
}

// K4's gathering front (above): q [n, 3] f32, idx [n, K] i32, geo [Pp, 12]
// f32, feat [Pp, F] bf16, the weight image as featmlp_launch takes it, b1
// [F] and bl [n_layers - 1, F] f32 (the layers' bf16 biases), pose [F] f32
// or null, live [1] i32 or null (the passing slots, first in the order),
// h [n, F] f32, kth [n] f32, w [n, K] f32 or null. Needs K | 32,
// P_pad % 16 == 0, F in {32, 64, 128}.
extern "C" int featmlp_gather_launch(const void* q, const void* idx,
                                     const void* geo, const void* feat,
                                     const void* image, const void* b1,
                                     const void* bl, const void* pose,
                                     const void* live, int n, int K,
                                     float eps, int F, int n_pe, int P_pad,
                                     int n_layers, void* h, void* kth,
                                     void* w, void* stream) {
  if (n <= 0) return 0;
  if (K <= 0 || 32 % K != 0 || P_pad % 16 != 0 ||
      P_pad < 3 * (1 + 2 * n_pe) || n_layers < 1) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  const GatherRowFront front{static_cast<const float*>(q),
                             static_cast<const int*>(idx),
                             static_cast<const float*>(geo),
                             static_cast<const bf16*>(feat),
                             static_cast<const float*>(pose),
                             static_cast<const int*>(live),
                             static_cast<float*>(h),
                             static_cast<float*>(kth),
                             static_cast<float*>(w),
                             eps};
  const Rows rows = make_rows(n, K);
  const auto* c1 = static_cast<const float*>(b1);
  const auto* cl = static_cast<const float*>(bl);
  switch (F) {
    case 32: return launch_chain<32>(front, rows, n_pe, P_pad, n_layers, image, c1, cl, s);
    case 64: return launch_chain<64>(front, rows, n_pe, P_pad, n_layers, image, c1, cl, s);
    case 128: return launch_chain<128>(front, rows, n_pe, P_pad, n_layers, image, c1, cl, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
