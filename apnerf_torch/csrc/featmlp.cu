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
