// K6: fused subgroup-shared neighbour aggregation.
//
// Replaces apnerf/kernels/agg_pallas.py:fused_subgroup_agg (_kernel). Per
// subgroup of `share` member samples and `kc` shared candidate points:
//   to_nn[m,k] = |q[m] - nbr[k]|^2          (each op rounded, no FMA)
//   top        = the K smallest of the kc, ties by candidate position
//   kd2[m]     = max over top of to_nn      (floor -3.4e38)
//   w[m,k]     = top ? 1 / (to_nn + eps) : 0, over max(sum_k, 1e-30)
//   rc[m,k]    = rot[k] (q[m] - nbr[k])     (canonical-frame offset)
//   h[m]       = sum_k w[m,k] * feat_net(poc_fre(rc[m,k]) ++ feat[k])
// feat_net as in K4 (bf16 x bf16 -> fp32, fp32 bias, leaky-ReLU 0.01 after
// every layer, bf16 round between layers) except that the last layer's
// output stays fp32. The MLP runs on all kc candidates; the losers get
// weight 0. Invalid candidates arrive at the 2e9 sentinel position: they
// rank last, and their rows stay finite (sincosf reduces any finite
// argument), so 0 * row is 0.
// Bound on the H100: at the bench shape (4480 subgroups x 16 members x 8
// candidates = 573,440 MLP rows, F = 128) 84 GFLOP of bf16 tensor-core work
// (0.085 ms at the peak) against 49 MB of operands and results: the tensor
// cores bound it, as long as nothing but h and kd2 leaves the SM.
// Design: the persistent wgmma chain of featmlp_chain.cuh (shared with K4,
// featmlp.cu); K6 is its front end. With the flat member index g = s * share
// + m, a warpgroup's 64-row tile holds 64 / kc whole members (8 at kc = 8:
// half a subgroup; 5 at kc = 12, 4 rows idle), one row per (member,
// candidate); a member of more than 64 candidates takes two passes. A step
// ahead, under the current tile's products, the warpgroup stages the
// candidates of the tile's subgroups (position and rotation, 12 floats),
// each once, in shared memory with coalesced asynchronous copies; one
// thread per row forms to_nn and rc from there, ranks the row among its
// member's distances and normalises its weight, and a member's first row
// writes kd2. The feature half of a row's
// layer-1 operand is the candidate's feature row, loaded straight into the
// A fragments like K4's (the 8 or 16 members of a subgroup re-read it from
// L1 / L2). The fp32 result of the last layer is reduced over each member's
// candidates in registers (kc = 8) or through the chain's shared tile. The
// ragged last tile is bound-checked, nothing is padded.
#include "featmlp_chain.cuh"

using namespace featmlp;

namespace {

struct SubgroupFront {
  const float* __restrict__ q;
  const float* __restrict__ nbr;
  const float* __restrict__ rot;
  const bf16* __restrict__ feat;
  float* __restrict__ out;
  float* __restrict__ kd2;
  int share;
  int K;
  float eps;
  float inv_share;
  static constexpr bool kRoundLast = false;

  // The subgroup of the tile's member ml without a division per row: one
  // for the tile's first member, then a small quotient in floating point
  // (exact: the numerator stays under share + 64).
  struct Ctx {
    int sub0, rem0;
  };
  __device__ __forceinline__ Ctx ctx(const Rows&, int g0) const {
    const int sub0 = g0 / share;
    return Ctx{sub0, g0 - sub0 * share};
  }
  __device__ __forceinline__ long long feat_row(const Ctx& c, int ml, int k,
                                                int kc) const {
    const int n = c.rem0 + ml;
    const int sub = c.sub0 + (share <= 1024
                                  ? __float2int_rz(((float)n + 0.5f) * inv_share)
                                  : n / share);
    return (long long)sub * kc + k;
  }

  // Slot s of the tile: the rows of pass 0, or (two passes) candidate s of
  // the tile's one member.
  __device__ __forceinline__ bool slot_member(const Rows& rows, int s, int g0,
                                              int& ml, int& k) const {
    if (rows.n_pass == 1) return row_member(rows, s, 0, g0, ml, k);
    ml = 0;
    k = s;
    return s < rows.kc;
  }

  // Where the staged candidates of a step lie in the scratch: positions
  // (3 floats a candidate) then rotations (9 floats), of the subgroups the
  // tile's members belong to, in order: at most 128 candidates (mpt * kc <=
  // 64 in one pass, kc <= 128 with one member in two).
  static constexpr int kRotOffset = 3 * kMaxMemberRows;

  // A step's inputs: the member position of the thread's row in registers;
  // the candidates of the tile's subgroups, each once, by 4-byte cp.async
  // with consecutive threads on consecutive floats (both arrays are
  // contiguous over consecutive subgroups).
  struct Pre {
    float q[3];
  };

  __device__ __forceinline__ void fetch(Pre& p, Scratch& sc, const Rows& rows,
                                        int g0, int pass, int t) const {
    if (pass > 0) return;
    const int sub0 = g0 / share;
    const int g_last = min(g0 + rows.mpt, rows.n_members) - 1;
    const int n_cand = (g_last / share - sub0 + 1) * rows.kc;
    const float* nbr0 = nbr + (size_t)sub0 * rows.kc * 3;
    const float* rot0 = rot + (size_t)sub0 * rows.kc * 9;
    for (int i = t; i < n_cand * 12; i += kGroupThreads) {
      const int j = i - n_cand * 3;
      if (j < 0) {
        cp_async4(smem_u32(sc.cand + i), nbr0 + i);
      } else {
        cp_async4(smem_u32(sc.cand + kRotOffset + j), rot0 + j);
      }
    }
    cp_async_commit();
    const int n_slots = rows.n_pass == 1 ? kTileRows : kMaxMemberRows;
    int ml, k;
    p.q[0] = p.q[1] = p.q[2] = 0.f;
    if (t < n_slots && slot_member(rows, t, g0, ml, k)) {
      const size_t g = (size_t)(g0 + ml);
      p.q[0] = q[g * 3 + 0];
      p.q[1] = q[g * 3 + 1];
      p.q[2] = q[g * 3 + 2];
    }
  }

  __device__ __forceinline__ void prepare(RowData& rd, Scratch& sc,
                                          const Pre& p, const Rows& rows,
                                          int g0, int pass, int t,
                                          int bar) const {
    if (pass > 0) return;      // pass 0 filled every slot of the member
    const int kc = rows.kc;
    const int n_slots = rows.n_pass == 1 ? kTileRows : kMaxMemberRows;

    cp_async_wait_all();       // the candidates, started by fetch
    named_barrier(bar, kGroupThreads);

    // ---- distances and canonical-frame offsets, one thread per slot
    int ml = 0, k = 0;
    const bool live = t < n_slots && slot_member(rows, t, g0, ml, k);
    float tn = 0.f;
    if (t < n_slots) {
      float x0 = 0.f, x1 = 0.f, x2 = 0.f;
      if (live) {
        const Ctx c = ctx(rows, g0);
        const int lc = (int)(feat_row(c, ml, k, kc) - (long long)c.sub0 * kc);
        const float* cn = sc.cand + 3 * lc;
        const float* cr = sc.cand + kRotOffset + 9 * lc;
        const float dx = p.q[0] - cn[0];
        const float dy = p.q[1] - cn[1];
        const float dz = p.q[2] - cn[2];
        tn = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                       __fmul_rn(dz, dz));
        x0 = cr[0] * dx + cr[1] * dy + cr[2] * dz;
        x1 = cr[3] * dx + cr[4] * dy + cr[5] * dz;
        x2 = cr[6] * dx + cr[7] * dy + cr[8] * dz;
      }
      sc.tn[t] = tn;
      rd.x[3 * t + 0] = x0;
      rd.x[3 * t + 1] = x1;
      rd.x[3 * t + 2] = x2;
    }
    named_barrier(bar, kGroupThreads);

    // ---- rank among the member's kc candidates; raw inverse-distance weight
    const float* tm = sc.tn + ml * kc;
    float wr = 0.f;
    if (t < n_slots) {
      unsigned char is_top = 0;
      if (live) {
        int rank = 0;
        for (int j = 0; j < kc; ++j) {
          const float tj = tm[j];
          rank += (tn > tj) || (tn == tj && k > j);
        }
        is_top = rank < K;
        if (is_top) wr = 1.0f / (tn + eps);
      }
      sc.wraw[t] = wr;
      sc.top[t] = is_top;
    }
    named_barrier(bar, kGroupThreads);

    // ---- every row normalises its own weight over its member's raw
    // weights (summed in candidate order); the member's first row writes
    // the kth distance
    if (t < n_slots) {
      float w = 0.f;
      if (live) {
        float sum = 0.f;
        for (int j = 0; j < kc; ++j) sum += sc.wraw[ml * kc + j];
        w = wr / fmaxf(sum, 1e-30f);
        if (k == 0) {
          float kth = -3.4e38f;
          for (int j = 0; j < kc; ++j) {
            if (sc.top[ml * kc + j]) kth = fmaxf(kth, tm[j]);
          }
          kd2[g0 + ml] = kth;
        }
      }
      rd.wrow[t] = w;
    }
  }
};

}  // namespace

// q [S*share, 3] f32, nbr [S*kc, 3] f32 (invalid slots at the sentinel),
// rot [S*kc, 9] f32 row-major, feat [S*kc, F] bf16, the weights as
// featmlp_launch takes them, h [S*share, F] f32, kd2 [S*share] f32.
// Needs 1 <= K <= kc <= 128, P_pad % 16 == 0, F in {32, 64, 128}.
extern "C" int agg_launch(const void* q, const void* nbr, const void* rot,
                          const void* feat, const void* image, const void* b1,
                          const void* bl, int S, int share, int kc, int K,
                          float eps, int F, int n_pe, int P_pad, int n_layers,
                          void* h, void* kd2, void* stream) {
  if (S <= 0) return 0;
  if (share < 1 || K < 1 || kc < K || kc > kMaxMemberRows ||
      P_pad % 16 != 0 || P_pad < 3 * (1 + 2 * n_pe) || n_layers < 1) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  const SubgroupFront front{static_cast<const float*>(q),
                            static_cast<const float*>(nbr),
                            static_cast<const float*>(rot),
                            static_cast<const bf16*>(feat),
                            static_cast<float*>(h),
                            static_cast<float*>(kd2),
                            share,
                            K,
                            eps,
                            1.0f / (float)share};
  const Rows rows = make_rows(S * share, kc);
  const auto* c1 = static_cast<const float*>(b1);
  const auto* cl = static_cast<const float*>(bl);
  switch (F) {
    case 32: return launch_chain<32>(front, rows, n_pe, P_pad, n_layers, image, c1, cl, s);
    case 64: return launch_chain<64>(front, rows, n_pe, P_pad, n_layers, image, c1, cl, s);
    case 128: return launch_chain<128>(front, rows, n_pe, P_pad, n_layers, image, c1, cl, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
