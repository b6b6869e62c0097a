// G1: the stage-1 multi-scale trilinear sample of the TiNeuVox feature grid
// (strides 1, 2 and 4) and its gradient.
//
// Replaces no TPU kernel: the JAX package leaves the sample to XLA's gathers
// (apnerf/ops/grid.py:298 mult_dist_interp, per scale _interp_at_indices
// with the _corner_gather custom VJP), and the port's plain version is the
// same per-scale path in PyTorch (apnerf_torch/ops/grid.py
// mult_dist_interp_plain): the grid padded to 4k + 1 cells and copied, the
// stride-2 and stride-4 views copied, [M, 8] index and weight tables, an
// [M, 8, C] corner gather kept for the backward, a cat of the scales; in
// the backward an [M, 8C] update written and gathered again in sorted
// order for K5, eight shifted slices added, and the pad's and the strided
// views' backward through zero-filled grids. At the stage-1 step's M = 2^20
// samples on a 160^3 x 12 grid that moves well over 10 GB a step.
//
// Bound on the H100: memory. The forward reads each sample's 12 B of
// coordinates and the grid (8 corners x 48 B x 3 scales a sample, mostly
// from L2: neighbouring samples of a ray share corners) and writes 3C
// floats a sample; the backward writes the rows K5 reads and the gradient
// once. What the design does about it:
//  * the padding and the strides are index arithmetic: scale index i reads
//    the padded cell s*i, which is 0 where s*i >= n; nothing is copied;
//  * the forward saves nothing of size [M, 8, C]: the backward recomputes
//    the corners from the grid and the coordinates;
//  * the backward writes K5's rows directly in sorted order (row j of
//    scale s is w_k(order[j]) * g(order[j]), the same single products),
//    for the three scales in one launch, and skips the rows keyed out;
//  * one kernel folds the 8 shifted corner blocks of K5's three outputs
//    and the three scales and writes the gradient once, in the grid's
//    [X, Y, Z, C] layout, through a shared-memory tile.
//
// Bits. The forward and the grid gradient are bit-equal to the plain path
// on the card: every operation is rounded as PyTorch rounds it, with no
// FMA contraction (__fmul_rn / __fadd_rn):
//  * u = unit * last, frac = u - floor(u), 1 - frac, the weight
//    ((wx * wy) * wz) * ok, each product vals_k * w_k;
//  * the sum over the 8 corners in the order of PyTorch's CUDA reduce over
//    the corner axis of [M, 8, C] (four accumulators, each from 0, corner i
//    then i + 4, combined in order): (((0 + p0) + p4) + ((0 + p1) + p5))
//    + ((0 + p2) + p6)) + ((0 + p3) + p7), found bit-equal on the card;
//  * the keys (the extended base cell, n_cells for a row whose cotangent
//    is all zero) and their stable order as ops/grid.py _grid_grad's;
//  * the fold as the plain path's 8 slice adds, (((0 + a0) + a1) ... + a7),
//    and the scales as autograd adds them into the padded grid's
//    gradient: stride 4's first, then stride 2's, then the fine one's.
// d/dunit is formed in float64 from the float32 corner values, weights and
// cotangent and rounded once; it differs from autograd's float32
// accumulation by rounding only.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;   // grid cells a block of the fold writes
constexpr int kScales = 3;   // strides 1, 2, 4

struct Geometry {  // the unpadded grid [n0, n1, n2, C]
  int n[3];
  int C;
};

// One scale of the 4k+1-padded grid, strided: its size, the extended grid
// of base cells (size + 1 a side) and where its keys start in the joint
// sort of the three scales (kernels/trilerp.py geometry is the same).
struct Scale {
  int stride;
  int dim[3];
  int ext[3];
  int n_cells;
  int key_off;
  float last[3];
};

// Shifts only (the strides are powers of two): every thread of the row
// kernel forms its scale, and an integer division costs ~20 instructions.
__host__ __device__ __forceinline__ Scale scale_of(const Geometry& g,
                                                   int si) {
  Scale s;
  int off = 0;
#pragma unroll
  for (int i = 0; i < kScales; ++i) {
    int dim[3], n_cells = 1;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      // the padded size ceil((n-1)/4)*4 + 1, strided
      dim[a] = ((((g.n[a] + 2) >> 2) << 2) >> i) + 1;
      n_cells *= dim[a] + 1;
    }
    if (i == si) {
      s.stride = 1 << i;
      s.n_cells = n_cells;
      s.key_off = off;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        s.dim[a] = dim[a];
        s.ext[a] = dim[a] + 1;
        s.last[a] = static_cast<float>(dim[a] - 1);
      }
    }
    off += n_cells + 1;
  }
  return s;
}

// A sample's cell at one scale: frac and floor(u), the floor clamped to
// [-2, dim] (same masks and clamps below, and no int overflow).
struct Cell {
  float frac[3];
  int i0[3];
};

__device__ __forceinline__ Cell locate(const Scale& s,
                                       const float* __restrict__ unit3) {
  Cell c;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float u = __fmul_rn(__ldg(unit3 + a), s.last[a]);
    const float f = floorf(u);
    c.frac[a] = __fsub_rn(u, f);
    c.i0[a] = static_cast<int>(fminf(fmaxf(f, -2.f),
                                     static_cast<float>(s.dim[a])));
  }
  return c;
}

// corner k = dx*4 + dy*2 + dz: its per-axis weights and whether it lies in
// the strided grid
__device__ __forceinline__ bool corner_axes(const Scale& s, const Cell& c,
                                            int k, float (&w)[3]) {
  bool ok = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int d = (k >> (2 - a)) & 1;
    w[a] = d ? c.frac[a] : __fsub_rn(1.f, c.frac[a]);
    const int i = c.i0[a] + d;
    ok = ok && i >= 0 && i < s.dim[a];
  }
  return ok;
}

__device__ __forceinline__ float corner_weight(const Scale& s, const Cell& c,
                                               int k) {
  float w[3];
  const bool ok = corner_axes(s, c, k, w);
  return __fmul_rn(__fmul_rn(__fmul_rn(w[0], w[1]), w[2]), ok ? 1.f : 0.f);
}

// element offset of corner k's channel 0 in the unpadded grid (its index
// clamped into the strided grid, as the plain gather's), -1 where the
// padded grid holds 0
__device__ __forceinline__ long long corner_offset(const Geometry& g,
                                                   const Scale& s,
                                                   const Cell& c, int k) {
  long long off = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int d = (k >> (2 - a)) & 1;
    const int i = min(max(c.i0[a] + d, 0), s.dim[a] - 1) * s.stride;
    if (i >= g.n[a]) return -1;
    off = off * g.n[a] + i;
  }
  return off * g.C;
}

// the extended grid's base cell (i0 + 1, clamped), the plain lin_ext
__device__ __forceinline__ int base_cell(const Scale& s, const Cell& c) {
  int b = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a)
    b = b * s.ext[a] + min(max(c.i0[a] + 1, 0), s.dim[a]);
  return b;
}

template <int V>
__device__ __forceinline__ void load(const float* __restrict__ p,
                                     float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) x[i] = __ldg(p + i);
  }
}

template <int V>
__device__ __forceinline__ void store(float* __restrict__ p,
                                      const float (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = x[i];
  }
}

// Forward: thread t samples row t / 3 at scale t % 3, so that a warp's
// stores of the [M, 3C] output are consecutive; V channels at a time.
template <int V>
__global__ void __launch_bounds__(kThreads)
    trilerp_kernel(const float* __restrict__ grid,
                   const float* __restrict__ unit, int M, Geometry g,
                   float* __restrict__ out) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= 3u * static_cast<unsigned>(M)) return;
  const unsigned m = t / 3u;
  const int si = static_cast<int>(t - 3u * m);
  const Scale s = scale_of(g, si);
  const Cell cell = locate(s, unit + 3ll * m);
  float w[8];
  long long off[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    w[k] = corner_weight(s, cell, k);
    off[k] = corner_offset(g, s, cell, k);
  }
  float* o = out + (3ll * m + si) * g.C;
  for (int c = 0; c < g.C; c += V) {
    float v[8][V];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (off[k] >= 0) {
        load<V>(grid + off[k] + c, v[k]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) v[k][i] = 0.f;
      }
    }
    float r[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float a[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        a[q] = __fadd_rn(__fadd_rn(0.f, __fmul_rn(v[q][i], w[q])),
                         __fmul_rn(v[q + 4][i], w[q + 4]));
      r[i] = __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), a[2]), a[3]);
    }
    store<V>(o + c, r);
  }
}

// Backward, one thread a sample: d/dunit summed over the scales, and each
// scale's key for K5 (the base cell, or n_cells where the scale's
// cotangent row is all zero), offset into the joint sort.
template <int V>
__global__ void __launch_bounds__(kThreads)
    trilerp_grad_kernel(const float* __restrict__ grid,
                        const float* __restrict__ unit,
                        const float* __restrict__ gout, int M, Geometry g,
                        float* __restrict__ dunit, int* __restrict__ keys) {
  const int m = blockIdx.x * kThreads + threadIdx.x;
  if (m >= M) return;
  double du[3] = {0.0, 0.0, 0.0};
  for (int si = 0; si < kScales; ++si) {
    const Scale s = scale_of(g, si);
    const Cell cell = locate(s, unit + 3ll * m);
    long long off[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) off[k] = corner_offset(g, s, cell, k);
    const float* gs = gout + (3ll * m + si) * g.C;
    double dw[8] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
    bool live = false;
    for (int c = 0; c < g.C; c += V) {
      float gv[V];
      load<V>(gs + c, gv);
#pragma unroll
      for (int i = 0; i < V; ++i) live = live || gv[i] != 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (off[k] < 0) continue;
        float v[V];
        load<V>(grid + off[k] + c, v);
#pragma unroll
        for (int i = 0; i < V; ++i)
          dw[k] = fma(static_cast<double>(v[i]), static_cast<double>(gv[i]),
                      dw[k]);
      }
    }
    // w = wx wy wz ok: d w / d frac_a = +-(the other two) where ok
    double df[3] = {0.0, 0.0, 0.0};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float w[3];
      if (!corner_axes(s, cell, k, w)) continue;
      const double wx = w[0], wy = w[1], wz = w[2];
      df[0] += (k & 4 ? dw[k] : -dw[k]) * (wy * wz);
      df[1] += (k & 2 ? dw[k] : -dw[k]) * (wx * wz);
      df[2] += (k & 1 ? dw[k] : -dw[k]) * (wx * wy);
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) du[a] += df[a] * static_cast<double>(s.last[a]);
    keys[static_cast<long long>(si) * M + m] =
        s.key_off + (live ? base_cell(s, cell) : s.n_cells);
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) dunit[3ll * m + a] = static_cast<float>(du[a]);
}

// K5's rows in sorted order, the three scales one after the other: thread
// t writes V channels of corner k of row j = t / (8 CG / V), so that a
// warp's stores are consecutive, from channels [c0, c0 + CG) of the sample
// order[j] - s M at scale s = j / M, and row j's local key; rows keyed out
// (key n_cells) are never read by K5 and are not written.
template <int V>
__global__ void __launch_bounds__(kThreads)
    trilerp_rows_kernel(const float* __restrict__ unit,
                        const float* __restrict__ gout,
                        const long long* __restrict__ order,
                        const int* __restrict__ keys_sorted, int M,
                        Geometry g, int c0, int CG, int* __restrict__ idx,
                        float* __restrict__ upd) {
  const unsigned per_corner = static_cast<unsigned>(CG / V);
  const unsigned per_row = 8u * per_corner;
  const unsigned rows = static_cast<unsigned>(M);
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= 3u * rows * per_row) return;
  const unsigned j = t / per_row;
  const unsigned r = t - j * per_row;
  const int si = (j >= rows) + (j >= 2u * rows);
  const Scale s = scale_of(g, si);
  const int local = __ldg(keys_sorted + j) - s.key_off;
  if (r == 0) idx[j] = local;
  if (local >= s.n_cells) return;
  const int k = static_cast<int>(r / per_corner);
  const int c = static_cast<int>(r - k * per_corner) * V;
  const long long m = __ldg(order + j) - static_cast<long long>(si) * M;
  const Cell cell = locate(s, unit + 3ll * m);
  const float w = corner_weight(s, cell, k);
  float x[V];
  load<V>(gout + (3ll * m + si) * g.C + c0 + c, x);
#pragma unroll
  for (int i = 0; i < V; ++i) x[i] = __fmul_rn(x[i], w);
  store<V>(upd + static_cast<long long>(j) * 8 * CG + k * CG + c, x);
}

// the plain fold of one extended cell j: (((0 + a0) + a1) ... + a7), a_k
// read at j + off_k, off_k = ((1-dx) ext1 + (1-dy)) ext2 + (1-dz)
__device__ __forceinline__ float corner_sum(const float* __restrict__ acc,
                                            const Scale& s, int CG, int c,
                                            long long j) {
  float r = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
    const int off = ((1 - dx) * s.ext[1] + (1 - dy)) * s.ext[2] + (1 - dz);
    r = __fadd_rn(r, __ldg(acc + static_cast<long long>(k * CG + c) *
                                     s.n_cells + j + off));
  }
  return r;
}

// The gradient of channels [c0, c0 + CG) from K5's three outputs acc_s
// [8 CG, n_cells_s] (transposed layout): each thread folds one grid cell's
// CG channels into a shared-memory tile, then the block writes the tile's
// kTile cells with coalesced stores. A cell on the stride-2 lattice adds
// stride 2's fold (stride 4's first, on its lattice) before the fine one's.
__global__ void __launch_bounds__(kTile)
    trilerp_fold_kernel(const float* __restrict__ acc1,
                        const float* __restrict__ acc2,
                        const float* __restrict__ acc4, Geometry g, int c0,
                        int CG, float* __restrict__ dgrid) {
  extern __shared__ float tile[];
  const int ld = CG + 1;
  // the wrapper holds the grid's elements under 2^31
  const unsigned n_grid = static_cast<unsigned>(g.n[0] * g.n[1] * g.n[2]);
  const unsigned first = blockIdx.x * kTile;
  const unsigned p = first + threadIdx.x;
  if (p < n_grid) {
    const unsigned xy = p / g.n[2];
    const int z = static_cast<int>(p - xy * g.n[2]);
    const int x = static_cast<int>(xy / g.n[1]);
    const int y = static_cast<int>(xy - x * g.n[1]);
    const Scale s1 = scale_of(g, 0), s2 = scale_of(g, 1), s4 = scale_of(g, 2);
    const bool on2 = ((x | y | z) & 1) == 0;
    const bool on4 = ((x | y | z) & 3) == 0;
    const long long j1 =
        (static_cast<long long>(x) * s1.ext[1] + y) * s1.ext[2] + z;
    const long long j2 =
        (static_cast<long long>(x >> 1) * s2.ext[1] + (y >> 1)) * s2.ext[2] +
        (z >> 1);
    const long long j4 =
        (static_cast<long long>(x >> 2) * s4.ext[1] + (y >> 2)) * s4.ext[2] +
        (z >> 2);
    for (int c = 0; c < CG; ++c) {
      float v = corner_sum(acc1, s1, CG, c, j1);
      if (on2) {
        float coarse = corner_sum(acc2, s2, CG, c, j2);
        if (on4) coarse = __fadd_rn(corner_sum(acc4, s4, CG, c, j4), coarse);
        v = __fadd_rn(coarse, v);
      }
      tile[threadIdx.x * ld + c] = v;
    }
  }
  __syncthreads();
  const int n_here = static_cast<int>(min(n_grid - first, kTile + 0u));
  for (int q = threadIdx.x; q < n_here * CG; q += kTile) {
    const int cell = q / CG, c = q - cell * CG;
    dgrid[static_cast<long long>(first + cell) * g.C + c0 + c] =
        tile[cell * ld + c];
  }
}

Geometry geometry(int n0, int n1, int n2, int C) {
  Geometry g;
  g.n[0] = n0;
  g.n[1] = n1;
  g.n[2] = n2;
  g.C = C;
  return g;
}

unsigned blocks(long long threads, int per_block) {
  return static_cast<unsigned>((threads + per_block - 1) / per_block);
}

}  // namespace

// grid [n0, n1, n2, C] fp32, unit [M, 3] fp32 (bbox-normalised points)
// -> out [M, 3C] fp32, [fine | stride 2 | stride 4]. vec4: C % 4 == 0 and
// grid, out 16-byte aligned.
extern "C" int trilerp_launch(const float* grid, const float* unit, int M,
                              int n0, int n1, int n2, int C, int vec4,
                              float* out, void* stream) {
  if (M <= 0) return 0;
  const Geometry g = geometry(n0, n1, n2, C);
  const unsigned nb = blocks(3ll * M, kThreads);
  auto st = static_cast<cudaStream_t>(stream);
  if (vec4)
    trilerp_kernel<4><<<nb, kThreads, 0, st>>>(grid, unit, M, g, out);
  else
    trilerp_kernel<1><<<nb, kThreads, 0, st>>>(grid, unit, M, g, out);
  return static_cast<int>(cudaGetLastError());
}

// grid, unit as above, gout = dL/dout [M, 3C] -> dunit [M, 3] fp32 and
// keys [3, M] int32 (scale s's keys offset by its key_off)
extern "C" int trilerp_grad_launch(const float* grid, const float* unit,
                                   const float* gout, int M, int n0, int n1,
                                   int n2, int C, int vec4, float* dunit,
                                   int* keys, void* stream) {
  if (M <= 0) return 0;
  const Geometry g = geometry(n0, n1, n2, C);
  const unsigned nb = blocks(M, kThreads);
  auto st = static_cast<cudaStream_t>(stream);
  if (vec4)
    trilerp_grad_kernel<4><<<nb, kThreads, 0, st>>>(grid, unit, gout, M, g,
                                                    dunit, keys);
  else
    trilerp_grad_kernel<1><<<nb, kThreads, 0, st>>>(grid, unit, gout, M, g,
                                                    dunit, keys);
  return static_cast<int>(cudaGetLastError());
}

// keys sorted stably (keys_sorted [3M] int32, order [3M] int64) -> idx
// [3M] int32 (each scale's local keys) and upd [3M, 8 CG] fp32 (channels
// [c0, c0 + CG), corner-major). vec4: CG % 4 == 0, c0 % 4 == 0, C % 4 == 0.
extern "C" int trilerp_rows_launch(const float* unit, const float* gout,
                                   const long long* order,
                                   const int* keys_sorted, int M, int n0,
                                   int n1, int n2, int C, int c0, int CG,
                                   int vec4, int* idx, float* upd,
                                   void* stream) {
  if (M <= 0) return 0;
  const Geometry g = geometry(n0, n1, n2, C);
  auto st = static_cast<cudaStream_t>(stream);
  const int V = vec4 ? 4 : 1;
  const unsigned nb = blocks(24ll * M * (CG / V), kThreads);
  if (vec4)
    trilerp_rows_kernel<4><<<nb, kThreads, 0, st>>>(
        unit, gout, order, keys_sorted, M, g, c0, CG, idx, upd);
  else
    trilerp_rows_kernel<1><<<nb, kThreads, 0, st>>>(
        unit, gout, order, keys_sorted, M, g, c0, CG, idx, upd);
  return static_cast<int>(cudaGetLastError());
}

// K5's outputs acc_s [8 CG, n_cells_s] for strides 1, 2, 4 -> channels
// [c0, c0 + CG) of dgrid [n0, n1, n2, C]. CG <= 64.
extern "C" int trilerp_fold_launch(const float* acc1, const float* acc2,
                                   const float* acc4, int n0, int n1, int n2,
                                   int C, int c0, int CG, float* dgrid,
                                   void* stream) {
  const Geometry g = geometry(n0, n1, n2, C);
  const long long n_grid = static_cast<long long>(n0) * n1 * n2;
  if (n_grid <= 0) return 0;
  const size_t smem = sizeof(float) * kTile * (CG + 1);
  trilerp_fold_kernel<<<blocks(n_grid, kTile), kTile, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      acc1, acc2, acc4, g, c0, CG, dgrid);
  return static_cast<int>(cudaGetLastError());
}
