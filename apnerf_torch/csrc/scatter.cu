// K5: sorted window accumulation, out[v] = sum of upd[r] over rows r with
// idx[r] == v, for idx sorted ascending, in exact fp32 and in row order.
//
// Replaces apnerf/kernels/scatter_pallas.py:sorted_window_accumulate, the
// stage-1 grid gradient's scatter (apnerf/ops/grid.py _corner_gather_bwd):
// three calls a training step, M = 2^20 rows of C = 96 channels into the
// extended grids of about 162^3, 82^3 and 42^3 cells.
// Bound on the H100: memory. Each call reads M*C*4 bytes of updates
// (403 MB) and writes n_rows*C*4 bytes of output (1.6 GB at 162^3), every
// cell once, empty cells as zeros; there is no arithmetic to speak of.
// Design: the TPU kernel's one-hot MXU matmuls and their 3-way bf16 split
// are the TPU's way to sum exactly on its matrix unit; here the sum is a
// plain fp32 add. One block owns a window of kWin output cells; a first
// kernel finds each window's row range by binary search (the wrapper's
// searchsorted on the TPU). In the block, thread c owns channel c: it loads
// kRows rows of its channel into registers at a time (coalesced across the
// block, all loads in flight together) and walks them in row order, adding
// into one register and storing the cell's sum into a shared-memory tile
// when the row's cell changes. All threads walk the same index sequence, so
// they never diverge. No atomics: a cell's sum is ((0 + u_1) + u_2) + ...
// in row order, the order of a sequential index_add, so two runs give the
// same bits. Rows whose index lies outside [0, n_rows) are never walked:
// the grid gradient sends its all-zero rows there (the budget's unfilled
// samples, which share one position), so that they do not pile up in one
// window that a single block would walk row by row. The tile is written out
// once per window in either layout with coalesced stores ([n_rows, C], or
// [C, n_rows] when transposed).
#include <cuda_runtime.h>

namespace {

constexpr int kWin = 64;   // output cells per block
constexpr int kRows = 32;  // rows staged in registers per round

__device__ __forceinline__ int lower_bound(const int* __restrict__ idx,
                                           int M, long long key) {
  int lo = 0, hi = M;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((long long)idx[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// offs[w] = first row with idx >= min(w * kWin, n_rows), w in [0, n_win]:
// rows with idx < 0 or idx >= n_rows fall outside every window
__global__ void window_offsets_kernel(const int* __restrict__ idx, int M,
                                      int n_rows, int n_win,
                                      int* __restrict__ offs) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w <= n_win) {
    offs[w] = lower_bound(idx, M, min((long long)w * kWin, (long long)n_rows));
  }
}

template <bool Transposed>
__global__ void accumulate_kernel(const int* __restrict__ idx,
                                  const float* __restrict__ upd, int C,
                                  int n_rows, const int* __restrict__ offs,
                                  float* __restrict__ out) {
  extern __shared__ float tile[];  // [C][kWin + 1], padded: no bank clash
  __shared__ int s_idx[kRows];
  constexpr int kLd = kWin + 1;
  const int c = threadIdx.x;
  const bool live = c < C;
  const int base = blockIdx.x * kWin;
  const int lo = offs[blockIdx.x], hi = offs[blockIdx.x + 1];
  if (live) {
    for (int j = 0; j < kWin; ++j) tile[c * kLd + j] = 0.f;
  }
  float acc = 0.f;
  int cur = -1;  // cell (relative to base) whose sum acc holds
  for (int r0 = lo; r0 < hi; r0 += kRows) {
    const int n = min(kRows, hi - r0);
    __syncthreads();  // every thread is done with the previous s_idx
    if (threadIdx.x < n) s_idx[threadIdx.x] = idx[r0 + threadIdx.x] - base;
    float v[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      v[j] = (live && j < n) ? upd[(size_t)(r0 + j) * C + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (j < n) {
        const int cell = s_idx[j];
        if (cell != cur) {
          if (live && cur >= 0) tile[c * kLd + cur] = acc;
          acc = 0.f;
          cur = cell;
        }
        acc += v[j];
      }
    }
  }
  if (live && cur >= 0) tile[c * kLd + cur] = acc;
  __syncthreads();
  const int n_cells = min(kWin, n_rows - base);
  if (Transposed) {
    for (int e = threadIdx.x; e < C * kWin; e += blockDim.x) {
      const int ch = e / kWin, j = e - ch * kWin;
      if (j < n_cells) out[(size_t)ch * n_rows + base + j] = tile[ch * kLd + j];
    }
  } else {
    for (int e = threadIdx.x; e < C * kWin; e += blockDim.x) {
      const int j = e / C, ch = e - j * C;
      if (j < n_cells) out[(size_t)(base + j) * C + ch] = tile[ch * kLd + j];
    }
  }
}

}  // namespace

// idx [M] int32 ascending; rows with idx outside [0, n_rows) are dropped
// without being read. upd [M, C] fp32; offs [ceil(n_rows / 64) + 1] int32
// scratch; out [n_rows, C] fp32, or [C, n_rows] when transposed.
// 1 <= C <= 512.
extern "C" int scatter_launch(const int* idx, const float* upd, int M, int C,
                              int n_rows, int transposed, int* offs,
                              float* out, void* stream) {
  if (n_rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_win = (n_rows + kWin - 1) / kWin;
  window_offsets_kernel<<<(n_win + 1 + 255) / 256, 256, 0, s>>>(
      idx, M, n_rows, n_win, offs);
  const int threads = ((C + 31) / 32) * 32;
  const size_t smem = (size_t)C * (kWin + 1) * sizeof(float);
  if (transposed) {
    cudaFuncSetAttribute(accumulate_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    accumulate_kernel<true><<<n_win, threads, smem, s>>>(idx, upd, C, n_rows,
                                                         offs, out);
  } else {
    cudaFuncSetAttribute(accumulate_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    accumulate_kernel<false><<<n_win, threads, smem, s>>>(idx, upd, C, n_rows,
                                                          offs, out);
  }
  return (int)cudaGetLastError();
}
