// K5: sorted window accumulation, out[v] = sum of upd[r] over rows r with
// idx[r] == v, for idx sorted ascending, in exact fp32 and in a sum order
// that the data alone fixes.
//
// Replaces apnerf/kernels/scatter_pallas.py:sorted_window_accumulate, the
// stage-1 grid gradient's scatter (apnerf/ops/grid.py _corner_gather_bwd):
// three calls a training step, M = 2^20 rows of C = 96 channels into the
// extended grids of about 162^3, 82^3 and 42^3 cells.
// Bound on the H100: memory. Each call reads M*C*4 bytes of updates
// (403 MB) and writes n_rows*C*4 bytes of output (1.6 GB at 162^3), every
// cell once, empty cells as zeros; there is no arithmetic to speak of. What
// keeps a kernel from that bound is balance: the rows of a training step
// crowd a few cells (a 42^3 grid under a blob of samples holds tens of
// thousands of rows in one window of 64 cells), and a block that walks such
// a window alone sets the kernel's time while 131 SMs wait.
// Design: work is cut by rows, not by cells.
//   * A window of kWin cells with at most kItemRows rows is one block's
//     work, as it always was: the block sums the window into a
//     shared-memory tile and writes the tile out with coalesced stores in
//     either layout ([n_rows, C], or [C, n_rows] when transposed).
//   * A window with more rows is cut, at cell boundaries, into runs of whole
//     cells that hold about kItemRows rows each (a new run starts where a
//     cell's first row, counted from the window's first row, enters another
//     multiple of kItemRows); every run is a block's work item of its own.
//     A cell's sum is still ((0 + u_1) + u_2) + ... in row order, the order
//     of a sequential index_add, so the result keeps its bits and nothing
//     has to be combined.
//   * A cell with more than kHotRows rows is cut into chunks of kHotRows
//     rows counted from the cell's first row. Each chunk is an item that
//     sums its rows in order into a partial row; combine_kernel then adds a
//     cell's partial rows in ascending chunk order. That order depends on
//     the data only, not on the grid or the number of SMs, and the plain
//     version (kernels/scatter.py) takes the same one.
//   The items come from two small kernels over the windows' row offsets
//   (binary searches), one warp per candidate window: a count pass, which
//   also scans the counts within its block (and whose further blocks find
//   every window's first row), and a write pass, which adds the earlier
//   blocks' totals. Every window with more than kItemRows rows
//   holds a row whose number is a multiple of kItemRows, so only
//   ceil(M / kItemRows) candidates are looked at, whatever the grid's
//   size. Nothing is read back to the host; the accumulation is launched
//   at the item list's static upper bound and blocks beyond the count
//   leave at once. Items are launched ahead of the plain windows, so the
//   long blocks start first.
//   * In a block, thread c owns channel c: it loads kRows rows of its
//   channel into registers at a time (coalesced across the block, all loads
//   in flight together), the next kRows rows while it walks these, and
//   walks them in row order, adding into one register and storing the
//   cell's sum into its row of the tile when the row's cell changes. Each warp reads the rows' cells itself and hands
//   them round by shuffle, so the walk has no barrier; all threads walk the
//   same cell sequence and never diverge.
// No atomics anywhere: two runs give the same bits. Rows whose index lies
// outside [0, n_rows) are never read.
#include <cuda_runtime.h>

namespace {

constexpr int kWin = 64;         // output cells per window
constexpr int kRows = 32;        // rows staged in registers per round
constexpr int kItemRows = 1024;  // rows a work item holds, about
constexpr int kHotRows = 4096;   // a cell with more rows is summed in chunks
constexpr int kPlanWarps = 8;    // warps per block of the plan kernels
// the item list's bound (scatter_launch's scratch) needs this
static_assert(kHotRows >= 3 * kItemRows, "kHotRows >= 3 * kItemRows");
static_assert(kRows == 32, "one lane per staged row");
static_assert(kPlanWarps <= 32, "one lane per warp of a plan block");

// first row in [lo, hi) with idx >= key
__device__ __forceinline__ int lower_bound(const int* __restrict__ idx,
                                           int lo, int hi, long long key) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if ((long long)idx[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// the first row of window w: the first with idx >= min(w * kWin, n_rows).
// Rows with idx < 0 or idx >= n_rows fall outside every window.
__device__ __forceinline__ int window_start(const int* __restrict__ idx,
                                            int M, int n_rows, int w) {
  return lower_bound(idx, 0, M, min((long long)w * kWin, (long long)n_rows));
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

// exclusive prefix of v over the warp's lanes; total in *sum
__device__ __forceinline__ int warp_exclusive(int v, int lane, int* sum) {
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += up;
  }
  *sum = __shfl_sync(0xffffffffu, inc, 31);
  return inc - v;
}

// The items of the windows that hold more than kItemRows rows. One warp per
// candidate k: the window of row k * kItemRows, if that row is the first
// candidate row of its window. Write == false: cnt[k] = (items, partial
// rows) of the candidates before k in k's block, blk[b] = those of block
// b; the blocks from plan_blocks on write the windows' first rows, offs[w],
// w in [0, n_win], one thread a window. Write == true (offs is there): the window's items go to items[o ...], o = the blocks'
// totals before k's block + cnt[k].x, its hot cells' chunks take the
// partial rows from p (the same in .y) and tell combine_kernel of them in
// pinfo; the last candidate leaves the totals in *total.
//   item (cell_lo, n_cells, row_lo, row_hi): a run of whole cells;
//   item (cell, -1 - p, row_lo, row_hi): chunk of a hot cell, into
//   partial row p; pinfo[p] = (cell, chunks of the cell at its first
//   chunk, else 0).
template <bool Write>
__global__ void __launch_bounds__(32 * kPlanWarps) plan_kernel(
    const int* __restrict__ idx, int M, int n_rows,
    int* __restrict__ offs, int n_win, int n_cand, int plan_blocks,
    int2* __restrict__ cnt, int2* __restrict__ blk, int2* __restrict__ total,
    int4* __restrict__ items, int2* __restrict__ pinfo) {
  __shared__ int s_start[kPlanWarps][kWin + 1];
  __shared__ int2 s_cnt[kPlanWarps];
  if (!Write && (int)blockIdx.x >= plan_blocks) {
    const int w = (blockIdx.x - plan_blocks) * blockDim.x + threadIdx.x;
    if (w <= n_win) offs[w] = window_start(idx, M, n_rows, w);
    return;
  }
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const int k = blockIdx.x * kPlanWarps + wi;
  int lo = 0, hi = 0, w = -1;
  bool mine = k < n_cand;
  if (mine) {
    const int v = idx[(size_t)k * kItemRows];
    mine = v >= 0 && v < n_rows;
    w = v / kWin;
  }
  if (mine && k > 0) {
    const int u = idx[(size_t)(k - 1) * kItemRows];
    mine = !(u >= 0 && u / kWin == w);  // an earlier candidate has it
  }
  if (mine) {
    if (Write) {
      lo = offs[w];
      hi = offs[w + 1];
    } else {  // offs is being written by this launch
      const int edge = lane < 2 ? window_start(idx, M, n_rows, w + lane) : 0;
      lo = __shfl_sync(0xffffffffu, edge, 0);
      hi = __shfl_sync(0xffffffffu, edge, 1);
    }
    mine = hi - lo > kItemRows;
  }
  // mine is the same in every lane of the warp
  const int base = w * kWin;
  const int n_cells = mine ? min(kWin, n_rows - base) : 0;
  int* start = s_start[wi];  // start[j]: first row of cell base + j
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
    start[j] = j < n_cells ? lower_bound(idx, lo, hi, (long long)base + j)
                           : hi;
  }
  if (lane == 0) start[kWin] = hi;
  __syncwarp();
  int n_it[2], n_pt[2];
  unsigned bound[2];  // cells that begin a run or are hot, by half
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
    const int s = start[j], n = start[j + 1] - s;
    const bool hot = n > kHotRows;
    bool begins = !hot && j < n_cells;
    if (begins && j > 0) {
      const int ps = start[j - 1];
      begins = s - ps > kHotRows ||
               (s - lo) / kItemRows != (ps - lo) / kItemRows;
    }
    n_pt[h] = hot ? (n + kHotRows - 1) / kHotRows : 0;
    n_it[h] = hot ? n_pt[h] : (int)begins;
    bound[h] = __ballot_sync(0xffffffffu, hot || begins);
  }
  const int2 own = make_int2(warp_sum(n_it[0] + n_it[1]),
                             warp_sum(n_pt[0] + n_pt[1]));
  if (!Write) {
    if (lane == 0) s_cnt[wi] = own;
    __syncthreads();
    if (wi == 0) {
      const int2 c = lane < kPlanWarps ? s_cnt[lane] : make_int2(0, 0);
      int2 sum;
      const int2 ex = make_int2(warp_exclusive(c.x, lane, &sum.x),
                                warp_exclusive(c.y, lane, &sum.y));
      if (lane < kPlanWarps && blockIdx.x * kPlanWarps + lane < n_cand) {
        cnt[blockIdx.x * kPlanWarps + lane] = ex;
      }
      if (lane == 0) blk[blockIdx.x] = sum;
    }
    return;
  }
  if (k >= n_cand) return;
  int2 at = make_int2(0, 0);  // the totals of the blocks before this one
  for (int b = lane; b < (int)blockIdx.x; b += 32) {
    at.x += blk[b].x;
    at.y += blk[b].y;
  }
  int it_at = warp_sum(at.x) + cnt[k].x, pt_at = warp_sum(at.y) + cnt[k].y;
  if (k == n_cand - 1 && lane == 0) {
    *total = make_int2(it_at + own.x, pt_at + own.y);
  }
  if (!mine) return;
  const unsigned long long bounds =
      (unsigned long long)bound[0] | ((unsigned long long)bound[1] << 32);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
    int it_sum, pt_sum;
    const int o = it_at + warp_exclusive(n_it[h], lane, &it_sum);
    const int p = pt_at + warp_exclusive(n_pt[h], lane, &pt_sum);
    it_at += it_sum;
    pt_at += pt_sum;
    const int s = start[j];
    if (n_pt[h]) {
      const int e = start[j + 1];
      for (int c = 0; c < n_pt[h]; ++c) {
        items[o + c] = make_int4(base + j, -1 - (p + c), s + c * kHotRows,
                                 min(s + (c + 1) * kHotRows, e));
        pinfo[p + c] = make_int2(base + j, c == 0 ? n_pt[h] : 0);
      }
    } else if (n_it[h]) {
      // the run ends where the next run or hot cell begins
      const unsigned long long above =
          j == kWin - 1 ? 0ull : bounds >> (j + 1);
      const int j_end = above ? j + __ffsll((long long)above) : kWin;
      items[o] = make_int4(base + j, min(j_end, n_cells) - j, s,
                           start[j_end]);
    }
  }
}

// Blocks [0, n_item_blocks): the items of the plan. Blocks beyond: window
// blockIdx.x - n_item_blocks, unless it has more than kItemRows rows (its
// items cover it).
template <bool Transposed>
__global__ void accumulate_kernel(const int* __restrict__ idx,
                                  const float* __restrict__ upd, int C,
                                  int n_rows, const int* __restrict__ offs,
                                  const int4* __restrict__ items,
                                  const int2* __restrict__ total,
                                  int n_item_blocks,
                                  float* __restrict__ partial,
                                  float* __restrict__ out) {
  extern __shared__ float tile[];  // [C][kWin + 1], padded: no bank clash
  constexpr int kLd = kWin + 1;
  int base, n_cells, lo, hi, part = -1;
  if ((int)blockIdx.x < n_item_blocks) {
    if ((int)blockIdx.x >= total->x) return;
    const int4 it = items[blockIdx.x];
    base = it.x;
    lo = it.z;
    hi = it.w;
    n_cells = it.y;
    if (it.y < 0) {
      part = -1 - it.y;
      n_cells = 1;
    }
  } else {
    const int w = blockIdx.x - n_item_blocks;
    lo = offs[w];
    hi = offs[w + 1];
    if (hi - lo > kItemRows) return;
    base = w * kWin;
    n_cells = min(kWin, n_rows - base);
  }
  const int c = threadIdx.x, lane = c & 31;
  const bool live = c < C;
  float* mine = tile + c * kLd;  // this channel's sums, by cell
  if (live) {
    for (int j = 0; j < n_cells; ++j) mine[j] = 0.f;
  }
  float acc = 0.f;
  int cur = -1;  // cell (relative to base) whose sum acc holds
  float v[kRows];  // this round's rows of the channel, and their cells,
  int my_cell;     // one a lane
  {
    const int n = min(kRows, hi - lo);
    my_cell = lane < n ? idx[lo + lane] - base : 0;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      v[j] = (live && j < n) ? upd[(size_t)(lo + j) * C + c] : 0.f;
    }
  }
  for (int r0 = lo; r0 < hi; r0 += kRows) {
    const int n = min(kRows, hi - r0);
    const int r1 = r0 + kRows;
    const int nn = max(0, min(kRows, hi - r1));
    // the next round's loads go out before this round is walked
    const int next_cell = lane < nn ? idx[r1 + lane] - base : 0;
    float w[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      w[j] = (live && j < nn) ? upd[(size_t)(r1 + j) * C + c] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int cell = __shfl_sync(0xffffffffu, my_cell, j);
      if (j < n) {
        if (cell != cur) {
          if (live && cur >= 0) mine[cur] = acc;
          acc = 0.f;
          cur = cell;
        }
        acc += v[j];
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) v[j] = w[j];
    my_cell = next_cell;
  }
  if (part >= 0) {
    if (live) partial[(size_t)part * C + c] = acc;
    return;
  }
  if (live && cur >= 0) mine[cur] = acc;
  __syncthreads();
  if (Transposed && n_cells == kWin) {
    for (int e = threadIdx.x; e < C * kWin; e += blockDim.x) {
      const int ch = e / kWin, j = e - ch * kWin;
      out[(size_t)ch * n_rows + base + j] = tile[ch * kLd + j];
    }
  } else if (Transposed) {
    for (int e = threadIdx.x; e < C * n_cells; e += blockDim.x) {
      const int ch = e / n_cells, j = e - ch * n_cells;
      out[(size_t)ch * n_rows + base + j] = tile[ch * kLd + j];
    }
  } else {
    for (int e = threadIdx.x; e < C * n_cells; e += blockDim.x) {
      const int j = e / C, ch = e - j * C;
      out[(size_t)(base + j) * C + ch] = tile[ch * kLd + j];
    }
  }
}

// A hot cell's sum: its chunks' partial rows added in ascending chunk
// order. Block p does the cell whose first chunk is partial row p.
template <bool Transposed>
__global__ void combine_kernel(const float* __restrict__ partial,
                               const int2* __restrict__ pinfo,
                               const int2* __restrict__ total, int C,
                               int n_rows, float* __restrict__ out) {
  const int p = blockIdx.x, c = threadIdx.x;
  if (p >= total->y) return;
  const int2 info = pinfo[p];
  if (info.y == 0 || c >= C) return;
  float acc = 0.f;
  for (int i = 0; i < info.y; ++i) acc += partial[(size_t)(p + i) * C + c];
  if (Transposed) {
    out[(size_t)c * n_rows + info.x] = acc;
  } else {
    out[(size_t)info.x * C + c] = acc;
  }
}

inline int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

}  // namespace

extern "C" int scatter_item_rows() { return kItemRows; }
extern "C" int scatter_hot_rows() { return kHotRows; }

// idx [M] int32 ascending; rows with idx outside [0, n_rows) are dropped
// without being read. upd [M, C] fp32; out [n_rows, C] fp32, or
// [C, n_rows] when transposed. 1 <= C <= 512. Scratch, with n_cand =
// ceil(M / kItemRows) and n_part = 2 * ceil(M / kHotRows) + 1: offs
// [ceil(n_rows / 64) + 1] int32; cnt int2 [n_cand + ceil(n_cand / 8) + 1]
// (the candidates, the plan blocks, and last the totals: items, partial
// rows); items int4 [3 * n_cand + 1]; pinfo int2 [n_part]; partial fp32
// [n_part, C]. The bounds: a window over kItemRows rows gives at most
// 1 + 2 * rows / kItemRows items (run starts: 1 + rows / kItemRows + hot
// cells; chunks: rows / kHotRows + hot cells; hot cells < rows / kHotRows;
// kHotRows >= 3 * kItemRows), and there are at most n_cand such windows.
extern "C" int scatter_launch(const int* idx, const float* upd, int M, int C,
                              int n_rows, int transposed, int* offs,
                              void* cnt, void* items, void* pinfo,
                              float* partial, float* out, void* stream) {
  if (n_rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_win = (n_rows + kWin - 1) / kWin;
  const int n_cand = ceil_div(M, kItemRows);
  const int n_item_blocks = 3 * n_cand + 1;
  const int n_partial = 2 * ceil_div(M, kHotRows) + 1;
  const int plan_blocks = ceil_div(n_cand, kPlanWarps);
  const int plan_threads = 32 * kPlanWarps;
  int2* cnt2 = static_cast<int2*>(cnt);
  int2* blk = cnt2 + n_cand;
  int2* total = blk + plan_blocks;
  int4* items4 = static_cast<int4*>(items);
  int2* pinfo2 = static_cast<int2*>(pinfo);
  plan_kernel<false>
      <<<plan_blocks + ceil_div(n_win + 1, plan_threads), plan_threads, 0, s>>>(
          idx, M, n_rows, offs, n_win, n_cand, plan_blocks, cnt2, blk, total,
          items4, pinfo2);
  if (n_cand > 0) {
    plan_kernel<true><<<plan_blocks, plan_threads, 0, s>>>(
        idx, M, n_rows, offs, n_win, n_cand, plan_blocks, cnt2, blk, total,
        items4, pinfo2);
  } else {
    cudaMemsetAsync(total, 0, sizeof(int2), s);
  }
  const int threads = ((C + 31) / 32) * 32;
  const size_t smem = (size_t)C * (kWin + 1) * sizeof(float);
  const int blocks = n_item_blocks + n_win;
  const bool may_be_hot = M > kHotRows;
  if (transposed) {
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(accumulate_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    }
    accumulate_kernel<true><<<blocks, threads, smem, s>>>(
        idx, upd, C, n_rows, offs, items4, total, n_item_blocks, partial,
        out);
    if (may_be_hot) {
      combine_kernel<true><<<n_partial, threads, 0, s>>>(
          partial, pinfo2, total, C, n_rows, out);
    }
  } else {
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(accumulate_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    }
    accumulate_kernel<false><<<blocks, threads, smem, s>>>(
        idx, upd, C, n_rows, offs, items4, total, n_item_blocks, partial,
        out);
    if (may_be_hot) {
      combine_kernel<false><<<n_partial, threads, 0, s>>>(
          partial, pinfo2, total, C, n_rows, out);
    }
  }
  return (int)cudaGetLastError();
}
