// K1: exact k-NN (k <= 16) of M queries against P points, indices in the
// original point order, ties to the lower original index.
//
// Replaces apnerf/kernels/knn_pallas.py:knn_pallas (via knn_pallas_sorted),
// the canonical-cloud k-NN of init_state, run once per model load. Like
// the TPU kernel it prunes: the points are Morton-sorted into the tiles of
// kernels/knn_cells.build_point_tables (the tables K2 and K3 scan) and the
// queries along the same curve, and the scan is K3's top-k scan
// (knn_scan.cuh) with a radius per query instead of one for the call: the
// seed, the largest d2 over the k sorted points around the query's own
// position, which bounds its kth distance from above. A block walks only
// the tiles within the largest seed of its queries, a warp only those
// within its running kth distances, so a query meets the points near it
// and not all P. Bound on the H100: the distance evaluations of the pairs
// its warps scan (fp32 without FMA); the bytes are a few hundred KB.
#include "knn_scan.cuh"

// q [*, 3] queries in the caller's order; qorder [M] int64: their Morton
// order (sorted query m is row qorder[m]); qpos [M] int64 or null: the
// sorted point position near sorted query m (null: m, the points
// themselves); pts_t [T, 3, pts], t_lo, t_hi [T, 3]: the point tables of
// P >= k points, perm [P] int64 (sorted row -> row); out_d, out_i [M, k] in
// the caller's row order; tiles_out: null, or the tiles each warp scanned.
extern "C" int knn_brute_launch(const float* q, const long long* qorder,
                                const long long* qpos, int M,
                                const float* pts_t, const float* t_lo,
                                const float* t_hi, int T, int pts, int P,
                                const long long* perm, int k, float* out_d,
                                int* out_i, int* tiles_out, void* stream) {
  if (k > P || P <= 0) return (int)cudaErrorInvalidValue;
  return launch_topk<true>(q, qorder, qpos, M, pts_t, t_lo, t_hi, T, pts, P,
                           perm, 0.f, k, out_d, out_i, tiles_out, stream);
}
