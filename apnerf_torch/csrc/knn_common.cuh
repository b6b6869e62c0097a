// Shared device helpers of the k-NN kernels (knn_brute.cu, knn_cells.cu).
#pragma once

#include <cuda_runtime.h>

// Squared distance formed exactly as the plain PyTorch versions form it:
// (dx*dx + dy*dy) + dz*dz with every operation rounded on its own. The
// _rn intrinsics keep nvcc from contracting to FMA, which would move points
// across the d2 <= r2 boundary and make counts differ from the plain path.
__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float px, float py, float pz) {
  const float dx = __fsub_rn(qx, px);
  const float dy = __fsub_rn(qy, py);
  const float dz = __fsub_rn(qz, pz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Dispatch a runtime k in [1, 16] to a template instance KERNEL_CALL<K>.
#define KNN_DISPATCH_K(k, CALL)                                              \
  switch (k) {                                                               \
    case 1: CALL(1); break;   case 2: CALL(2); break;                        \
    case 3: CALL(3); break;   case 4: CALL(4); break;                        \
    case 5: CALL(5); break;   case 6: CALL(6); break;                        \
    case 7: CALL(7); break;   case 8: CALL(8); break;                        \
    case 9: CALL(9); break;   case 10: CALL(10); break;                      \
    case 11: CALL(11); break; case 12: CALL(12); break;                      \
    case 13: CALL(13); break; case 14: CALL(14); break;                      \
    case 15: CALL(15); break; case 16: CALL(16); break;                      \
    default: return (int)cudaErrorInvalidValue;                              \
  }
