// Device helpers shared by the nearest-neighbour kernels (knn.cu,
// nn1_variants.cu, nn1_tiles.cu): target staging into shared memory and the exact squared
// distance. Every kernel that uses them computes its distances with the same
// operation order, so all of them agree bit for bit (the library is built
// with --fmad=false).

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace spt {

// Stage targets [base, base + kTile) into shared memory; masked or
// out-of-range rows become +inf, so their distance is +inf and a strict `<`
// never takes them.
template <int kTile>
__device__ __forceinline__ void stage_tile(const float* __restrict__ tgt,
                                           const unsigned char* __restrict__ mask,
                                           int M, int base, float* sx, float* sy,
                                           float* sz) {
  for (int j = threadIdx.x; j < kTile; j += blockDim.x) {
    int g = base + j;
    float x = CUDART_INF_F, y = CUDART_INF_F, z = CUDART_INF_F;
    if (g < M && mask[g] != 0) {
      x = tgt[3 * g + 0];
      y = tgt[3 * g + 1];
      z = tgt[3 * g + 2];
    }
    sx[j] = x;
    sy[j] = y;
    sz[j] = z;
  }
}

// (q - t)^2 summed as ((e0*e0 + e1*e1) + e2*e2): the Pallas kernels' and the
// plain PyTorch version's order.
__device__ __forceinline__ float sqdist(float qx, float qy, float qz, float tx,
                                        float ty, float tz) {
  float e0 = qx - tx;
  float e1 = qy - ty;
  float e2 = qz - tz;
  return e0 * e0 + e1 * e1 + e2 * e2;
}

}  // namespace spt
