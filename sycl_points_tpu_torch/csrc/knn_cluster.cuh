// Device helpers of the split-target cluster kernels (knn_cluster.cu): the
// cp.async staging of a prepared target, the scan of a staged span into a
// sorted best-k, and the two insertion rules, index order for the scan and
// lexicographic (d, idx) for the merge.
//
// A prepared target (ops/cuda_knn.prep_target) is SoA [3, Mp] float32: the x
// row, then y, then z, with masked rows and the padding up to Mp (a multiple
// of kTile) set to +inf, and an extent, 1 + its last valid row. An +inf
// target's distance is +inf, which no strict `<` takes, so the kernels read
// whole aligned 32-row units up to the extent, rounded up into the padding,
// with no mask and no edge test.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "nn1_common.cuh"

namespace spt {

// 16-byte asynchronous copy global -> shared (both 16-byte aligned).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Insert (d, idx) into the ascending list (bd, bi), after every entry <= d:
// with targets scanned in ascending index order, ties keep the lower index.
// The caller has checked d < bd[K-1]; the old k-th falls off the end. bd[s]
// still holds its old value when slot s is decided.
template <int K>
__device__ __forceinline__ void insert_sorted(float (&bd)[K], int (&bi)[K], float d, int idx) {
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    if (bd[s] > d) {
      if (bd[s - 1] > d) {
        bd[s] = bd[s - 1];
        bi[s] = bi[s - 1];
      } else {
        bd[s] = d;
        bi[s] = idx;
      }
    }
  }
  if (bd[0] > d) {
    bd[0] = d;
    bi[0] = idx;
  }
}

__device__ __forceinline__ bool lex_less(float d0, int i0, float d1, int i1) {
  return d0 < d1 || (d0 == d1 && i0 < i1);
}

// Insert (d, idx) into a list ascending by (d, idx); the caller has checked
// lex_less(d, idx, bd[K-1], bi[K-1]). The merge's rule: lists from different
// slices come in no index order, so ties are settled by the index itself.
template <int K>
__device__ __forceinline__ void insert_lex(float (&bd)[K], int (&bi)[K], float d, int idx) {
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    if (lex_less(d, idx, bd[s], bi[s])) {
      if (lex_less(d, idx, bd[s - 1], bi[s - 1])) {
        bd[s] = bd[s - 1];
        bi[s] = bi[s - 1];
      } else {
        bd[s] = d;
        bi[s] = idx;
      }
    }
  }
  if (lex_less(d, idx, bd[0], bi[0])) {
    bd[0] = d;
    bi[0] = idx;
  }
}

// Scan the staged targets [j0, j1) (j0, j1 multiples of 4; sx, sy, sz
// 16-byte aligned) for one query, target j having index first + j * stride.
// Each float4 load is a warp-wide broadcast that feeds 4 distances; one
// branch a group of them takes the rare insertions, in ascending index order.
// lim = min(bd[K-1], cap) is the bound a distance must beat to enter the list.
template <int K>
__device__ __forceinline__ void scan_span(const float* sx, const float* sy, const float* sz, int j0,
                                          int j1, int first, int stride, float qx, float qy,
                                          float qz, float (&bd)[K], int (&bi)[K], float& lim,
                                          float cap) {
#pragma unroll 2
  for (int j = j0; j < j1; j += 4) {
    const float4 x4 = *reinterpret_cast<const float4*>(sx + j);
    const float4 y4 = *reinterpret_cast<const float4*>(sy + j);
    const float4 z4 = *reinterpret_cast<const float4*>(sz + j);
    const float d[4] = {sqdist(qx, qy, qz, x4.x, y4.x, z4.x), sqdist(qx, qy, qz, x4.y, y4.y, z4.y),
                        sqdist(qx, qy, qz, x4.z, y4.z, z4.z), sqdist(qx, qy, qz, x4.w, y4.w, z4.w)};
    if ((d[0] < lim) | (d[1] < lim) | (d[2] < lim) | (d[3] < lim)) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (d[u] < lim) {
          insert_sorted<K>(bd, bi, d[u], first + (j + u) * stride);
          lim = fminf(bd[K - 1], cap);
        }
      }
    }
  }
}

}  // namespace spt
