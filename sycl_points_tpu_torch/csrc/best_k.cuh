// The sorted best-k list of the structured search kernels (grid_knn.cu,
// coarse_knn.cu, window_knn.cu), as knn.cu and range_image.cu keep theirs.
//
// bd / bi hold the K smallest distances seen so far, ascending, and their
// indices. A candidate enters with a strict `<`, so a distance equal to one
// already held stays behind it: walked in JAX's candidate order, the list
// equals lax.top_k's (and argmin's, for K = 1), which keep the earlier slot
// on ties. A +inf (or NaN) distance never enters; the kernels fill the slots
// it leaves with JAX's padding in a second walk (see each kernel).
#pragma once

#include <cuda_runtime.h>

template <int K>
__device__ __forceinline__ void best_k_init(float (&bd)[K], int (&bi)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    bd[j] = __int_as_float(0x7f800000);  // +inf
    bi[j] = 0;
  }
}

template <int K>
__device__ __forceinline__ void best_k_insert(float (&bd)[K], int (&bi)[K], float d, int id) {
#pragma unroll
  for (int j = K - 1; j > 0; --j) {
    if (d < bd[j]) {
      const bool up = d < bd[j - 1];
      bd[j] = up ? bd[j - 1] : d;
      bi[j] = up ? bi[j - 1] : id;
    }
  }
  if (d < bd[0]) {
    bd[0] = d;
    bi[0] = id;
  }
}

// Writes the finite entries of the list to out_idx / out_d2 and returns how
// many there are; the caller fills the rest.
template <int K>
__device__ __forceinline__ int best_k_store(const float (&bd)[K], const int (&bi)[K], int* out_idx,
                                            float* out_d2) {
  int n = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (bd[j] < __int_as_float(0x7f800000)) {
      out_idx[j] = bi[j];
      out_d2[j] = bd[j];
      n = j + 1;
    }
  }
  return n;
}
