// The sorted best-k list of the structured search kernels (grid_knn.cu,
// coarse_knn.cu, window_knn.cu), as knn.cu and range_image.cu keep theirs,
// and the instances every production search is built at.
//
// bd / bi hold the K smallest distances seen so far, ascending, and their
// indices. A candidate enters with a strict `<`, so a distance equal to one
// already held stays behind it: walked in JAX's candidate order, the list
// equals lax.top_k's (and argmin's, for K = 1), which keep the earlier slot
// on ties. A +inf (or NaN) distance never enters; the kernels fill the slots
// it leaves with JAX's padding in a second walk (see each kernel).
//
// The instances: K = 1 .. kFastK one each, and above it three more (32, 64 and
// 128). A request for k in (kFastK, kMaxK] runs the smallest instance K >= k
// and writes the first k entries of its list: with the strict `<` in JAX's
// candidate order the first k entries of a K-list are the k-list, padding
// included. An entry point takes k and picks its instance with instance_k().
#pragma once

#include <cuda_runtime.h>

namespace spt {

constexpr int kFastK = 16;   // one instance a k up to here
constexpr int kMaxK = 128;   // the largest instance: the reference's MAX_K 100, rounded up

// The instance that serves a request for k (0 when none does).
__host__ __device__ constexpr int instance_k(int k) {
  return k < 1 ? 0 : k <= kFastK ? k : k <= 32 ? 32 : k <= 64 ? 64 : k <= kMaxK ? kMaxK : 0;
}

// The count a K instance writes a row: K itself for the small instances (a
// compile-time constant, so they run as before), the request k above.
template <int K>
__device__ __forceinline__ int row_count(int k) {
  return K <= kFastK ? K : k;
}

}  // namespace spt

// The cases of a switch over instance_k(k), each expanding CASE(K).
#define SPT_K_CASES(CASE) \
  CASE(1)                 \
  CASE(2)                 \
  CASE(3)                 \
  CASE(4)                 \
  CASE(5)                 \
  CASE(6)                 \
  CASE(7)                 \
  CASE(8)                 \
  CASE(9)                 \
  CASE(10)                \
  CASE(11)                \
  CASE(12)                \
  CASE(13)                \
  CASE(14)                \
  CASE(15)                \
  CASE(16)                \
  CASE(32)                \
  CASE(64)                \
  CASE(128)

// The first designs' cases: k = 1 .. kFastK.
#define SPT_FAST_K_CASES(CASE) \
  CASE(1)                      \
  CASE(2)                      \
  CASE(3)                      \
  CASE(4)                      \
  CASE(5)                      \
  CASE(6)                      \
  CASE(7)                      \
  CASE(8)                      \
  CASE(9)                      \
  CASE(10)                     \
  CASE(11)                     \
  CASE(12)                     \
  CASE(13)                     \
  CASE(14)                     \
  CASE(15)                     \
  CASE(16)

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
