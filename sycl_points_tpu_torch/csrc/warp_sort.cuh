// Warp-wide sorted lists of 64-bit keys for the search kernels above k = 16
// (window_knn.cu, knn_cluster.cu, range_image.cu).
//
// A list of n = 32 P keys lives in the registers of one warp, P a lane:
// element i sits in lane i / P, register i % P. A key packs what the list is
// ordered by into one unsigned integer (a distance's f32 bits above a column,
// an index or a position), so the order is total and any visiting order of
// the candidates gives the same list.
//
//   - warp_sort: a bitonic sort of the n keys, ascending. Steps of a distance
//     below P exchange registers of one lane; the rest exchange a register
//     with the lane i / P ^ (j / P) by a shuffle.
//   - warp_merge: the n smallest of two ascending lists: min(a[i], b[n-1-i])
//     is a bitonic sequence holding them, which log2(n) steps sort;
//   - warp_insert: one key into a sorted list at its rank (a ballot a
//     register and one lane shift), cheaper than a sort and a merge for a
//     few keys.
//
// Every loop unrolls at compile time, so no register is indexed at run time
// and nothing spills (-Xptxas -v reports 0 bytes at P = 1, 2, 4 and 8).
#pragma once

#include <cuda_runtime.h>

namespace spt {

constexpr unsigned long long kEmptyKey = ~0ull;

// One compare-exchange step of distance j inside bitonic blocks of `size`
// elements (ascending where i & size is 0).
template <int P>
__device__ __forceinline__ void bitonic_step(unsigned long long (&e)[P], int size, int j, int lane) {
  if (j < P) {
#pragma unroll
    for (int r = 0; r < P; ++r) {
      const int r2 = r ^ j;
      if (r2 > r) {
        const bool asc = ((lane * P + r) & size) == 0;
        const unsigned long long a = e[r], b = e[r2];
        const bool swap = asc ? b < a : a < b;
        e[r] = swap ? b : a;
        e[r2] = swap ? a : b;
      }
    }
  } else {
    const int m = j / P;
#pragma unroll
    for (int r = 0; r < P; ++r) {
      const int i = lane * P + r;
      const unsigned long long o = __shfl_xor_sync(0xffffffffu, e[r], m);
      const bool keep_min = (((i & size) == 0) == ((i & j) == 0));
      e[r] = keep_min ? (o < e[r] ? o : e[r]) : (o < e[r] ? e[r] : o);
    }
  }
}

// log2 of a power of two, at compile time
__host__ __device__ constexpr int log2_of(int n) { return n <= 1 ? 0 : 1 + log2_of(n / 2); }

template <int P>
__device__ __forceinline__ void warp_sort(unsigned long long (&e)[P]) {
  const int lane = threadIdx.x & 31;
  constexpr int kLog = log2_of(32 * P);
#pragma unroll
  for (int ls = 1; ls <= kLog; ++ls) {
#pragma unroll
    for (int lj = ls - 1; lj >= 0; --lj) bitonic_step<P>(e, 1 << ls, 1 << lj, lane);
  }
}

// a <- the n smallest of a and b, ascending (both ascending on entry).
template <int P>
__device__ __forceinline__ void warp_merge(unsigned long long (&a)[P], const unsigned long long (&b)[P]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < P; ++r) {
    const unsigned long long o = __shfl_sync(0xffffffffu, b[P - 1 - r], 31 - lane);
    a[r] = o < a[r] ? o : a[r];
  }
#pragma unroll
  for (int lj = log2_of(16 * P); lj >= 0; --lj) bitonic_step<P>(a, 64 * P, 1 << lj, lane);
}

// Puts key (the same in every lane) into the ascending list a at its rank;
// the keys above it move up one place and the last falls off.
template <int P>
__device__ __forceinline__ void warp_insert(unsigned long long (&a)[P], unsigned long long key) {
  const int lane = threadIdx.x & 31;
  int at = 0;  // the keys below key
#pragma unroll
  for (int r = 0; r < P; ++r) at += __popc(__ballot_sync(0xffffffffu, a[r] < key));
  const unsigned long long up = __shfl_up_sync(0xffffffffu, a[P - 1], 1);  // element lane P - 1
#pragma unroll
  for (int r = P - 1; r >= 0; --r) {
    const int i = lane * P + r;
    const unsigned long long below = r ? a[r - 1] : up;
    a[r] = i < at ? a[r] : i == at ? key : below;
  }
}

// The list's last (largest) key, in every lane.
template <int P>
__device__ __forceinline__ unsigned long long warp_last(const unsigned long long (&a)[P]) {
  return __shfl_sync(0xffffffffu, a[P - 1], 31);
}

__device__ __forceinline__ unsigned long long pack_key(unsigned hi, unsigned lo) {
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

__device__ __forceinline__ unsigned key_hi(unsigned long long key) { return static_cast<unsigned>(key >> 32); }
__device__ __forceinline__ unsigned key_lo(unsigned long long key) { return static_cast<unsigned>(key); }

}  // namespace spt
