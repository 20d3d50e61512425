// The lane-group k-NN of the structured searches (grid_knn.cu, coarse_knn.cu):
// G lanes of one warp (G = 8, 16 or 32) search one query's candidate slots.
//
// The candidates sit in cells, slot s = c W + j for lane j < W of cell c
// (W the cells' slot width: GridKNN's max_per_cell, CoarseKNN's budget L),
// which is JAX's candidate order; only the first n_c lanes of cell c hold a
// candidate. The group takes the exclusive prefix pre[c] of n over the cells
// (shuffles), so candidate t of the query's T = sum n lies in the cell c with
// pre[c] <= t < pre[c + 1], at lane j = t - pre[c].
//   - walk: lane l takes t = l, l + G, ...: a cell's contiguous rows load side
//     by side, two a lane a step. Each lane keeps the sorted K smallest of its
//     own candidates by (d2, s) (a strict `<` insertion in its increasing s).
//     A ballot per step ranks the non-finite candidates (masked rows, an
//     overflowing distance) with popcounts and keeps the first K positions.
//   - merge: rounds of a butterfly argmin by (d2, s) over the group's list
//     heads; the winner pops its head. The lists hold slots, not indices.
//   - padding: the slots the finite entries leave get JAX's padding, the
//     first slots in (c, j) order with no finite candidate. Each lane ranks
//     the empty slots of its own cells: lanes j >= n_c, and the kept
//     non-finite candidates of cell c, each at its rank among all non-finite
//     slots (c W - pre[c] empty lanes lie in the cells before c). No serial
//     walk.
// The result equals a strict-`<` walk of every slot in order (lax.top_k's
// order, argmin's for K = 1), bit for bit.
#pragma once

#include <cuda_runtime.h>

#include "best_k.cuh"

namespace spt {

constexpr int kNoSlot = 0x7fffffff;

// A thread's place in its lane group.
template <int G>
struct LaneGroup {
  int lane;       // 0 .. G - 1
  int base;       // the group's first lane in its warp
  unsigned mask;  // the group's lanes in its warp
  __device__ explicit LaneGroup(int tid)
      : lane(tid % G),
        base((tid & 31) & ~(G - 1)),
        mask(G == 32 ? 0xffffffffu : ((1u << G) - 1u) << ((tid & 31) & ~(G - 1))) {}
};

// The exclusive prefix of n over the group's lanes (one cell a lane) after
// the carry of the cells before them; the carry grows by the lanes' total.
template <int G>
__device__ __forceinline__ int chunk_prefix(int n, const LaneGroup<G>& g, int& carry) {
  int x = n;
#pragma unroll
  for (int d = 1; d < G; d <<= 1) {
    const int y = __shfl_up_sync(g.mask, x, d, G);
    if (g.lane >= d) x += y;
  }
  const int pre = carry + x - n;
  carry += __shfl_sync(g.mask, x, G - 1, G);
  return pre;
}

// One candidate t of the walk: its slot s = o W + j (the cursor o advanced
// to t's cell) and its distance dx*dx + dy*dy + dz*dz, dx = point - query,
// +inf where the row is masked. The row's point and mask load together; the
// row is start[o] + j clipped into [0, M).
__device__ __forceinline__ float lane_candidate(int t, int* o, const int* pre, const int* start, int W, int M,
                                                const float* __restrict__ pts,
                                                const unsigned char* __restrict__ pmask, float qx, float qy,
                                                float qz, int* s) {
  while (pre[*o + 1] <= t) ++*o;
  const int j = t - pre[*o];
  const int p = min(max(start[*o] + j, 0), M - 1);
  *s = *o * W + j;
  const unsigned char m = __ldg(pmask + p);
  const float dx = __ldg(pts + 3 * p) - qx;
  const float dy = __ldg(pts + 3 * p + 1) - qy;
  const float dz = __ldg(pts + 3 * p + 2) - qz;
  const float d = dx * dx + dy * dy + dz * dz;
  return m ? d : __int_as_float(0x7f800000);
}

// The walk over the T candidates: each lane's list (bd, bs) of the K smallest
// (d2, s), and nf the first K non-finite candidates' t. cand(t, &o, &s)
// returns candidate t's distance and slot (o: the lane's cell cursor).
// Returns the count of non-finite candidates.
template <int K, int G, class Cand>
__device__ __forceinline__ int lane_walk(int T, const LaneGroup<G>& g, float (&bd)[K], int (&bs)[K], int* nf,
                                         Cand cand) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    bd[j] = __int_as_float(0x7f800000);
    bs[j] = kNoSlot;
  }
  int n_nf = 0;
  int o0 = 0, o1 = 0;
  for (int b = 0; b < T; b += 2 * G) {
    const int t0 = b + g.lane, t1 = b + G + g.lane;
    int s0 = 0, s1 = 0;
    const float d0 = t0 < T ? cand(t0, &o0, &s0) : __int_as_float(0x7f800000);
    const float d1 = t1 < T ? cand(t1, &o1, &s1) : __int_as_float(0x7f800000);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float d = h ? d1 : d0;
      const int s = h ? s1 : s0;
      const int t = h ? t1 : t0;
      if (d < bd[K - 1]) best_k_insert<K>(bd, bs, d, s);
      const bool nonfinite = t < T && !(d < __int_as_float(0x7f800000));
      const unsigned bits = __ballot_sync(g.mask, nonfinite) >> g.base;
      if (nonfinite) {
        const int rank = n_nf + __popc(bits & ((1u << g.lane) - 1u));
        if (rank < K) nf[rank] = t;
      }
      n_nf += __popc(bits);
    }
  }
  return n_nf;
}

// Merge the lanes' lists by (d2, s) in n_out rounds of a butterfly argmin;
// the round's winner pops its head. Every lane calls emit(r, d2, s) with
// round r's entry.
template <int K, int G, class Emit>
__device__ __forceinline__ void lane_merge(float (&bd)[K], int (&bs)[K], int n_out, const LaneGroup<G>& g,
                                           Emit emit) {
  for (int r = 0; r < n_out; ++r) {
    float d = bd[0];
    int s = bs[0];
#pragma unroll
    for (int m = G / 2; m >= 1; m >>= 1) {
      const float d2 = __shfl_xor_sync(g.mask, d, m, G);
      const int s2 = __shfl_xor_sync(g.mask, s, m, G);
      if (d2 < d || (d2 == d && s2 < s)) {
        d = d2;
        s = s2;
      }
    }
    if (bs[0] == s) {
#pragma unroll
      for (int i = 0; i < K - 1; ++i) {
        bd[i] = bd[i + 1];
        bs[i] = bs[i + 1];
      }
      bd[K - 1] = __int_as_float(0x7f800000);
      bs[K - 1] = kNoSlot;
    }
    emit(r, d, s);
  }
}

// JAX's padding: the first `want` slots, in (c, j) order over n_cells cells
// of W slots, with no finite candidate; nf holds the first `kept` non-finite
// candidates' t. Each lane ranks the slots of its own cells and calls
// emit(rank, c, j) for each one whose rank is below want.
template <int G, class Emit>
__device__ __forceinline__ void lane_padding(const int* pre, int n_cells, int W, const int* nf, int kept, int want,
                                             const LaneGroup<G>& g, Emit emit) {
  for (int c = g.lane; c < n_cells; c += G) {
    const int c_pre = pre[c], n = pre[c + 1] - c_pre;
    const int shift = c * W - c_pre;  // empty lanes (j >= n) of the cells before c
    int before = 0, through = 0;      // kept non-finite candidates before / through cell c
    for (int i = 0; i < kept; ++i) {
      before += nf[i] < c_pre;
      through += nf[i] < c_pre + n;
    }
    for (int i = before; i < through && i + shift < want; ++i) emit(i + shift, c, nf[i] - c_pre);
    for (int j = n, rank = through + shift; j < W && rank < want; ++j, ++rank) emit(rank, c, j);
  }
}

}  // namespace spt
