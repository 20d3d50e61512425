// The Morton-window self-k-NN for Hopper (sm_90a), plain C interface.
//
// These kernels replace the XLA ops of the JAX package's window_self_knn
// (sycl_points_tpu/ops/window_knn.py:60-156): the Morton codes of both
// passes, each pass's window search (_window_pass: [N, 2W] distances to the
// points at sorted offsets -W .. -1, 1 .. W built from 2W rolls of the sorted
// cloud, a top_k, the offsets mapped back through the sort, the rows scattered
// to the original order) and the union of the two passes. None of it is a
// Pallas kernel, so these port no TPU kernel; they take the place of a
// self-k-NN (knn_k) for clouds with no scan structure. The sort by code stays
// torch.sort (JAX sorts with lax.sort, outside any kernel).
//
// What bounds a pass on the card: per sorted position 2W neighbours at ~9
// FP32 operations a column against 21 B read a point (the cloud, its mask and
// the permutation) and 8 k B written: the FP32 lanes bound it at small k, the
// bytes from k = 32 on (the union pass reads pass 1's 8 k B too). The codes are bytes: 13 B read and 4 B a pass written
// a point.
//
// One window_self_knn on the card: a memset and morton_min (the per-axis
// minimum cell over the finite rows, an atomic a block into 3 ints),
// morton_codes (both passes' codes, [2, N]), the sort, the pass-1 window and
// the pass-2 window with the union folded in.
//
// The window kernels (morton_tile_kernel, K <= 16: a thread a sorted
// position; morton_warp_kernel, K = 32 / 64 / 128: a warp a position):
//   - A block stages its sorted positions and a W halo each side into shared
//     memory, a float4 each: x, y, z and the original index, complemented
//     (~idx) where the point is invalid or the position is off [0, N). In the
//     gather form it reads the cloud through the sort's permutation; off-range
//     positions stage the clipped position's point, so each slot's index is
//     idx_s of the clipped partner, as in JAX.
//   - A column's value is d2 = dx*dx + dy*dy + dz*dz when the position, its
//     partner and both validities hold, else 3e38 (JAX's where()).
//   - The list keeps the smallest keys (d2 bits << 32 | column), column being
//     JAX's column index over -W .. -1, 1 .. W: that is lax.top_k's order,
//     ties to the earlier column, whatever order the columns are visited in.
//     A non-finite d2 (overflow) keys as +inf's bits, so such columns follow
//     every finite one in column order, at their value: the first design's
//     padding rule.
//   - K <= 16 visits the offsets nearest first (+1, -1, +2, ...): the first K
//     fill the list by compare-exchanges, and most later columns fail one
//     float compare against the K-th. K >= 32 takes the columns K at a time
//     (nearest first), drops those at or above the list's last key, and
//     bitonic-sorts and merges the rest (warp_sort.cuh), the list spread K/32
//     a lane.
//   - Rows are written at the original position. The pass-2 form reads pass
//     1's row there and writes the union (window_union_plain): the 2k entries
//     [pass 1, pass 2], every later occurrence of an index at 3e38, the k
//     smallest by (value, index) (equal keys are equal entries), values at or
//     above 3e38 as +inf. A pass-1 padding entry (3e38, the clipped index of
//     position 0 or N - 1) thus shadows a pass-2 neighbour of that index, as
//     in JAX. A thread merges the two rows of K <= 16 by insertion; a warp
//     places each entry of two rows of neighbours below 3e38 by its rank
//     (binary searches in shared memory), and sorts the 2k entries twice, as
//     the plain version does, when a row holds 3e38 or equal values.
//
// morton_window_kernel is the first design, one thread a position
// reading the Morton-sorted copies the caller gathered, kept for timing.
//
// The window kernels are built at K = 1 .. 16, 32, 64 and 128 (best_k.cuh);
// above 16 a request for k runs the smallest K >= k and writes the first k
// entries of the list. Every entry point launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() (or the first error) so
// the caller can raise on a refused launch.

#include <cuda_runtime.h>

#include "best_k.cuh"
#include "warp_sort.cuh"

namespace {

using spt::kEmptyKey;
using spt::key_hi;
using spt::key_lo;
using spt::pack_key;

constexpr int kThreads = 128;
constexpr float kBig = 3.0e38f;
constexpr float kFltMax = 3.40282346638528859812e+38f;
constexpr unsigned kInfBits = 0x7f800000u;
constexpr int kTileBytesMax = 232448;  // shared memory a block can have (227 KB)
constexpr int kWarps = 8;              // morton_warp_kernel: a block of 8 warps,
constexpr int kWarpPositions = 64;     // 8 sorted positions a warp
constexpr int kCodeThreads = 256;
constexpr int kMinBlocks = 528;        // morton_min's grid: 4 blocks an SM of the H100
// The warp union's rank placement; -DSPT_WINDOW_UNION_SORT_ONLY builds the
// general two-sort path alone, so the two can be timed in turns
// (scripts/bench_window_union.py).
#ifdef SPT_WINDOW_UNION_SORT_ONLY
constexpr bool kRankPlacement = false;
#else
constexpr bool kRankPlacement = true;
#endif

// ---------------------------------------------------------------------------
// The first design
// ---------------------------------------------------------------------------

__device__ __forceinline__ float column(const float* __restrict__ pts, const unsigned char* __restrict__ ok,
                                        int N, int s, bool ok_s, float px, float py, float pz, int o) {
  const int j = s + o;
  if (!(ok_s && j >= 0 && j < N && __ldg(ok + j))) return kBig;
  const float dx = px - __ldg(pts + 3 * j);
  const float dy = py - __ldg(pts + 3 * j + 1);
  const float dz = pz - __ldg(pts + 3 * j + 2);
  return dx * dx + dy * dy + dz * dz;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
morton_window_kernel(const float* __restrict__ pts, const unsigned char* __restrict__ ok,
                     const int* __restrict__ idx_s, int N, int W, int k, int* __restrict__ out_idx,
                     float* __restrict__ out_d2) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= N) return;
  const bool ok_s = __ldg(ok + s);
  const float px = __ldg(pts + 3 * s), py = __ldg(pts + 3 * s + 1), pz = __ldg(pts + 3 * s + 2);

  float bd[K];
  int bi[K];
  best_k_init<K>(bd, bi);
  for (int c = 0; c < 2 * W; ++c) {
    const int o = c < W ? c - W : c - W + 1;
    best_k_insert<K>(bd, bi, column(pts, ok, N, s, ok_s, px, py, pz, o), o);
  }

  const int kw = spt::row_count<K>(k);
  const long long row = static_cast<long long>(__ldg(idx_s + s)) * kw;
  int* oi = out_idx + row;
  float* od = out_d2 + row;
  int t = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (j < kw && bd[j] < __int_as_float(0x7f800000)) {
      oi[j] = __ldg(idx_s + min(max(s + bi[j], 0), N - 1));
      od[j] = bd[j];
      t = j + 1;
    }
  }
  for (int c = 0; c < 2 * W && t < kw; ++c) {
    const int o = c < W ? c - W : c - W + 1;
    const float d = column(pts, ok, N, s, ok_s, px, py, pz, o);
    if (!(d < __int_as_float(0x7f800000))) {
      oi[t] = __ldg(idx_s + min(max(s + o, 0), N - 1));
      od[t] = d;
      ++t;
    }
  }
}

// ---------------------------------------------------------------------------
// The codes
// ---------------------------------------------------------------------------

// The cell of row n as morton_codes computes it: floor(p * inv) in f32,
// clamped before the int cast; returns whether the row is valid with every
// scaled coordinate finite.
__device__ __forceinline__ bool row_cell(const float* __restrict__ pts, const unsigned char* __restrict__ mask,
                                         int n, float inv, int (&c)[3]) {
  bool fin = __ldg(mask + n) != 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float s = __ldg(pts + 3ll * n + a) * inv;
    fin = fin && isfinite(s);
    c[a] = static_cast<int>(fminf(fmaxf(floorf(s), -2147483648.0f), 2147483520.0f));
  }
  return fin;
}

// Spread the low 10 bits to every 3rd bit position.
__device__ __forceinline__ unsigned spread10(unsigned v) {
  v &= 0x3FFu;
  v = (v | (v << 16)) & 0x030000FFu;
  v = (v | (v << 8)) & 0x0300F00Fu;
  v = (v | (v << 4)) & 0x030C30C3u;
  v = (v | (v << 2)) & 0x09249249u;
  return v;
}

// The per-axis minimum of where(finite, cell, 2^30) over every row, as the
// order-preserving unsigned key v ^ 2^31, atomicMin'd into cmin (set to all
// ones before). A few blocks stride over the cloud; a block reduces through
// its warps and takes one atomic an axis.
__global__ void __launch_bounds__(kCodeThreads)
morton_min_kernel(const float* __restrict__ pts, const unsigned char* __restrict__ mask, int N, float inv,
                  unsigned* __restrict__ cmin) {
  __shared__ unsigned part[kCodeThreads / 32][3];
  unsigned m[3] = {~0u, ~0u, ~0u};
  for (int n = blockIdx.x * blockDim.x + threadIdx.x; n < N; n += gridDim.x * blockDim.x) {
    int c[3];
    const bool fin = row_cell(pts, mask, n, inv, c);
#pragma unroll
    for (int a = 0; a < 3; ++a) m[a] = min(m[a], static_cast<unsigned>(fin ? c[a] : 1 << 30) ^ 0x80000000u);
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const unsigned w = __reduce_min_sync(0xffffffffu, m[a]);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5][a] = w;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    unsigned w = ~0u;
#pragma unroll
    for (int i = 0; i < kCodeThreads / 32; ++i) w = min(w, part[i][threadIdx.x]);
    if (w != ~0u) atomicMin(cmin + threadIdx.x, w);
  }
}

__device__ __forceinline__ unsigned pick3(const unsigned (&v)[3], int a) {
  return a == 0 ? v[0] : a == 1 ? v[1] : v[2];
}

// Each pass p's codes [n_pass, N]: axes (orders >> 6p) & 3, >> 2 & 3, >> 4 & 3
// own the interleave's bits 0, 1, 2; invalid or non-finite rows 2^31 - 1.
__global__ void __launch_bounds__(kCodeThreads)
morton_codes_kernel(const float* __restrict__ pts, const unsigned char* __restrict__ mask, int N, float inv,
                    const unsigned* __restrict__ cmin, int orders, int n_pass, int* __restrict__ codes) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  int c[3];
  const bool fin = row_cell(pts, mask, n, inv, c);
  unsigned rel[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    // c - cmin wraps in int32 as the plain version's does
    const int r = static_cast<int>(static_cast<unsigned>(c[a]) - (__ldg(cmin + a) ^ 0x80000000u));
    rel[a] = static_cast<unsigned>(min(max(r, 0), 1023));
  }
  for (int p = 0; p < n_pass; ++p) {
    const int o = orders >> (6 * p);
    const unsigned code = spread10(pick3(rel, o & 3)) | (spread10(pick3(rel, (o >> 2) & 3)) << 1) |
                          (spread10(pick3(rel, (o >> 4) & 3)) << 2);
    codes[static_cast<long long>(p) * N + n] = fin ? static_cast<int>(code) : 0x7fffffff;
  }
}

// ---------------------------------------------------------------------------
// The window kernels
// ---------------------------------------------------------------------------

// Sorted position p as a block stages it: x, y, z and the original index of
// the clipped position, complemented where the point is invalid or p is off
// [0, N). order != nullptr: the gather form (the cloud and mask in the
// original order, order the sort's permutation); else the sorted copies and
// their indices idx_s.
__device__ __forceinline__ float4 stage_position(const float* __restrict__ pts, const unsigned char* __restrict__ ok,
                                                 const int* __restrict__ idx_s, const long long* __restrict__ order,
                                                 int N, long long p) {
  const int pc = static_cast<int>(min(max(p, 0ll), static_cast<long long>(N - 1)));
  const int at = order != nullptr ? static_cast<int>(__ldg(order + pc)) : pc;
  const int id = order != nullptr ? at : __ldg(idx_s + pc);
  const bool valid = p >= 0 && p < N && __ldg(ok + at);
  return make_float4(__ldg(pts + 3ll * at), __ldg(pts + 3ll * at + 1), __ldg(pts + 3ll * at + 2),
                     __int_as_float(valid ? id : ~id));
}

__device__ __forceinline__ bool staged_valid(float4 v) { return __float_as_int(v.w) >= 0; }

__device__ __forceinline__ int staged_index(float4 v) {
  const int w = __float_as_int(v.w);
  return w >= 0 ? w : ~w;
}

// JAX's column of offset o (-W .. -1, then 1 .. W), and back.
__device__ __forceinline__ int column_of(int o, int W) { return o < 0 ? o + W : o + W - 1; }
__device__ __forceinline__ int offset_of(int c, int W) { return c < W ? c - W : c - W + 1; }

__device__ __forceinline__ float column_value(float4 me, bool ok_me, float4 q) {
  if (!(ok_me && staged_valid(q))) return kBig;
  const float dx = me.x - q.x;
  const float dy = me.y - q.y;
  const float dz = me.z - q.z;
  return dx * dx + dy * dy + dz * dz;
}

// A column's key: its value's bits (+inf's for a non-finite value) over the
// column.
__device__ __forceinline__ unsigned long long column_key(float d, int c) {
  return pack_key(d <= kFltMax ? __float_as_uint(d) : kInfBits, static_cast<unsigned>(c));
}

// Slot value of a list key: the key's value, or the column's own (inf or
// NaN) for a non-finite one.
__device__ __forceinline__ float key_value(unsigned long long key, const float4* ctr, float4 me, bool ok_me, int W) {
  return key_hi(key) == kInfBits ? column_value(me, ok_me, ctr[offset_of(static_cast<int>(key_lo(key)), W)])
                                 : __uint_as_float(key_hi(key));
}

__device__ __forceinline__ unsigned long long union_key(float v, int idx) {
  return pack_key(__float_as_uint(v), static_cast<unsigned>(idx));
}

template <int K>
__device__ __forceinline__ void insert_key(unsigned long long (&bk)[K], unsigned long long key) {
#pragma unroll
  for (int j = K - 1; j > 0; --j) {
    if (key < bk[j]) bk[j] = key < bk[j - 1] ? bk[j - 1] : key;
  }
  if (key < bk[0]) bk[0] = key;
}

// Column c's candidate into the list if its key is among the K smallest;
// dlast is the list's last value: most candidates fail the one float compare.
template <int K>
__device__ __forceinline__ void window_insert(unsigned long long (&bk)[K], float& dlast, float d, int c) {
  const float dm = d <= kFltMax ? d : __uint_as_float(kInfBits);  // NaN keys as +inf
  if (dm <= dlast) {
    insert_key<K>(bk, pack_key(__float_as_uint(dm), static_cast<unsigned>(c)));
    dlast = __uint_as_float(key_hi(bk[K - 1]));
  }
}

// Row j of a thread's result: index and value at slot j (K even: two slots a
// store, the row being 8-byte aligned).
template <int K, class Slot>
__device__ __forceinline__ void store_row(int* out_idx, float* out_d2, long long row, Slot slot) {
  if constexpr (K % 2 == 0) {
#pragma unroll
    for (int j = 0; j < K; j += 2) {
      int i0, i1;
      float d0, d1;
      slot(j, &i0, &d0);
      slot(j + 1, &i1, &d1);
      reinterpret_cast<int2*>(out_idx + row)[j / 2] = make_int2(i0, i1);
      reinterpret_cast<float2*>(out_d2 + row)[j / 2] = make_float2(d0, d1);
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) slot(j, out_idx + row + j, out_d2 + row + j);
  }
}

template <int K, bool kUnion>
__global__ void __launch_bounds__(kThreads)
morton_tile_kernel(const float* __restrict__ pts, const unsigned char* __restrict__ ok,
                   const int* __restrict__ idx_s, const long long* __restrict__ order, int N, int W, int to_inf,
                   const int* __restrict__ prev_idx, const float* __restrict__ prev_d2, int* __restrict__ out_idx,
                   float* __restrict__ out_d2) {
  extern __shared__ float4 tile[];
  const int s0 = blockIdx.x * kThreads;
  const int span = kThreads + 2 * W;
  for (int t = threadIdx.x; t < span; t += kThreads)
    tile[t] = stage_position(pts, ok, idx_s, order, N, static_cast<long long>(s0) - W + t);
  __syncthreads();
  if (s0 + static_cast<int>(threadIdx.x) >= N) return;
  const float4* const ctr = tile + threadIdx.x + W;
  const float4 me = ctr[0];
  const bool ok_me = staged_valid(me);

  unsigned long long bk[K];
  if (!ok_me) {
    // every column at 3e38: the first K columns
#pragma unroll
    for (int j = 0; j < K; ++j) bk[j] = pack_key(__float_as_uint(kBig), j);
  } else {
    // the first K offsets, +1, -1, +2, -2, ..., each sorted in by i
    // compare-exchanges (2 W >= K keeps them inside the window)
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int o = (i & 1) ? -((i >> 1) + 1) : (i >> 1) + 1;
      bk[i] = column_key(column_value(me, true, ctr[o]), column_of(o, W));
#pragma unroll
      for (int j = i; j > 0; --j) {
        const unsigned long long lo = bk[j] < bk[j - 1] ? bk[j] : bk[j - 1];
        bk[j] = bk[j] < bk[j - 1] ? bk[j - 1] : bk[j];
        bk[j - 1] = lo;
      }
    }
    float dlast = __uint_as_float(key_hi(bk[K - 1]));
    // the rest, nearest first: +q above (K + 1) / 2, -q above K / 2
    for (int q = K / 2 + 1; q <= W; ++q) {
      if (q > (K + 1) / 2) window_insert<K>(bk, dlast, column_value(me, true, ctr[q]), column_of(q, W));
      window_insert<K>(bk, dlast, column_value(me, true, ctr[-q]), column_of(-q, W));
    }
  }

  const long long row = static_cast<long long>(staged_index(me)) * K;
  if constexpr (!kUnion) {
    store_row<K>(out_idx, out_d2, row, [&](int j, int* i, float* d) {
      const float v = key_value(bk[j], ctr, me, ok_me, W);
      *i = staged_index(ctr[offset_of(static_cast<int>(key_lo(bk[j])), W)]);
      *d = to_inf && v >= kBig ? __uint_as_float(kInfBits) : v;
    });
  } else {
    // pass 2's entries first, so that the list's registers are free
    int i1[K], i2[K];
    float d2[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      d2[j] = key_value(bk[j], ctr, me, ok_me, W);
      i2[j] = staged_index(ctr[offset_of(static_cast<int>(key_lo(bk[j])), W)]);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) i1[j] = __ldg(prev_idx + row + j);
    unsigned long long u[K];
#pragma unroll
    for (int j = 0; j < K; ++j) u[j] = kEmptyKey;
    // [pass 1, pass 2]: an entry whose index came before is a duplicate, at 3e38
#pragma unroll
    for (int j = 0; j < K; ++j) {
      bool dup = false;
#pragma unroll
      for (int i = 0; i < j; ++i) dup = dup || i1[i] == i1[j];
      insert_key<K>(u, union_key(dup ? kBig : __ldg(prev_d2 + row + j), i1[j]));
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      bool dup = false;
#pragma unroll
      for (int i = 0; i < K; ++i) dup = dup || i1[i] == i2[j];
#pragma unroll
      for (int i = 0; i < j; ++i) dup = dup || i2[i] == i2[j];
      insert_key<K>(u, union_key(dup ? kBig : d2[j], i2[j]));
    }
    store_row<K>(out_idx, out_d2, row, [&](int j, int* i, float* d) {
      const float v = __uint_as_float(key_hi(u[j]));
      *i = static_cast<int>(key_lo(u[j]));
      *d = v >= kBig ? __uint_as_float(kInfBits) : v;
    });
  }
}

// Shared memory a warp of the union form takes: two rows of K keys and K + 1
// counts, rounded to 8 bytes.
__host__ __device__ constexpr int union_bytes(int K) { return 16 * K + 4 * (K + 2); }

// The entries of the ascending a[0, n) below key (n <= 255).
__device__ __forceinline__ int lower_bound(const unsigned long long* a, int n, unsigned long long key) {
  int lo = 0;
#pragma unroll
  for (int step = 128; step > 0; step >>= 1)
    if (lo + step <= n && a[lo + step - 1] < key) lo += step;
  return lo;
}

template <int K, bool kUnion>
__global__ void __launch_bounds__(32 * kWarps, 1)
morton_warp_kernel(const float* __restrict__ pts, const unsigned char* __restrict__ ok,
                   const int* __restrict__ idx_s, const long long* __restrict__ order, int N, int W, int k,
                   int to_inf, const int* __restrict__ prev_idx, const float* __restrict__ prev_d2,
                   int* __restrict__ out_idx, float* __restrict__ out_d2) {
  constexpr int P = K / 32;  // list keys a lane
  extern __shared__ float4 tile[];
  const int s0 = blockIdx.x * kWarpPositions;
  const int span = kWarpPositions + 2 * W;
  for (int t = threadIdx.x; t < span; t += blockDim.x)
    tile[t] = stage_position(pts, ok, idx_s, order, N, static_cast<long long>(s0) - W + t);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the union's keys a warp: pass 1's row (K), pass 2's (K, right after, so
  // that entry p of [pass 1, pass 2] is k1[p]), then the kept counts
  unsigned long long* const k1 = reinterpret_cast<unsigned long long*>(
      reinterpret_cast<char*>(tile + span) + warp * union_bytes(K));
  unsigned long long* const k2 = k1 + K;
  int* const kept = reinterpret_cast<int*>(k2 + K);
  const int n_col = 2 * W;

  for (int pos = warp; pos < kWarpPositions && s0 + pos < N; pos += kWarps) {
    const float4* const ctr = tile + pos + W;
    const float4 me = ctr[0];
    const bool ok_me = staged_valid(me);
    // the columns K at a time, nearest first: visit v is offset +(v/2 + 1)
    // for even v, -(v/2 + 1) for odd
    unsigned long long L[P];
    for (int v0 = 0; v0 < n_col; v0 += K) {
      const unsigned long long last = v0 ? spt::warp_last<P>(L) : kEmptyKey;
      unsigned long long C[P];
      bool any = false;
#pragma unroll
      for (int r = 0; r < P; ++r) {
        const int v = v0 + lane * P + r;
        C[r] = kEmptyKey;
        if (v < n_col) {
          const int o = (v & 1) ? -((v >> 1) + 1) : (v >> 1) + 1;
          const unsigned long long key = column_key(column_value(me, ok_me, ctr[o]), column_of(o, W));
          if (key < last) {
            C[r] = key;
            any = true;
          }
        }
      }
      if (v0 == 0) {
        spt::warp_sort<P>(C);
#pragma unroll
        for (int r = 0; r < P; ++r) L[r] = C[r];
      } else if (__any_sync(0xffffffffu, any)) {
        spt::warp_sort<P>(C);
        spt::warp_merge<P>(L, C);
      }
    }

    const long long row = static_cast<long long>(staged_index(me)) * k;
    if constexpr (!kUnion) {
#pragma unroll
      for (int r = 0; r < P; ++r) {
        const int i = lane * P + r;
        if (i < k) {
          const float d = key_value(L[r], ctr, me, ok_me, W);
          out_idx[row + i] = staged_index(ctr[offset_of(static_cast<int>(key_lo(L[r])), W)]);
          out_d2[row + i] = to_inf && d >= kBig ? __uint_as_float(kInfBits) : d;
        }
      }
    } else {
      // both rows as keys (value bits << 32 | index): pass 1's from its row,
      // pass 2's from the list
#pragma unroll
      for (int r = 0; r < P; ++r) {
        const int i = lane * P + r;
        if (i < k) {
          k1[i] = pack_key(__float_as_uint(__ldg(prev_d2 + row + i)), static_cast<unsigned>(__ldg(prev_idx + row + i)));
          k2[i] = pack_key(__float_as_uint(key_value(L[r], ctr, me, ok_me, W)),
                           static_cast<unsigned>(staged_index(ctr[offset_of(static_cast<int>(key_lo(L[r])), W)])));
        }
      }
      __syncwarp();
      // The common case: every entry a neighbour below 3e38, no two of a row at
      // one value. Each row then ascends by key and holds distinct indices, and
      // pass 2's duplicates are the keys pass 1 holds too (a point's distance
      // is the same in both passes): the union is the k smallest keys of pass
      // 1 and of pass 2 without its duplicates, each placed by its rank.
      bool common = true;
#pragma unroll
      for (int r = 0; r < P; ++r) {
        const int i = lane * P + r;
        if (i < k) {
          common = common && key_hi(k1[i]) < __float_as_uint(kBig) && key_hi(k2[i]) < __float_as_uint(kBig);
          if (i > 0) common = common && key_hi(k1[i - 1]) != key_hi(k1[i]) && key_hi(k2[i - 1]) != key_hi(k2[i]);
        }
      }
      if (kRankPlacement && __all_sync(0xffffffffu, common)) {
        unsigned keep = 0;
        int n_keep = 0;
#pragma unroll
        for (int r = 0; r < P; ++r) {
          const int i = lane * P + r;
          if (i < k) {
            const int at = lower_bound(k1, k, k2[i]);
            const bool kept = !(at < k && k1[at] == k2[i]);
            keep |= static_cast<unsigned>(kept) << r;
            n_keep += kept;
          }
        }
        // kept[i]: pass 2's kept entries before entry i (an exclusive scan)
        int incl = n_keep;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, incl, d);
          if (lane >= d) incl += y;
        }
        int before = incl - n_keep;
#pragma unroll
        for (int r = 0; r < P; ++r) {
          kept[lane * P + r] = before;
          before += (keep >> r) & 1u;
        }
        if (lane == 31) kept[32 * P] = incl;
        __syncwarp();
#pragma unroll
        for (int r = 0; r < P; ++r) {
          const int i = lane * P + r;
          if (i < k) {
            const int r1 = i + kept[lower_bound(k2, k, k1[i])];
            if (r1 < k) {
              out_idx[row + r1] = static_cast<int>(key_lo(k1[i]));
              out_d2[row + r1] = __uint_as_float(key_hi(k1[i]));
            }
            const int r2 = kept[i] + lower_bound(k1, k, k2[i]);
            if ((keep >> r) & 1u && r2 < k) {
              out_idx[row + r2] = static_cast<int>(key_lo(k2[i]));
              out_d2[row + r2] = __uint_as_float(key_hi(k2[i]));
            }
          }
        }
      } else {
        // The general case, as the plain version: sort the 2k entries by
        // (index, entry), so a duplicate follows an entry of its index ...
        unsigned long long E[2 * P];
#pragma unroll
        for (int r = 0; r < 2 * P; ++r) {
          const int p = lane * 2 * P + r;
          E[r] = (p % K) < k ? pack_key(key_lo(k1[p]), static_cast<unsigned>(p)) : kEmptyKey;
        }
        spt::warp_sort<2 * P>(E);
        const unsigned long long up = __shfl_up_sync(0xffffffffu, E[2 * P - 1], 1);
        unsigned dup = 0;
#pragma unroll
        for (int r = 0; r < 2 * P; ++r) {
          const unsigned long long prior = r ? E[r - 1] : (lane ? up : kEmptyKey);
          dup |= static_cast<unsigned>(key_hi(prior) == key_hi(E[r])) << r;
        }
        // ... then by (value, index), the duplicates at 3e38
#pragma unroll
        for (int r = 0; r < 2 * P; ++r) {
          if (E[r] != kEmptyKey)
            E[r] = union_key((dup >> r) & 1u ? kBig : __uint_as_float(key_hi(k1[key_lo(E[r])])),
                             static_cast<int>(key_hi(E[r])));
        }
        spt::warp_sort<2 * P>(E);
#pragma unroll
        for (int r = 0; r < 2 * P; ++r) {
          const int i = lane * 2 * P + r;
          if (i < k) {
            const float v = __uint_as_float(key_hi(E[r]));
            out_idx[row + i] = static_cast<int>(key_lo(E[r]));
            out_d2[row + i] = v >= kBig ? __uint_as_float(kInfBits) : v;
          }
        }
      }
      __syncwarp();  // the next position reuses the keys
    }
  }
}

template <int K, bool kUnion>
int launch_window(const float* pts, const unsigned char* ok, const int* idx_s, const long long* order, int N, int W,
                  int k, int to_inf, const int* prev_idx, const float* prev_d2, int* out_idx, float* out_d2,
                  cudaStream_t s) {
  constexpr bool kWarp = K > spt::kFastK;
  const int positions = kWarp ? kWarpPositions : kThreads;
  const long long smem = (static_cast<long long>(positions) + 2ll * W) * sizeof(float4) +
                         (kWarp && kUnion ? kWarps * static_cast<long long>(union_bytes(K)) : 0);
  if (smem > kTileBytesMax) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (N + positions - 1) / positions;
  if constexpr (kWarp) {
    auto kern = morton_warp_kernel<K, kUnion>;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kern<<<blocks, 32 * kWarps, smem, s>>>(pts, ok, idx_s, order, N, W, k, to_inf, prev_idx, prev_d2, out_idx,
                                            out_d2);
  } else {
    auto kern = morton_tile_kernel<K, kUnion>;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kern<<<blocks, kThreads, smem, s>>>(pts, ok, idx_s, order, N, W, to_inf, prev_idx, prev_d2, out_idx, out_d2);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kUnion>
int window_entry(const float* pts, const unsigned char* ok, const int* idx_s, const long long* order, int N, int W,
                 int k, int to_inf, const int* prev_idx, const float* prev_d2, int* out_idx, float* out_d2,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0) return static_cast<int>(cudaSuccess);
  if (W <= 0 || 2 * W < k) return static_cast<int>(cudaErrorInvalidValue);
#define SPT_WINDOW_TILE_CASE(KK)                                                                             \
  case KK:                                                                                                   \
    return launch_window<KK, kUnion>(pts, ok, idx_s, order, N, W, k, to_inf, prev_idx, prev_d2, out_idx, \
                                     out_d2, s);
  switch (spt::instance_k(k)) {
    SPT_K_CASES(SPT_WINDOW_TILE_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SPT_WINDOW_TILE_CASE
}

}  // namespace

#define SPT_WINDOW_CASE(KK)                                                                          \
  case KK:                                                                                           \
    morton_window_kernel<KK><<<blocks, kThreads, 0, s>>>(pts, ok, idx_s, N, W, k, out_idx, out_d2); \
    break;

// The first design. pts [N,3] f32 and ok [N] bool in Morton order, idx_s [N]
// i32 the original index of each sorted position (a permutation); W the
// one-sided window, 2 W >= k; out_idx [N,k] i32 and out_d2 [N,k] f32 in the
// ORIGINAL order; 1 <= k <= 128.
extern "C" int spt_morton_window_simple(const float* pts, const unsigned char* ok, const int* idx_s, int N, int W,
                                        int k, int* out_idx, float* out_d2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (N + kThreads - 1) / kThreads;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  if (W <= 0 || 2 * W < k) return static_cast<int>(cudaErrorInvalidValue);
  switch (spt::instance_k(k)) {
    SPT_K_CASES(SPT_WINDOW_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// One window pass on sorted copies, as spt_morton_window_simple takes them:
// the rows of the first design, from the tiled kernels.
extern "C" int spt_morton_window(const float* pts, const unsigned char* ok, const int* idx_s, int N, int W, int k,
                                 int* out_idx, float* out_d2, void* stream) {
  return window_entry<false>(pts, ok, idx_s, nullptr, N, W, k, 0, nullptr, nullptr, out_idx, out_d2, stream);
}

// One window pass of the cloud pts [N,3] f32 / mask [N] bool, read in the
// order of order [N] i64 (the sort's permutation): rows in the original
// order, 3e38 slots kept, or (to_inf) written as +inf. With prev_idx /
// prev_d2 (pass 1's rows [N,k], 3e38 kept) it writes the union of the two
// passes instead, +inf for 3e38.
extern "C" int spt_morton_window_gather(const float* pts, const unsigned char* mask, const long long* order, int N,
                                        int W, int k, int to_inf, const int* prev_idx, const float* prev_d2,
                                        int* out_idx, float* out_d2, void* stream) {
  if (prev_idx != nullptr)
    return window_entry<true>(pts, mask, nullptr, order, N, W, k, 1, prev_idx, prev_d2, out_idx, out_d2, stream);
  return window_entry<false>(pts, mask, nullptr, order, N, W, k, to_inf, nullptr, nullptr, out_idx, out_d2, stream);
}

// The per-axis minimum cell of pts [N,3] / mask [N] at 1 / cell = inv into
// cmin [3] (a memset, then morton_min_kernel).
extern "C" int spt_morton_min(const float* pts, const unsigned char* mask, int N, float inv, unsigned* cmin,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(cmin, 0xff, 3 * sizeof(unsigned), s);
  if (err != cudaSuccess || N <= 0) return static_cast<int>(err);
  const int blocks = N < kMinBlocks * kCodeThreads ? (N + kCodeThreads - 1) / kCodeThreads : kMinBlocks;
  morton_min_kernel<<<blocks, kCodeThreads, 0, s>>>(pts, mask, N, inv, cmin);
  return static_cast<int>(cudaGetLastError());
}

// The codes [n_pass, N] i32 of n_pass (1 or 2) axis orders, packed 6 bits a
// pass (2 bits an axis), against the minimum spt_morton_min wrote.
extern "C" int spt_morton_codes(const float* pts, const unsigned char* mask, int N, float inv, const unsigned* cmin,
                                int orders, int n_pass, int* codes, void* stream) {
  if (N <= 0) return static_cast<int>(cudaSuccess);
  if (n_pass < 1 || n_pass > 2) return static_cast<int>(cudaErrorInvalidValue);
  morton_codes_kernel<<<(N + kCodeThreads - 1) / kCodeThreads, kCodeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pts, mask, N, inv, cmin, orders, n_pass, codes);
  return static_cast<int>(cudaGetLastError());
}
