// The coarse-to-fine candidate search for Hopper (sm_90a), plain C interface:
// the cell ranking and the candidate refine of CoarseKNN.search.
//
// These kernels replace the search of the JAX package's CoarseKNN
// (sycl_points_tpu/ops/coarse_knn.py:137-188, CoarseKNN.search): JAX ranks
// the cells of each query from a [q, C] lower-bound matrix (one f32 matrix
// product) and lax.top_k, gathers a [q, P, L] candidate block from the P
// selected cells, takes an argmin or top_k over it in XLA ops, and certifies
// the result against the unexplored cells' lower bound. It is not a Pallas
// kernel, so they port no TPU kernel: they are the sub-linear search that JAX
// built in place of the reference's KD-tree, for targets too large for brute
// force.
//
// coarse_rank: the P + 1 best cells of each query. For query q and cell c the
// bound is max(sqrt(max(q2 + c2 - 2 q.c, 0)) - radius - margin, 0), +inf for
// an empty cell, with q2 = (x x + y y) + z z, c2 likewise and q.c = (qx cx +
// qy cy) + qz cz, each operation rounded once (_rn intrinsics; the library
// is built with --fmad=false): ops/coarse_knn.rank_cells_plain's arithmetic,
// so the two agree bit for bit. The keys are (bound bits << 32 | c) as signed
// 64-bit integers, the plain version's int64 keys: unique, so the P + 1
// smallest are lax.top_k's order, the lower cell first on ties. Written:
// cells [Q, P] and lb_unexplored [Q], the (P + 1)-th key's bound (+inf when
// P = C: every cell selected).
//   What bounds it on the card: Q x C' bounds of ~20 FP32 operations (the
//   sqrt's sequence included) against 20 B a cell, C' the cells that can
//   hold a point. The build numbers the occupied cells 0 .. n - 1 (segment
//   ids run in sorted order) and records n (CoarseKNN.occupied), so the
//   kernel ranks only those: the cells from n on are all empty, their keys
//   (+inf, c) ascend with c, and the first take of them join the selection
//   as the plain version's ties among +inf bounds would.
//   The design: a warp a query, 16 queries a block sharing each staged tile
//   of 1,024 cells (x, y, z, c2, radius, index) in shared memory. The warp
//   keeps the take = P + 1 smallest keys as one sorted list spread over its
//   lanes (R keys a lane, entry r * 32 + lane, R = 1, 2 or 4 for take up to
//   32, 64 or 128). Each lane computes the key of a cell; a ballot finds the
//   keys below the list's last entry, and each such key goes in by one
//   shuffle-shift of the list (a few instructions for the whole warp). The
//   cells are numbered x-major, so in index order a query would insert at
//   nearly every x-slab it nears; the first tile is therefore a seed of up
//   to 1,024 cells in a scrambled order (i p mod n, p prime), which leaves
//   the list's last entry near the final one after a few dozen insertions;
//   then every cell in index order (a seed cell offered again finds its key
//   held and is turned away). Most cells cost their bound and one compare.
//
// coarse_refine: the k nearest of each query among its P selected cells'
// first L points, and the certificate. Slot s = p L + l for lane l < L of the
// p-th selected cell (JAX's candidate order), a candidate when l < count,
// the cell is occupied and the point unmasked, at position clip(start + l,
// 0, M - 1); d2 = dx*dx + dy*dy + dz*dz, dx = point - query. The k smallest
// by (d2, s), then JAX's padding: the first slots without a finite candidate,
// at +inf. Then the certificate: sqrt(k-th d2) <= the unexplored bound,
// every selected cell holds at most L points, and the build lost no cell and
// no point. Indices refer to the target's SORTED layout, as JAX's do.
//   What bounds it on the card: per query up to P L candidate points (16 B
//   each with the mask; the selected cells of neighbouring queries overlap,
//   so most come from L2) and ~9 FP32 operations each: the FP32 lanes over
//   the candidates this run's data holds.
//   coarse_refine_simple_kernel<K>, the first design (kept as the reference
//   the new one is timed against): one thread a query walks the P cells and
//   their lanes in slot order with the strict-`<` list of best_k.cuh, then
//   walks the slots again for the padding. At a dense cell's budget one
//   thread walks thousands of points alone.
//   coarse_refine_lanes_kernel<K, G>, the design for this card: G lanes a
//   query (ops/cuda_knn.refine_lanes: 32 up to k = 16, fewer only where P L
//   is small, since the queries beside a dense cell walk thousands of
//   points and bound the launch; 8 above 16, where each lane fills a long
//   list), the lane-group search of lane_knn.cuh over the P cells' slots (W
//   = L): lane l loads the selected cells l, l + G, ... (start, count,
//   occupied), the group takes the prefix of n = min(count, L) over them,
//   and the lanes stride the cells' contiguous slices, so a warp reads
//   consecutive 12-byte rows. Each lane keeps its K best by (d2, s), the lanes
//   merge by that pair, and the padding is ranked by ballots and popcounts.
//   A group keeps its cells' starts and prefixes (2 P + 1 ints) and its first
//   K non-finite candidates in shared memory.
// Both refines are built at K = 1 .. 16; the lane-group refine also at 32,
// 64 and 128 (best_k.cuh), where it writes the first k entries of its list.
//
// The entry points launch on the caller's stream, allocate nothing, and
// return cudaGetLastError() (or the error of cudaFuncSetAttribute) so the
// caller can raise on a refused launch.

#include <cuda_runtime.h>

#include "best_k.cuh"
#include "lane_knn.cuh"

namespace {

constexpr int kThreads = 128;       // the first refine design
constexpr int kLaneThreads = 256;   // the lane-group refine
constexpr int kRankThreads = 512;   // the ranking: a warp a query
constexpr int kRankWarps = kRankThreads / 32;
constexpr int kRankTile = 1024;     // cells staged a step
constexpr int kMaxSmem = 232448;    // 227 KB, a block's limit on sm_90
constexpr long long kKeyMax = 0x7fffffffffffffffll;
constexpr unsigned kFull = 0xffffffffu;

template <int K>
__global__ void __launch_bounds__(kThreads)
coarse_refine_simple_kernel(const float* __restrict__ queries, int Q, const int* __restrict__ cells, int P,
                            const float* __restrict__ lb_unexplored, const float* __restrict__ pts,
                            const unsigned char* __restrict__ pmask, int M, const int* __restrict__ starts,
                            const int* __restrict__ counts, const unsigned char* __restrict__ cvalid, int L,
                            const int* __restrict__ cells_lost, const int* __restrict__ points_lost,
                            int* __restrict__ out_idx, float* __restrict__ out_d2,
                            unsigned char* __restrict__ certified) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  const float qx = __ldg(queries + 3 * q), qy = __ldg(queries + 3 * q + 1), qz = __ldg(queries + 3 * q + 2);
  const int* my_cells = cells + static_cast<long long>(q) * P;

  float bd[K];
  int bi[K];
  best_k_init<K>(bd, bi);
  bool complete = true;
  for (int c = 0; c < P; ++c) {
    const int cell = __ldg(my_cells + c);
    const int start = __ldg(starts + cell), count = __ldg(counts + cell);
    complete = complete && count <= L;
    if (!__ldg(cvalid + cell)) continue;
    const int n = min(count, L);
    for (int l = 0; l < n; ++l) {
      const int p = min(max(start + l, 0), M - 1);
      if (!__ldg(pmask + p)) continue;
      const float dx = __ldg(pts + 3 * p) - qx;
      const float dy = __ldg(pts + 3 * p + 1) - qy;
      const float dz = __ldg(pts + 3 * p + 2) - qz;
      best_k_insert<K>(bd, bi, dx * dx + dy * dy + dz * dz, p);
    }
  }

  int* oi = out_idx + static_cast<long long>(q) * K;
  float* od = out_d2 + static_cast<long long>(q) * K;
  int t = best_k_store<K>(bd, bi, oi, od);
  const float inf = __int_as_float(0x7f800000);
  const float kth = t == K ? bd[K - 1] : inf;
  for (int c = 0; c < P && t < K; ++c) {
    const int cell = __ldg(my_cells + c);
    const int start = __ldg(starts + cell), count = __ldg(counts + cell);
    const bool cell_ok = __ldg(cvalid + cell);
    for (int l = 0; l < L && t < K; ++l) {
      const int p = min(max(start + l, 0), M - 1);
      bool finite = false;
      if (cell_ok && l < count && __ldg(pmask + p)) {
        const float dx = __ldg(pts + 3 * p) - qx;
        const float dy = __ldg(pts + 3 * p + 1) - qy;
        const float dz = __ldg(pts + 3 * p + 2) - qz;
        finite = dx * dx + dy * dy + dz * dz < inf;
      }
      if (!finite) {
        oi[t] = p;
        od[t] = inf;
        ++t;
      }
    }
  }
  certified[q] = sqrtf(kth) <= __ldg(lb_unexplored + q) && complete && __ldg(cells_lost) == 0 &&
                 __ldg(points_lost) == 0;
}

template <int K, int G>
__global__ void __launch_bounds__(kLaneThreads)
coarse_refine_lanes_kernel(const float* __restrict__ queries, int Q, const int* __restrict__ cells, int P,
                           const float* __restrict__ lb_unexplored, const float* __restrict__ pts,
                           const unsigned char* __restrict__ pmask, int M, const int* __restrict__ starts,
                           const int* __restrict__ counts, const unsigned char* __restrict__ cvalid, int L,
                           const int* __restrict__ cells_lost, const int* __restrict__ points_lost, int k,
                           int* __restrict__ out_idx, float* __restrict__ out_d2,
                           unsigned char* __restrict__ certified) {
  constexpr int kGroups = kLaneThreads / G;
  extern __shared__ int smem_i[];
  const int group = threadIdx.x / G;
  const spt::LaneGroup<G> g(threadIdx.x);
  const int q = blockIdx.x * kGroups + group;
  if (q >= Q) return;  // the whole group
  const int kw = spt::row_count<K>(k);
  int* const start = smem_i + group * (2 * P + 1 + K);  // [P] the cells' starts
  int* const pre = start + P;                            // [P + 1] exclusive prefix of n; [P] = T
  int* const nf = pre + P + 1;                           // [K] the first K non-finite candidates
  const float qx = __ldg(queries + 3 * q), qy = __ldg(queries + 3 * q + 1), qz = __ldg(queries + 3 * q + 2);
  const int* my_cells = cells + static_cast<long long>(q) * P;

  // the selected cells, G at a time: start, n and the prefix of n
  int carry = 0;
  bool complete = true;
  for (int p0 = 0; p0 < P; p0 += G) {
    const int p = p0 + g.lane;
    int c_start = 0, n = 0;
    if (p < P) {
      const int cell = __ldg(my_cells + p);
      const int count = __ldg(counts + cell);
      c_start = __ldg(starts + cell);
      complete = complete && count <= L;
      n = __ldg(cvalid + cell) ? min(count, L) : 0;
    }
    const int c_pre = spt::chunk_prefix<G>(n, g, carry);
    if (p < P) {
      start[p] = c_start;
      pre[p] = c_pre;
    }
  }
  complete = __all_sync(g.mask, complete);
  const int T = carry;
  if (g.lane == 0) pre[P] = T;
  __syncwarp(g.mask);

  float bd[K];
  int bs[K];
  const int n_nf = spt::lane_walk<K, G>(T, g, bd, bs, nf, [&](int t, int* o, int* s) {
    return spt::lane_candidate(t, o, pre, start, L, M, pts, pmask, qx, qy, qz, s);
  });
  __syncwarp(g.mask);

  int* oi = out_idx + static_cast<long long>(q) * kw;
  float* od = out_d2 + static_cast<long long>(q) * kw;
  const float inf = __int_as_float(0x7f800000);
  float kth = inf;
  const int n_fin = min(kw, T - n_nf);
  spt::lane_merge<K, G>(bd, bs, n_fin, g, [&](int r, float d, int s) {
    if (r == kw - 1) kth = d;
    if (g.lane == r % G) {
      const int co = s / L;
      oi[r] = min(max(start[co] + s - co * L, 0), M - 1);
      od[r] = d;
    }
  });
  if (n_fin < kw)
    spt::lane_padding<G>(pre, P, L, nf, min(n_nf, K), kw - n_fin, g, [&](int rank, int c, int j) {
      oi[n_fin + rank] = min(max(start[c] + j, 0), M - 1);
      od[n_fin + rank] = inf;
    });
  if (g.lane == 0)
    certified[q] = __fsqrt_rn(kth) <= __ldg(lb_unexplored + q) && complete && __ldg(cells_lost) == 0 &&
                   __ldg(points_lost) == 0;
}

// ((x x + y y) + z z), each operation rounded once.
__device__ __forceinline__ float norm2(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// The plain version's int64 key: the bound's f32 bits (as a signed int32,
// widened) above the cell index.
__device__ __forceinline__ long long rank_key(float lb, int c) {
  return static_cast<long long>((static_cast<unsigned long long>(__float_as_uint(lb)) << 32) |
                                static_cast<unsigned>(c));
}

// Entry e of the warp's list: lane e % 32's register e / 32, to every lane.
template <int R>
__device__ __forceinline__ long long list_entry(const long long (&v)[R], int e) {
  long long x = v[0];
#pragma unroll
  for (int r = 1; r < R; ++r)
    if (r == e / 32) x = v[r];
  return __shfl_sync(kFull, x, e % 32);
}

// Insert key into the warp's ascending list (entry r * 32 + lane in v[r]);
// the last entry falls off. Keys are unique.
template <int R>
__device__ __forceinline__ void list_insert(long long (&v)[R], long long key, int lane) {
  long long prev[R];  // each entry's predecessor
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long up = __shfl_up_sync(kFull, v[r], 1);
    const long long wrap = r > 0 ? __shfl_sync(kFull, v[r > 0 ? r - 1 : 0], 31) : 0;
    prev[r] = lane > 0 ? up : (r > 0 ? wrap : (-kKeyMax - 1));
  }
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = v[r] < key ? v[r] : (prev[r] < key ? key : prev[r]);
}

// Every lane's key into the list if it is below the list's entry take - 1
// (thr, kept up to date). kHeld: a key may be in the list already (the
// seed's cells are offered again by the full scan); the list turns it away.
template <int R, bool kHeld>
__device__ __forceinline__ void list_offer(long long (&v)[R], long long key, int lane, int take, long long& thr) {
  unsigned pending = __ballot_sync(kFull, key < thr);
  while (pending) {
    const int src = __ffs(pending) - 1;
    const long long k = __shfl_sync(kFull, key, src);
    bool held = false;
    if constexpr (kHeld) {
#pragma unroll
      for (int r = 0; r < R; ++r) held |= v[r] == k;
    }
    if (!kHeld || !__any_sync(kFull, held)) {
      list_insert<R>(v, k, lane);
      thr = list_entry<R>(v, take - 1);
    }
    pending &= ~(1u << src);
    pending &= __ballot_sync(kFull, key < thr);
  }
}

// A prime above any cell count: i -> i kScramble mod n permutes [0, n).
constexpr unsigned long long kScramble = 2147483647ull;

template <int R>
__global__ void __launch_bounds__(kRankThreads)
coarse_rank_kernel(const float* __restrict__ queries, int Q, const float* __restrict__ centroids,
                   const float* __restrict__ radii, const unsigned char* __restrict__ cvalid, int C,
                   const int* __restrict__ occupied, float margin, int P, int* __restrict__ out_cells,
                   float* __restrict__ out_lb) {
  __shared__ float4 s_c[kRankTile];  // x, y, z, c2
  __shared__ float s_r[kRankTile];
  __shared__ int s_id[kRankTile];    // the cell's index, -1 when it is empty
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kRankWarps + threadIdx.x / 32;
  const bool live = q < Q;  // a warp past the queries still stages its share
  const int take = P < C ? P + 1 : P;
  const int n = min(max(__ldg(occupied), 0), C);
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (live) {
    qx = __ldg(queries + 3 * q);
    qy = __ldg(queries + 3 * q + 1);
    qz = __ldg(queries + 3 * q + 2);
  }
  const float q2 = norm2(qx, qy, qz);
  const float inf = __int_as_float(0x7f800000);

  // stage cnt cells, the i-th the cell cell_of(i), into the tile
  auto stage = [&](int cnt, auto cell_of) {
    __syncthreads();
    for (int i = threadIdx.x; i < cnt; i += kRankThreads) {
      const int c = cell_of(i);
      const float cx = __ldg(centroids + 3ll * c), cy = __ldg(centroids + 3ll * c + 1),
                  cz = __ldg(centroids + 3ll * c + 2);
      s_c[i] = make_float4(cx, cy, cz, norm2(cx, cy, cz));
      s_r[i] = __ldg(radii + c);
      s_id[i] = __ldg(cvalid + c) ? c : -1 - c;
    }
    __syncthreads();
  };
  // the key of staged cell i
  auto key_of = [&](int i) {
    const float4 c = s_c[i];
    const float qc = __fadd_rn(__fadd_rn(__fmul_rn(qx, c.x), __fmul_rn(qy, c.y)), __fmul_rn(qz, c.z));
    float d2 = __fsub_rn(__fadd_rn(q2, c.w), __fmul_rn(2.0f, qc));
    d2 = d2 < 0.0f ? 0.0f : d2;  // clamp_min: a NaN stays
    float lb = __fsub_rn(__fsub_rn(__fsqrt_rn(d2), s_r[i]), margin);
    lb = lb < 0.0f ? 0.0f : lb;
    const int id = s_id[i];
    return id >= 0 ? rank_key(lb, id) : rank_key(inf, -1 - id);
  };

  long long v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = kKeyMax;
  long long thr = kKeyMax;
  // 1) the seed: the first min(n, kRankTile) cells of a scrambled order, so
  // that the list's last entry is tight after a few dozen insertions
  // whatever the cells' spatial order (in index order, x-major, a query
  // nearing its own slab would insert at nearly every slab)
  const int seed = min(n, kRankTile);
  stage(seed, [&](int i) { return static_cast<int>((static_cast<unsigned long long>(i) * kScramble) % n); });
  if (live)
    for (int i0 = 0; i0 < seed; i0 += 32)
      list_offer<R, false>(v, i0 + lane < seed ? key_of(i0 + lane) : kKeyMax, lane, take, thr);
  // 2) every occupied cell in index order, when the seed did not take them
  // all: only the keys below the tight entry go in
  if (n > kRankTile) {
    for (int c0 = 0; c0 < n; c0 += kRankTile) {
      const int cnt = min(kRankTile, n - c0);
      stage(cnt, [&](int i) { return c0 + i; });
      if (!live) continue;
      for (int i0 = 0; i0 < cnt; i0 += 32)
        list_offer<R, true>(v, i0 + lane < cnt ? key_of(i0 + lane) : kKeyMax, lane, take, thr);
    }
  }
  if (!live) return;
  // the empty cells from n on, +inf bounds in index order: the first take
  for (int c0 = n; c0 < min(C, n + take); c0 += 32) {
    const int c = c0 + lane;
    list_offer<R, false>(v, c < min(C, n + take) ? rank_key(inf, c) : kKeyMax, lane, take, thr);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = r * 32 + lane;
    if (e < P) out_cells[static_cast<long long>(q) * P + e] = static_cast<int>(v[r] & 0xffffffffll);
  }
  const long long last = list_entry<R>(v, min(P, take - 1));
  if (lane == 0) out_lb[q] = P < C ? __int_as_float(static_cast<int>(last >> 32)) : inf;
}

template <int K, int G>
cudaError_t launch_refine_lanes(int Q, const float* queries, const int* cells, int P, const float* lb_unexplored,
                                const float* pts, const unsigned char* pmask, int M, const int* starts,
                                const int* counts, const unsigned char* cvalid, int L, const int* cells_lost,
                                const int* points_lost, int k, int* out_idx, float* out_d2,
                                unsigned char* certified, cudaStream_t s) {
  constexpr int kGroups = kLaneThreads / G;
  const long long smem = 4ll * kGroups * (2ll * P + 1 + K);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(coarse_refine_lanes_kernel<K, G>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (Q + kGroups - 1) / kGroups;
  coarse_refine_lanes_kernel<K, G><<<blocks, kLaneThreads, static_cast<size_t>(smem), s>>>(
      queries, Q, cells, P, lb_unexplored, pts, pmask, M, starts, counts, cvalid, L, cells_lost, points_lost, k,
      out_idx, out_d2, certified);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_refine(int G, int Q, const float* queries, const int* cells, int P, const float* lb_unexplored,
                          const float* pts, const unsigned char* pmask, int M, const int* starts, const int* counts,
                          const unsigned char* cvalid, int L, const int* cells_lost, const int* points_lost, int k,
                          int* out_idx, float* out_d2, unsigned char* certified, cudaStream_t s) {
  switch (G) {
    case 8:
      return launch_refine_lanes<K, 8>(Q, queries, cells, P, lb_unexplored, pts, pmask, M, starts, counts, cvalid,
                                       L, cells_lost, points_lost, k, out_idx, out_d2, certified, s);
    case 16:
      return launch_refine_lanes<K, 16>(Q, queries, cells, P, lb_unexplored, pts, pmask, M, starts, counts, cvalid,
                                        L, cells_lost, points_lost, k, out_idx, out_d2, certified, s);
    case 32:
      return launch_refine_lanes<K, 32>(Q, queries, cells, P, lb_unexplored, pts, pmask, M, starts, counts, cvalid,
                                        L, cells_lost, points_lost, k, out_idx, out_d2, certified, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

#define SPT_COARSE_LANES_CASE(KK)                                                                            \
  case KK:                                                                                                   \
    return static_cast<int>(launch_refine<KK>(lanes, Q, queries, cells, P, lb_unexplored, pts, pmask, M,   \
                                              starts, counts, cvalid, L, cells_lost, points_lost, k, out_idx, \
                                              out_d2, certified, s));

#define SPT_COARSE_SIMPLE_CASE(KK)                                                                        \
  case KK:                                                                                                \
    coarse_refine_simple_kernel<KK><<<blocks, kThreads, 0, s>>>(queries, Q, cells, P, lb_unexplored, pts, \
                                                                 pmask, M, starts, counts, cvalid, L,      \
                                                                 cells_lost, points_lost, out_idx, out_d2, \
                                                                 certified);                               \
    break;

// queries [Q,3] f32 (already moved by the pose), cells [Q,P] i32 selected in
// order, lb_unexplored [Q] f32; the sorted target [M,3] f32 and mask [M]
// bool; starts / counts [C] i32, valid [C] bool; cells_lost / points_lost
// 0-dim i32 on the card; out_idx [Q,k] i32 (sorted layout), out_d2 [Q,k]
// f32, certified [Q] bool; 1 <= k <= 128 (the instance best_k.cuh's
// instance_k picks); lanes a query in {8, 16, 32}; P L < 2^31.
extern "C" int spt_coarse_refine(const float* queries, int Q, const int* cells, int P, const float* lb_unexplored,
                                 const float* pts, const unsigned char* pmask, int M, const int* starts,
                                 const int* counts, const unsigned char* cvalid, int L, const int* cells_lost,
                                 const int* points_lost, int k, int lanes, int* out_idx, float* out_d2,
                                 unsigned char* certified, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q == 0) return static_cast<int>(cudaSuccess);
  if (M <= 0 || P <= 0 || L <= 0 || static_cast<long long>(P) * L >= spt::kNoSlot)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (spt::instance_k(k)) {
    SPT_K_CASES(SPT_COARSE_LANES_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The first design, one thread a query: the arguments of spt_coarse_refine
// but lanes; 1 <= k <= 16.
extern "C" int spt_coarse_refine_simple(const float* queries, int Q, const int* cells, int P,
                                        const float* lb_unexplored, const float* pts, const unsigned char* pmask,
                                        int M, const int* starts, const int* counts, const unsigned char* cvalid,
                                        int L, const int* cells_lost, const int* points_lost, int k, int* out_idx,
                                        float* out_d2, unsigned char* certified, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (Q + kThreads - 1) / kThreads;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  if (M <= 0 || P <= 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (k) {
    SPT_FAST_K_CASES(SPT_COARSE_SIMPLE_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// queries [Q,3] f32 (moved), the cells' centroids [C,3] f32, radii [C] f32
// and valid [C] bool; occupied a 0-dim i32 on the card (every occupied cell
// lies below it: the cells from it on are ranked as empty); margin; P <= C,
// take = P + 1 (P when P = C) <= 128. out_cells [Q,P] i32, out_lb [Q] f32.
extern "C" int spt_coarse_rank(const float* queries, int Q, const float* centroids, const float* radii,
                               const unsigned char* cvalid, int C, const int* occupied, float margin, int P,
                               int* out_cells, float* out_lb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q == 0) return static_cast<int>(cudaSuccess);
  const int take = P < C ? P + 1 : P;
  if (P <= 0 || P > C) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (Q + kRankWarps - 1) / kRankWarps;
  if (take <= 32)
    coarse_rank_kernel<1><<<blocks, kRankThreads, 0, s>>>(queries, Q, centroids, radii, cvalid, C, occupied, margin,
                                                          P, out_cells, out_lb);
  else if (take <= 64)
    coarse_rank_kernel<2><<<blocks, kRankThreads, 0, s>>>(queries, Q, centroids, radii, cvalid, C, occupied, margin,
                                                          P, out_cells, out_lb);
  else if (take <= 128)
    coarse_rank_kernel<4><<<blocks, kRankThreads, 0, s>>>(queries, Q, centroids, radii, cvalid, C, occupied, margin,
                                                          P, out_cells, out_lb);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
