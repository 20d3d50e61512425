// The grid-bucket k-NN search for Hopper (sm_90a), plain C interface.
//
// grid_knn replaces the 27-cell search of the JAX package's GridKNN
// (sycl_points_tpu/ops/grid_knn.py:139-188, GridKNN.search): JAX builds it
// from a hash lookup of 27 x Q cell keys, a [Q, 27 P] gather and an argmin or
// top_k in XLA ops. It is not a Pallas kernel, so this kernel ports no TPU
// kernel: it is the search of the grid target that build_target_knn picks
// above GRID_KNN_TARGET_THRESHOLD rows.
//
// What bounds it on the card: per query it reads the 27 cells' table slots
// (a few probes each) and up to 27 P candidate points (16 B each, from L1/L2:
// neighbouring queries share cells), and does ~9 FP32 operations a valid
// candidate. Device memory sees the queries, the table and the target about
// once, so the bound is a few microseconds of bytes at most; what a kernel
// meets first is latency: each probe chain is a run of dependent loads, and
// a query's candidates (~200 on the LO frame's submap) are few.
//
// Both designs compute the same function, bit for bit:
//   1. The pose (if any) moves the query as ops/transform.transform_points
//      does: ((r0 x + r1 y) + r2 z) + t, each operation rounded once (the
//      library is built with --fmad=false).
//   2. Its cell is floor(q * inv_cell) + 2^20 on each axis, valid only when
//      finite and inside the 21-bit range, as ops/voxel.voxel_coords_counted.
//   3. The 27 offsets in JAX's order (dx outer, dz inner); each key is probed
//      in the open-addressing table as mapping/hash_table.lookup_slots does:
//      h1 = x*73856093 ^ y*19349669 ^ z*83492791, h2 = h1*2654435761 | 1
//      (uint32 wrap-around), slot (h1 + p h2) & (cap - 1) for p < max_probes,
//      an unused slot ends the chain, keys compared as the two packed
//      21-bit planes.
//   4. Slot s = o P + j for lane j < min(count, P) of cell o; masked points
//      are not candidates; d2 = dx*dx + dy*dy + dz*dz. The k smallest by
//      (d2, s): a tie goes to the earlier slot, as argmin and lax.top_k keep
//      it (not to the smaller original index).
//   5. Slots the list leaves empty get JAX's padding: the original index of
//      the first slots in (o, j) order, j < P, that hold no finite candidate
//      (an empty or masked lane, a cell not found; the position clipped into
//      [0, M)), at +inf.
//
// grid_knn_simple_kernel, the first design (kept as the reference the new
// one is timed against): one thread a query walks the 27 probe chains and
// the candidates one after another with the strict-`<` insertion of
// best_k.cuh in slot order, then walks the slots again for the padding.
// At the LO frame's 1,000 queries that is 8 blocks of 128 threads on 132
// SMs, each thread a serial chain of ~27 probes and ~200 candidates.
//
// grid_knn_lanes_kernel<K, G>, the design for this card: G lanes a query
// (G in {8, 16, 32}, chosen by ops/cuda_knn.grid_lanes from Q and the SM
// count, so that small batches still fill the card), the lane-group search
// of lane_knn.cuh over the 27 cells' slots (W = P).
//   - Probes: lane l probes offsets l, l + G, ... at once; the group shares
//     each cell's start and n = min(count, P) and their prefix. Starts and
//     prefixes sit in shared memory, 55 ints a query. A probe loads the
//     slot's flag, key, start and count at once: one load latency a probe.
//   - Candidates, merge and padding as lane_knn.cuh: the lists hold slots,
//     not indices; the original index is read once an output.
// It is built at K = 1 .. 16, 32, 64 and 128 (best_k.cuh); above 16 it
// writes the first k entries of its K-list.
//
// There is no tensor-core work: the search is compares and selects, not
// products.
//
// The entry points launch on the caller's stream, allocate nothing, and
// return cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>

#include "best_k.cuh"
#include "lane_knn.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kLaneThreads = 256;
constexpr int kOffsets = 27;
constexpr int kCoordOffset = 1 << 20;
constexpr int kCoordMask = (1 << 21) - 1;

__device__ __forceinline__ int cell_coord(float s) {
  float f = floorf(s);
  f = fminf(fmaxf(f, -1073741824.0f), 1073741824.0f);
  return static_cast<int>(f) + kCoordOffset;
}

__device__ __forceinline__ void pack2(unsigned x, unsigned y, unsigned z, unsigned* hi, unsigned* lo) {
  *hi = (x << 11) | (y >> 10);
  *lo = ((y & 0x3FFu) << 21) | (z & 0x1FFFFFu);
}

// The slot holding key (x, y, z), or -1.
__device__ int lookup(const int* __restrict__ tbl, const unsigned char* __restrict__ used, int cap,
                      int max_probes, int x, int y, int z) {
  const unsigned cx = static_cast<unsigned>(x), cy = static_cast<unsigned>(y), cz = static_cast<unsigned>(z);
  const unsigned h1 = (cx * 73856093u) ^ (cy * 19349669u) ^ (cz * 83492791u);
  const unsigned h2 = (h1 * 2654435761u) | 1u;
  const unsigned mask = static_cast<unsigned>(cap - 1);
  unsigned khi, klo;
  pack2(cx, cy, cz, &khi, &klo);
  for (int p = 0; p < max_probes; ++p) {
    const int s = static_cast<int>(((h1 & mask) + static_cast<unsigned>(p) * h2) & mask);
    if (!__ldg(used + s)) return -1;
    unsigned thi, tlo;
    pack2(static_cast<unsigned>(__ldg(tbl + 3 * s)), static_cast<unsigned>(__ldg(tbl + 3 * s + 1)),
          static_cast<unsigned>(__ldg(tbl + 3 * s + 2)), &thi, &tlo);
    if (thi == khi && tlo == klo) return s;
  }
  return -1;
}

// lookup() for the lane-group kernel: each probe loads the slot's used flag,
// key, start and count together, so a probe costs one load latency, and
// returns the cell's start and count (0 and 0 when the key is absent).
__device__ __forceinline__ void lookup_cell(const int* __restrict__ tbl, const unsigned char* __restrict__ used,
                                            const int* __restrict__ cell_start, const int* __restrict__ cell_count,
                                            int cap, int max_probes, int x, int y, int z, int* start, int* count) {
  const unsigned cx = static_cast<unsigned>(x), cy = static_cast<unsigned>(y), cz = static_cast<unsigned>(z);
  const unsigned h1 = (cx * 73856093u) ^ (cy * 19349669u) ^ (cz * 83492791u);
  const unsigned h2 = (h1 * 2654435761u) | 1u;
  const unsigned mask = static_cast<unsigned>(cap - 1);
  unsigned khi, klo;
  pack2(cx, cy, cz, &khi, &klo);
  *start = 0;
  *count = 0;
  for (int p = 0; p < max_probes; ++p) {
    const int s = static_cast<int>(((h1 & mask) + static_cast<unsigned>(p) * h2) & mask);
    const unsigned char u = __ldg(used + s);
    const int tx = __ldg(tbl + 3 * s), ty = __ldg(tbl + 3 * s + 1), tz = __ldg(tbl + 3 * s + 2);
    const int st = __ldg(cell_start + s), ct = __ldg(cell_count + s);
    if (!u) return;
    unsigned thi, tlo;
    pack2(static_cast<unsigned>(tx), static_cast<unsigned>(ty), static_cast<unsigned>(tz), &thi, &tlo);
    if (thi == khi && tlo == klo) {
      *start = st;
      *count = ct;
      return;
    }
  }
}

// Steps 1-2: the query moved by the pose, and its cell (ok: the cell is
// valid).
__device__ __forceinline__ bool query_cell(const float* __restrict__ queries, int q, const float* __restrict__ pose,
                                           float inv_cell, float* qx, float* qy, float* qz, int* cx, int* cy,
                                           int* cz) {
  float x = __ldg(queries + 3 * q), y = __ldg(queries + 3 * q + 1), z = __ldg(queries + 3 * q + 2);
  if (pose != nullptr) {
    const float px = x, py = y, pz = z;
    x = __ldg(pose + 0) * px + __ldg(pose + 1) * py + __ldg(pose + 2) * pz + __ldg(pose + 3);
    y = __ldg(pose + 4) * px + __ldg(pose + 5) * py + __ldg(pose + 6) * pz + __ldg(pose + 7);
    z = __ldg(pose + 8) * px + __ldg(pose + 9) * py + __ldg(pose + 10) * pz + __ldg(pose + 11);
  }
  *qx = x;
  *qy = y;
  *qz = z;
  const float sx = x * inv_cell, sy = y * inv_cell, sz = z * inv_cell;
  *cx = cell_coord(sx);
  *cy = cell_coord(sy);
  *cz = cell_coord(sz);
  return isfinite(sx) && isfinite(sy) && isfinite(sz) && *cx >= 0 && *cx <= kCoordMask && *cy >= 0 &&
         *cy <= kCoordMask && *cz >= 0 && *cz <= kCoordMask;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
grid_knn_simple_kernel(const float* __restrict__ queries, int Q, const float* __restrict__ pose, float inv_cell,
                       const float* __restrict__ pts, const unsigned char* __restrict__ pmask,
                       const int* __restrict__ orig_idx, int M, const int* __restrict__ tbl,
                       const unsigned char* __restrict__ used, const int* __restrict__ cell_start,
                       const int* __restrict__ cell_count, int cap, int max_probes, int P, int* __restrict__ out_idx,
                       float* __restrict__ out_d2) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  float qx, qy, qz;
  int cx, cy, cz;
  const bool ok = query_cell(queries, q, pose, inv_cell, &qx, &qy, &qz, &cx, &cy, &cz);

  float bd[K];
  int bi[K];
  best_k_init<K>(bd, bi);
  int start[kOffsets], count[kOffsets];
  for (int o = 0; o < kOffsets; ++o) {
    const int s = ok ? lookup(tbl, used, cap, max_probes, cx + o / 9 - 1, cy + (o / 3) % 3 - 1, cz + o % 3 - 1)
                     : -1;
    start[o] = s >= 0 ? __ldg(cell_start + s) : 0;
    count[o] = s >= 0 ? __ldg(cell_count + s) : 0;
    const int n = min(count[o], P);
    for (int j = 0; j < n; ++j) {
      const int p = min(max(start[o] + j, 0), M - 1);
      if (!__ldg(pmask + p)) continue;
      const float dx = __ldg(pts + 3 * p) - qx;
      const float dy = __ldg(pts + 3 * p + 1) - qy;
      const float dz = __ldg(pts + 3 * p + 2) - qz;
      best_k_insert<K>(bd, bi, dx * dx + dy * dy + dz * dz, __ldg(orig_idx + p));
    }
  }

  int* oi = out_idx + static_cast<long long>(q) * K;
  float* od = out_d2 + static_cast<long long>(q) * K;
  int t = best_k_store<K>(bd, bi, oi, od);
  // JAX's padding: the first slots in (offset, lane) order with no finite
  // candidate
  for (int o = 0; o < kOffsets && t < K; ++o) {
    const int n = min(count[o], P);
    for (int j = 0; j < P && t < K; ++j) {
      const int p = min(max(start[o] + j, 0), M - 1);
      bool finite = false;
      if (j < n && __ldg(pmask + p)) {
        const float dx = __ldg(pts + 3 * p) - qx;
        const float dy = __ldg(pts + 3 * p + 1) - qy;
        const float dz = __ldg(pts + 3 * p + 2) - qz;
        finite = dx * dx + dy * dy + dz * dz < __int_as_float(0x7f800000);
      }
      if (!finite) {
        oi[t] = __ldg(orig_idx + p);
        od[t] = __int_as_float(0x7f800000);
        ++t;
      }
    }
  }
}

template <int K, int G>
__global__ void __launch_bounds__(kLaneThreads)
grid_knn_lanes_kernel(const float* __restrict__ queries, int Q, const float* __restrict__ pose, float inv_cell,
                      const float* __restrict__ pts, const unsigned char* __restrict__ pmask,
                      const int* __restrict__ orig_idx, int M, const int* __restrict__ tbl,
                      const unsigned char* __restrict__ used, const int* __restrict__ cell_start,
                      const int* __restrict__ cell_count, int cap, int max_probes, int P, int k,
                      int* __restrict__ out_idx, float* __restrict__ out_d2) {
  constexpr int kGroups = kLaneThreads / G;
  constexpr int kPer = (kOffsets + G - 1) / G;  // offsets a lane probes
  __shared__ int s_start[kGroups][kOffsets];
  __shared__ int s_pre[kGroups][kOffsets + 1];  // exclusive prefix of n; [27] = T
  __shared__ int s_nf[kGroups][K];              // the first K non-finite candidates

  const int group = threadIdx.x / G;
  const spt::LaneGroup<G> g(threadIdx.x);
  const int q = blockIdx.x * kGroups + group;
  if (q >= Q) return;  // the whole group
  const int kw = spt::row_count<K>(k);
  int* const start = s_start[group];
  int* const pre = s_pre[group];
  int* const nf = s_nf[group];

  float qx, qy, qz;
  int cx, cy, cz;
  const bool ok = query_cell(queries, q, pose, inv_cell, &qx, &qy, &qz, &cx, &cy, &cz);

  // probes, then the exclusive prefix of n over the 27 cells
  int carry = 0;
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int o = g.lane + r * G;
    int c_start = 0, c_count = 0;
    if (ok && o < kOffsets)
      lookup_cell(tbl, used, cell_start, cell_count, cap, max_probes, cx + o / 9 - 1, cy + (o / 3) % 3 - 1,
                  cz + o % 3 - 1, &c_start, &c_count);
    const int c_pre = spt::chunk_prefix<G>(min(c_count, P), g, carry);
    if (o < kOffsets) {
      start[o] = c_start;
      pre[o] = c_pre;
    }
  }
  const int T = carry;
  if (g.lane == 0) pre[kOffsets] = T;
  __syncwarp(g.mask);

  float bd[K];
  int bs[K];
  const int n_nf = spt::lane_walk<K, G>(T, g, bd, bs, nf, [&](int t, int* o, int* s) {
    return spt::lane_candidate(t, o, pre, start, P, M, pts, pmask, qx, qy, qz, s);
  });
  __syncwarp(g.mask);

  int* oi = out_idx + static_cast<long long>(q) * kw;
  float* od = out_d2 + static_cast<long long>(q) * kw;
  const int n_fin = min(kw, T - n_nf);
  spt::lane_merge<K, G>(bd, bs, n_fin, g, [&](int r, float d, int s) {
    if (g.lane == r % G) {
      const int co = s / P;
      oi[r] = __ldg(orig_idx + min(max(start[co] + s - co * P, 0), M - 1));
      od[r] = d;
    }
  });
  if (n_fin < kw)
    spt::lane_padding<G>(pre, kOffsets, P, nf, min(n_nf, K), kw - n_fin, g, [&](int rank, int c, int j) {
      oi[n_fin + rank] = __ldg(orig_idx + min(max(start[c] + j, 0), M - 1));
      od[n_fin + rank] = __int_as_float(0x7f800000);
    });
}

template <int K>
cudaError_t launch_lanes(int G, int Q, cudaStream_t s, const float* queries, const float* pose, float inv_cell,
                         const float* pts, const unsigned char* pmask, const int* orig_idx, int M, const int* tbl,
                         const unsigned char* used, const int* cell_start, const int* cell_count, int cap,
                         int max_probes, int P, int k, int* out_idx, float* out_d2) {
  const int groups = kLaneThreads / G;
  const int blocks = (Q + groups - 1) / groups;
  switch (G) {
    case 8:
      grid_knn_lanes_kernel<K, 8><<<blocks, kLaneThreads, 0, s>>>(queries, Q, pose, inv_cell, pts, pmask, orig_idx, M,
                                                                   tbl, used, cell_start, cell_count, cap, max_probes,
                                                                   P, k, out_idx, out_d2);
      break;
    case 16:
      grid_knn_lanes_kernel<K, 16><<<blocks, kLaneThreads, 0, s>>>(queries, Q, pose, inv_cell, pts, pmask, orig_idx,
                                                                    M, tbl, used, cell_start, cell_count, cap,
                                                                    max_probes, P, k, out_idx, out_d2);
      break;
    case 32:
      grid_knn_lanes_kernel<K, 32><<<blocks, kLaneThreads, 0, s>>>(queries, Q, pose, inv_cell, pts, pmask, orig_idx,
                                                                    M, tbl, used, cell_start, cell_count, cap,
                                                                    max_probes, P, k, out_idx, out_d2);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

#define SPT_GRID_KNN_LANES_CASE(KK)                                                                              \
  case KK:                                                                                                       \
    return static_cast<int>(launch_lanes<KK>(lanes, Q, s, queries, pose, inv_cell, pts, pmask, orig_idx, M, tbl, \
                                             used, cell_start, cell_count, cap, max_probes, P, k, out_idx, out_d2));

#define SPT_GRID_KNN_SIMPLE_CASE(KK)                                                                             \
  case KK:                                                                                                       \
    grid_knn_simple_kernel<KK><<<blocks, kThreads, 0, s>>>(queries, Q, pose, inv_cell, pts, pmask, orig_idx, M, \
                                                           tbl, used, cell_start, cell_count, cap, max_probes, P, \
                                                           out_idx, out_d2);                                      \
    break;

// queries [Q,3] f32, pose [4,4] row-major f32 or null; the grid's sorted
// points [M,3] f32, mask [M] bool, orig_idx [M] i32, table keys [cap,3] i32,
// used [cap] bool, cell_start / cell_count [cap] i32 (cap a power of two);
// out_idx [Q,k] i32 (original order), out_d2 [Q,k] f32; 1 <= k <= 128 (the
// instance best_k.cuh's instance_k picks); lanes a query in {8, 16, 32}.
extern "C" int spt_grid_knn(const float* queries, int Q, const float* pose, float inv_cell, const float* pts,
                            const unsigned char* pmask, const int* orig_idx, int M, const int* tbl,
                            const unsigned char* used, const int* cell_start, const int* cell_count, int cap,
                            int max_probes, int P, int k, int lanes, int* out_idx, float* out_d2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q == 0) return static_cast<int>(cudaSuccess);
  if (M <= 0 || cap <= 0 || (cap & (cap - 1)) != 0 || P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (spt::instance_k(k)) {
    SPT_K_CASES(SPT_GRID_KNN_LANES_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The first design, one thread a query: the same arguments but lanes;
// 1 <= k <= 16.
extern "C" int spt_grid_knn_simple(const float* queries, int Q, const float* pose, float inv_cell, const float* pts,
                                   const unsigned char* pmask, const int* orig_idx, int M, const int* tbl,
                                   const unsigned char* used, const int* cell_start, const int* cell_count, int cap,
                                   int max_probes, int P, int k, int* out_idx, float* out_d2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (Q + kThreads - 1) / kThreads;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  if (M <= 0 || cap <= 0 || (cap & (cap - 1)) != 0 || P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (k) {
    SPT_FAST_K_CASES(SPT_GRID_KNN_SIMPLE_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
