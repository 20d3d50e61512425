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
// once, so the bound is the FP32 lanes over the candidates the data gives;
// the probes are dependent loads, so latency, not a rate, is what a simple
// kernel meets first.
//
// The simple design: one thread a query.
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
//   4. Lanes 0 .. min(count, P) - 1 of each found cell, masked points
//      skipped, d2 = dx*dx + dy*dy + dz*dz, kept by the strict-`<` insertion
//      of best_k.cuh in slot order (offset, lane).
//   5. Slots the list leaves empty get JAX's padding: the original index of
//      the first slots, in the same order, that hold no finite candidate
//      (an empty or masked lane, a cell not found, the position clipped into
//      [0, M)), at +inf.
//
// The entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>

#include "best_k.cuh"

namespace {

constexpr int kThreads = 128;
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

template <int K>
__global__ void __launch_bounds__(kThreads)
grid_knn_kernel(const float* __restrict__ queries, int Q, const float* __restrict__ pose, float inv_cell,
                const float* __restrict__ pts, const unsigned char* __restrict__ pmask,
                const int* __restrict__ orig_idx, int M, const int* __restrict__ tbl,
                const unsigned char* __restrict__ used, const int* __restrict__ cell_start,
                const int* __restrict__ cell_count, int cap, int max_probes, int P, int* __restrict__ out_idx,
                float* __restrict__ out_d2) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  float qx = __ldg(queries + 3 * q), qy = __ldg(queries + 3 * q + 1), qz = __ldg(queries + 3 * q + 2);
  if (pose != nullptr) {
    const float x = qx, y = qy, z = qz;
    qx = __ldg(pose + 0) * x + __ldg(pose + 1) * y + __ldg(pose + 2) * z + __ldg(pose + 3);
    qy = __ldg(pose + 4) * x + __ldg(pose + 5) * y + __ldg(pose + 6) * z + __ldg(pose + 7);
    qz = __ldg(pose + 8) * x + __ldg(pose + 9) * y + __ldg(pose + 10) * z + __ldg(pose + 11);
  }
  const float sx = qx * inv_cell, sy = qy * inv_cell, sz = qz * inv_cell;
  const int cx = cell_coord(sx), cy = cell_coord(sy), cz = cell_coord(sz);
  const bool ok = isfinite(sx) && isfinite(sy) && isfinite(sz) && cx >= 0 && cx <= kCoordMask && cy >= 0 &&
                  cy <= kCoordMask && cz >= 0 && cz <= kCoordMask;

  float bd[K];
  int bi[K];
  best_k_init<K>(bd, bi);
  int start[27], count[27];
  for (int o = 0; o < 27; ++o) {
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
  for (int o = 0; o < 27 && t < K; ++o) {
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

}  // namespace

#define SPT_GRID_KNN_CASE(KK)                                                                       \
  case KK:                                                                                          \
    grid_knn_kernel<KK><<<blocks, kThreads, 0, s>>>(queries, Q, pose, inv_cell, pts, pmask, orig_idx, \
                                                     M, tbl, used, cell_start, cell_count, cap,    \
                                                     max_probes, P, out_idx, out_d2);              \
    break;

// queries [Q,3] f32, pose [4,4] row-major f32 or null; the grid's sorted
// points [M,3] f32, mask [M] bool, orig_idx [M] i32, table keys [cap,3] i32,
// used [cap] bool, cell_start / cell_count [cap] i32 (cap a power of two);
// out_idx [Q,k] i32 (original order), out_d2 [Q,k] f32; 1 <= k <= 16.
extern "C" int spt_grid_knn(const float* queries, int Q, const float* pose, float inv_cell, const float* pts,
                            const unsigned char* pmask, const int* orig_idx, int M, const int* tbl,
                            const unsigned char* used, const int* cell_start, const int* cell_count, int cap,
                            int max_probes, int P, int k, int* out_idx, float* out_d2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (Q + kThreads - 1) / kThreads;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  if (M <= 0 || cap <= 0 || (cap & (cap - 1)) != 0 || P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (k) {
    SPT_GRID_KNN_CASE(1)
    SPT_GRID_KNN_CASE(2)
    SPT_GRID_KNN_CASE(3)
    SPT_GRID_KNN_CASE(4)
    SPT_GRID_KNN_CASE(5)
    SPT_GRID_KNN_CASE(6)
    SPT_GRID_KNN_CASE(7)
    SPT_GRID_KNN_CASE(8)
    SPT_GRID_KNN_CASE(9)
    SPT_GRID_KNN_CASE(10)
    SPT_GRID_KNN_CASE(11)
    SPT_GRID_KNN_CASE(12)
    SPT_GRID_KNN_CASE(13)
    SPT_GRID_KNN_CASE(14)
    SPT_GRID_KNN_CASE(15)
    SPT_GRID_KNN_CASE(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
