// The range-image k-NN of a raw spinning-LiDAR scan for Hopper (sm_90a),
// plain C interface.
//
// These kernels replace the JAX package's range_image_knn
// (sycl_points_tpu/ops/range_image_knn.py:60-140), which XLA builds from the
// bins, two scatters, 117 image rolls, a top_k over [C, 117] and a gather. It
// is not a Pallas kernel, so they port no TPU kernel: they take the place of
// the self-k-NN (knn_k) on the raw-features frames. On a CUDA tensor,
// ops/range_image_knn.range_image_knn runs as a memset and four launches:
//   (a) range_image_elevation_kernel: r, ok and el of every point, and the
//       masked min and max of el as order-preserving uint32 keys under
//       atomicMax, from at most 128 blocks (same-address atomics
//       serialise; skipped when el_min and el_max are both given);
//   (b) range_image_cells_kernel: the azimuth and elevation bins, the cell,
//       the occupancy (atomicAdd; a point that finds its cell taken counts
//       one collision) and the winner (atomicMax of the point index + 1,
//       which equals scatter_reduce(amax) over the indices);
//   (c) range_image_tile_kernel<K, gather>: the window search, reading the
//       winners' points straight from the scan into its tile;
//   (d) range_image_rows_kernel: each point's row of its cell's result, the
//       point itself at +inf where a slot is empty or the point is invalid.
// The plain PyTorch sequence (range_image + range_image_window_plain +
// point_rows) is the reference, bit for bit: every operation of the bins is
// written with the _rn intrinsics, one rounding each, in PyTorch's order;
// (az + pi) / (2 pi) is a product with the f32 reciprocal of 2 pi, as
// PyTorch's CUDA division by a CPU scalar computes it, while
// (el - el_lo) / span divides two tensors. atan2f and asinf are CUDA's own,
// as PyTorch's kernels call them. Built with the library's --fmad=false
// they agree with PyTorch's: the card tests and chip_smoke.py hold every
// cell (so every bin) of full-width scans to the plain steps bit for bit,
// so this source takes the library's flags.
//
// The window search (steps 3-4 of JAX's function, :113-128): for every cell
// of the dense [n_az, n_rings] image, the squared distances to the points
// of the (2 window_az + 1) x (2 window_el + 1) cells around it (azimuth
// circular, elevation not), then the k smallest, scanned in JAX's column
// order (da outer, de inner) with a strict `<`, so that an equal distance
// stays behind the earlier column, as lax.top_k keeps it. Unoccupied cells
// and elevation offsets off the image are skipped; an unoccupied cell gets
// no candidate; slots not filled stay at 3e38 with index -1.
//
// What bounds it on the card: the image is 16 B a cell and the result 8 k B
// a cell, ~12.6 MB at 2048 x 64, k = 10 (~0.004 ms of bytes); a cell does
// ~9 FP32 operations for each of its 117 candidates, about as long. What a
// kernel meets first is instructions a candidate (a load, the distance, the
// compare) and the sorted insertion, which the threads of a warp take at
// different candidates, so that every candidate where one thread inserts
// costs the warp a whole insertion. Above k = 16 the rows grow to 8 k B a
// cell (~0.037 ms of bytes at k = 117) and a one-thread list of K keys no
// longer fits the registers: the warp kernel below.
//
// range_image_window_simple_kernel, the first design (kept as the reference
// the new one is timed against): one thread a cell reads its window as 468
// scattered 4-byte loads through L1, in JAX's column order, tests each
// candidate's index, inserts by distance alone, and writes its own k slots
// (stores 4 k B apart, a sector a store).
//
// range_image_tile_kernel<K, gather>, the design for this card: a block owns
// TA azimuth columns x all n_rings (TA from
// ops/range_image_knn.range_image_tile: the block's cells near 512, the tile
// and the block's rows of the result within 227 KB) and stages the
// TA + 2 window_az columns it reads, azimuth wrapped at 0 and n_az, into
// shared memory with 4-byte cp.async copies (a column's rings are
// contiguous rows, so a warp copies runs of consecutive rows; in the gather
// form it reads the winners' points straight from the scan). A cell's point
// is 12 bytes, read as three 4-byte loads at one address (stride 3 words,
// conflict-free), its index in an array apart: one address a candidate
// where SoA x, y, z take three, and a quarter less shared-memory traffic
// than 16-byte records. Empty cells are
// staged at +inf, so no index test a candidate. Each thread takes one
// cell; its list holds 64-bit keys, the distance's bits above the
// candidate's position in JAX's order, so any visiting order keeps JAX's
// ties, and one float compare against the list's last distance turns most
// candidates away. It visits the window nearest
// first: the cell's own ring fills the list (its first k candidates, the
// cell itself at 0 and then da = +1, -1, +2, ..., sorted in by i
// compare-exchanges for the i-th, where a whole insertion costs k), then
// ring offset -1, 1, -2, ... and in each, azimuth offset 0, then +-q,
// +-(q + 1) four at once with their loads in flight together and one warp
// vote to turn the four away. The list holds the nearest candidates early,
// so a later one seldom enters. The block's rows of the result go through
// shared memory and out in coalesced 16-byte stores. (Where the ring holds
// fewer than k candidates, the cell itself goes in first and the ring is
// visited like the others.)
//
// The window search is built at K = 1 .. 16, 32, 64 and 128 (best_k.cuh);
// above 16 a request for k runs the smallest K >= k and writes the first k
// entries of each list (keys order as JAX's columns, so they are the
// k-list). Up to 16 it runs the tile kernel above; above 16 it runs
// range_image_warp_kernel<K, gather>, a warp a cell:
//   - the block stages its columns as the tile kernel does (same cp.async
//     copies, empty cells at +inf, the gather form), at an odd column stride
//     (n_rings | 1) so that the lanes reading one ring's columns hit 32
//     distinct banks;
//   - the cell's list of K 64-bit keys (the tile kernel's total key) is
//     spread over the lanes, P = K / 32 a lane, and sorted and merged with
//     warp_sort.cuh. The window's W candidates are taken 32 P at a time, one
//     a lane register, nearest first (ring offset 0, -1, +1, -2, ... and the
//     columns of each ring in order); a chunk is bitonic-sorted and merged
//     into the list, and skipped whole by one warp vote when none of its
//     keys is below the list's last. A later chunk with at most kInsertMax
//     such keys puts each in at its rank instead (warp_insert: a ballot a
//     register and a lane shift, against a 15- to 28-step sort and a 6- to
//     8-step merge). At the default window (W = 117) the K = 128 list is
//     one chunk and one sort;
//   - the cell's row goes out coalesced, lane j writing entries j, j + 32,
//     ..., through K keys of shared memory a warp: no result rows a thread,
//     so ops/range_image_knn.range_image_tile plans its columns from the
//     staged tile alone (64 cells a block of 8 warps: one column at 64
//     rings, 2,048 blocks at 2048 x 64). No register is indexed at run
//     time, so the list never spills.
// The one-thread tile kernel's instances above 16 (whose K-key lists spill)
// stay as spt_range_image_window_spill, the reference the warp kernel is
// timed against; its block's result rows take 8 K B a thread, so their
// tile (ops/range_image_knn.spill_tile) has fewer columns.
//
// There is no tensor-core work: the search is compares and selects, not
// products.
//
// The entry points launch on the caller's stream, allocate nothing, and
// return cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>

#include "best_k.cuh"
#include "warp_sort.cuh"

namespace {

using spt::kEmptyKey;

constexpr float kBig = 3.0e38f;
constexpr int kSimpleThreads = 256;
constexpr int kPointThreads = 256;
constexpr int kTileThreads = 512;
constexpr int kWarpThreads = 256;  // range_image_warp_kernel: 8 warps a block, a warp a cell
constexpr int kWarpsPerBlock = kWarpThreads / 32;
constexpr int kInsertMax = 12;     // a later chunk of at most this many keys goes in by insertion
constexpr int kElevationBlocks = 128;  // blocks of the elevation bounds' grid-stride pass
constexpr int kMaxSmem = 232448;  // 227 KB, a block's limit on sm_90

template <int K>
__global__ void __launch_bounds__(kSimpleThreads)
range_image_window_simple_kernel(const float* __restrict__ pts, const int* __restrict__ ids, int n_az,
                                 int n_rings, int window_az, int window_el, int* __restrict__ out_idx,
                                 float* __restrict__ out_d2) {
  const int cells = n_az * n_rings;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cells) return;

  float bd[K];
  int bi[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    bd[j] = kBig;
    bi[j] = -1;
  }

  if (__ldg(ids + c) >= 0) {
    const int a = c / n_rings;
    const int e = c - a * n_rings;
    const float px = __ldg(pts + 3 * c);
    const float py = __ldg(pts + 3 * c + 1);
    const float pz = __ldg(pts + 3 * c + 2);
    for (int da = -window_az; da <= window_az; ++da) {
      int a2 = (a + da) % n_az;
      if (a2 < 0) a2 += n_az;
      for (int de = -window_el; de <= window_el; ++de) {
        const int e2 = e + de;
        if (e2 < 0 || e2 >= n_rings) continue;
        const int c2 = a2 * n_rings + e2;
        const int id = __ldg(ids + c2);
        if (id < 0) continue;
        const float dx = __fsub_rn(px, __ldg(pts + 3 * c2));
        const float dy = __fsub_rn(py, __ldg(pts + 3 * c2 + 1));
        const float dz = __fsub_rn(pz, __ldg(pts + 3 * c2 + 2));
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        // insertion into the ascending list: entries equal to d stay ahead
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
    }
  }

  int* oi = out_idx + static_cast<long long>(c) * K;
  float* od = out_d2 + static_cast<long long>(c) * K;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    oi[j] = bi[j];
    od[j] = bd[j];
  }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// One window candidate of the tile kernel: its key (the distance's f32 bits
// above w = (da + window_az) << 16 | (de + window_el), which orders as its
// position in JAX's column order), into the list if it is among the K
// smallest keys. dlast is the list's last distance: most candidates fail
// the one float compare.
template <int K>
__device__ __forceinline__ void tile_insert(unsigned long long (&bk)[K], float& dlast, float d, unsigned w) {
  if (d <= dlast) {  // a key at or above the last one leaves the list as it is
    const unsigned long long key = (static_cast<unsigned long long>(__float_as_uint(d)) << 32) | w;
#pragma unroll
    for (int j = K - 1; j > 0; --j) {
      if (key < bk[j]) bk[j] = key < bk[j - 1] ? bk[j - 1] : key;
    }
    if (key < bk[0]) bk[0] = key;
    dlast = __uint_as_float(static_cast<unsigned>(bk[K - 1] >> 32));
  }
}

// A staged cell's point: 12 bytes, read as three 4-byte loads at one address.
struct Point3 {
  float x, y, z;
};

__device__ __forceinline__ float sqdist(Point3 p, Point3 c) {
  const float dx = __fsub_rn(p.x, c.x);
  const float dy = __fsub_rn(p.y, c.y);
  const float dz = __fsub_rn(p.z, c.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// Stages a block's columns a0 - window_az .. a0 + cols - window_az - 1,
// wrapped into [0, n_az), cell (column tc, ring e) at tc * stride + e: its
// point into rec and its index into sid. A column's rings are contiguous
// rows. The image is copied as it is and its empty cells set to +inf after;
// the gather form (ids: the winner's index + 1, pts: the scan) reads a
// winner's point once its index is in. Ends in __syncthreads().
template <bool kGather>
__device__ __forceinline__ void stage_columns(const float* __restrict__ pts, const int* __restrict__ ids, int n_az,
                                              int n_rings, int window_az, int a0, int cols, int stride,
                                              Point3* rec, int* sid) {
  const float inf = __int_as_float(0x7f800000);
  const int span = cols * n_rings;
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const int tc = i / n_rings;
    const int e = i - tc * n_rings;
    int a = (a0 - window_az + tc) % n_az;
    if (a < 0) a += n_az;
    const long long c = static_cast<long long>(a) * n_rings + e;
    const int at = tc * stride + e;
    float* const r = &rec[at].x;
    if (kGather) {
      const int id = __ldg(ids + c) - 1;
      sid[at] = id;
      if (id >= 0) {
        cp_async4(r, pts + 3ll * id);
        cp_async4(r + 1, pts + 3ll * id + 1);
        cp_async4(r + 2, pts + 3ll * id + 2);
      } else {
        r[0] = inf;
        r[1] = inf;
        r[2] = inf;
      }
    } else {
      cp_async4(r, pts + 3 * c);
      cp_async4(r + 1, pts + 3 * c + 1);
      cp_async4(r + 2, pts + 3 * c + 2);
      sid[at] = __ldg(ids + c);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  if (!kGather) {
    for (int i = threadIdx.x; i < span; i += blockDim.x) {
      const int tc = i / n_rings;
      const int at = tc * stride + i - tc * n_rings;
      if (sid[at] < 0) {
        rec[at].x = inf;
        rec[at].y = inf;
        rec[at].z = inf;
      }
    }
    __syncthreads();
  }
}

// The window search of TA columns a block. gather: ids holds the winner's
// point index + 1 a cell (0: empty) and pts the scan's [N, 3] points; else
// ids holds the index (-1: empty) and pts the image's [C, 3] points.
//
// A staged cell is a 12-byte point and, apart, its index. An empty cell is
// staged at +inf, so its distance is +inf and never enters the list: no
// index test a candidate. The list keeps the K smallest keys (tile_insert), which is the
// strict-`<` insertion in column order whatever order the window is visited
// in; the visiting order is the header note's.
template <int K, bool kGather>
__global__ void __launch_bounds__(kTileThreads, K <= spt::kFastK ? 2 : 1)
range_image_tile_kernel(const float* __restrict__ pts, const int* __restrict__ ids, int n_az, int n_rings,
                        int window_az, int window_el, int tile_az, int k, int* __restrict__ out_idx,
                        float* __restrict__ out_d2) {
  const int kw = spt::row_count<K>(k);  // entries a row of the output
  extern __shared__ float4 smem4[];
  const int cols = tile_az + 2 * window_az;
  const int span = cols * n_rings;
  Point3* const rec = reinterpret_cast<Point3*>(smem4);
  int* const sid = reinterpret_cast<int*>(rec + span);
  const int a0 = blockIdx.x * tile_az;
  stage_columns<kGather>(pts, ids, n_az, n_rings, window_az, a0, cols, n_rings, rec, sid);

  const int rows = 2 * window_el + 1;
  const unsigned long long unfilled = (static_cast<unsigned long long>(__float_as_uint(kBig)) << 32) | 0xffffffffu;
  // the block's rows of the result, written back coalesced after each round
  int* const s_oi = sid + span;  // 16 span bytes in: 16-byte aligned
  float* const s_od = reinterpret_cast<float*>(s_oi + blockDim.x * K);
  const int tile_cells = min(tile_az, n_az - a0) * n_rings;
  for (int round = 0; round < tile_cells; round += blockDim.x) {
    const int l = round + threadIdx.x;
    if (l < tile_cells) {
      const int ta = l / n_rings;
      const int e = l - ta * n_rings;
      unsigned long long bk[K];
#pragma unroll
      for (int j = 0; j < K; ++j) bk[j] = unfilled;
      float dlast = kBig;
      const int ctr = (ta + window_az) * n_rings + e;
      const Point3 me = rec[ctr];
      const int step = n_rings;
      if (sid[ctr] >= 0) {
        int r0 = 0;  // the first ring offset left to visit
        const unsigned wring = static_cast<unsigned>(window_el);  // w of (da = -window_az, de = 0)
        // the cell itself first, at distance 0, into the empty list
        bk[0] = (static_cast<unsigned>(window_az) << 16) | wring;
        if constexpr (K <= spt::kFastK) {
          if (2 * window_az + 1 >= K) {
            // the cell's own ring fills the list: its first K candidates (da =
            // 0, +1, -1, +2, ...) go in unconditionally, the i-th sorted in by i
            // compare-exchanges, not by a whole insertion each
#pragma unroll
            for (int i = 0; i < K; ++i) {
              const int da = (i & 1) ? (i + 1) >> 1 : -((i + 1) >> 1);
              const float d = i ? sqdist(me, rec[ctr + da * n_rings]) : 0.0f;  // the cell itself at 0
              // an empty cell (+inf) leaves its slot unfilled
              bk[i] = d < kBig ? (static_cast<unsigned long long>(__float_as_uint(d)) << 32) |
                                     (wring + (static_cast<unsigned>(da + window_az) << 16))
                               : unfilled;
#pragma unroll
              for (int j = i; j > 0; --j) {
                const unsigned long long lo = bk[j] < bk[j - 1] ? bk[j] : bk[j - 1];
                bk[j] = bk[j] < bk[j - 1] ? bk[j - 1] : bk[j];
                bk[j - 1] = lo;
              }
            }
            dlast = __uint_as_float(static_cast<unsigned>(bk[K - 1] >> 32));
            // the rest of the ring: da above K / 2 and below -(K - 1) / 2
            for (int da = K / 2 + 1; da <= window_az; ++da)
              tile_insert<K>(bk, dlast, sqdist(me, rec[ctr + da * n_rings]),
                             wring + (static_cast<unsigned>(da + window_az) << 16));
            for (int da = -window_az; da < -((K - 1) / 2); ++da)
              tile_insert<K>(bk, dlast, sqdist(me, rec[ctr + da * n_rings]),
                             wring + (static_cast<unsigned>(da + window_az) << 16));
            r0 = 1;
          }
        }
        for (int r = r0; r < rows; ++r) {
          const int de = (r & 1) ? -((r + 1) >> 1) : (r >> 1);  // 0, -1, 1, -2, 2, ...
          if (e + de < 0 || e + de >= n_rings) continue;
          const Point3* const mid = rec + ctr + de;  // (da = 0, de)
          const unsigned wmid = (static_cast<unsigned>(window_az) << 16) | static_cast<unsigned>(de + window_el);
          if (r) tile_insert<K>(bk, dlast, sqdist(me, mid[0]), wmid);
          // azimuth offsets +q, -q, +(q + 1), -(q + 1) at once
          int q = 1;
          const Point3* up = mid + step;
          const Point3* down = mid - step;
          for (; q < window_az; q += 2, up += 2 * step, down -= 2 * step) {
            const float d0 = sqdist(me, up[0]), d1 = sqdist(me, down[0]);
            const float d2 = sqdist(me, up[step]), d3 = sqdist(me, down[-step]);
            // one vote turns the four away together; a thread's turned-away
            // candidates fail its own float compare inside
            if (__any_sync(__activemask(), fminf(fminf(d0, d1), fminf(d2, d3)) <= dlast)) {
              tile_insert<K>(bk, dlast, d0, wmid + (static_cast<unsigned>(q) << 16));
              tile_insert<K>(bk, dlast, d1, wmid - (static_cast<unsigned>(q) << 16));
              tile_insert<K>(bk, dlast, d2, wmid + (static_cast<unsigned>(q + 1) << 16));
              tile_insert<K>(bk, dlast, d3, wmid - (static_cast<unsigned>(q + 1) << 16));
            }
          }
          if (q == window_az) {
            const float d0 = sqdist(me, mid[q * step]), d1 = sqdist(me, mid[-q * step]);
            tile_insert<K>(bk, dlast, d0, wmid + (static_cast<unsigned>(q) << 16));
            tile_insert<K>(bk, dlast, d1, wmid - (static_cast<unsigned>(q) << 16));
          }
        }
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (j < kw) {
          const unsigned w = static_cast<unsigned>(bk[j]);
          const bool filled = w != 0xffffffffu;
          const int da = filled ? static_cast<int>(w >> 16) - window_az : 0;
          const int de = filled ? static_cast<int>(w & 0xffffu) - window_el : 0;
          s_oi[threadIdx.x * kw + j] = filled ? sid[ctr + da * n_rings + de] : -1;
          s_od[threadIdx.x * kw + j] = __uint_as_float(static_cast<unsigned>(bk[j] >> 32));
        }
      }
    }
    __syncthreads();
    // cell a0 * n_rings + l is the tile's l-th: the round's rows are contiguous
    const long long first = (static_cast<long long>(a0) * n_rings + round) * kw;
    const int n_out = min(static_cast<int>(blockDim.x), tile_cells - round) * kw;
    int done = 0;
    if (((reinterpret_cast<unsigned long long>(out_idx + first) |
          reinterpret_cast<unsigned long long>(out_d2 + first)) & 15) == 0) {  // 16-byte stores where aligned
      done = n_out & ~3;
      for (int i = threadIdx.x; i < done / 4; i += blockDim.x) {
        reinterpret_cast<int4*>(out_idx + first)[i] = reinterpret_cast<const int4*>(s_oi)[i];
        reinterpret_cast<float4*>(out_d2 + first)[i] = reinterpret_cast<const float4*>(s_od)[i];
      }
    }
    for (int i = done + threadIdx.x; i < n_out; i += blockDim.x) {
      out_idx[first + i] = s_oi[i];
      out_d2[first + i] = s_od[i];
    }
    __syncthreads();
  }
}

// The window search above 16, a warp a cell (the header note): K = 32, 64 or
// 128, the arguments of range_image_tile_kernel. A cell's list holds the
// same keys as the tile kernel's (the distance's bits above w, its position
// in JAX's column order), so it is the same list, ties included; a
// candidate enters only below kBig, and a slot left empty is written
// unfilled (-1, 3e38), as the plain version leaves it.
template <int K, bool kGather>
__global__ void __launch_bounds__(kWarpThreads, 2)  // up to 128 registers: no list spills
range_image_warp_kernel(const float* __restrict__ pts, const int* __restrict__ ids, int n_az, int n_rings,
                        int window_az, int window_el, int tile_az, int k, int* __restrict__ out_idx,
                        float* __restrict__ out_d2) {
  constexpr int P = K / 32;  // list keys a lane
  extern __shared__ float4 smem4[];
  const int cols = tile_az + 2 * window_az;
  const int stride = n_rings | 1;  // odd: a ring's columns fall in distinct banks
  Point3* const rec = reinterpret_cast<Point3*>(smem4);
  int* const sid = reinterpret_cast<int*>(rec + cols * stride);
  // a warp's row of keys, on its way out (16 cols * stride bytes in: aligned)
  unsigned long long* const row = reinterpret_cast<unsigned long long*>(sid + cols * stride) + (threadIdx.x >> 5) * K;
  const int a0 = blockIdx.x * tile_az;
  stage_columns<kGather>(pts, ids, n_az, n_rings, window_az, a0, cols, stride, rec, sid);

  const int lane = threadIdx.x & 31;
  const int width = 2 * window_az + 1;  // candidates a ring
  const int W = width * (2 * window_el + 1);
  const int tile_cells = min(tile_az, n_az - a0) * n_rings;
  // visit v: ring offset 0, -1, +1, -2, ... (v / width), its columns in
  // order. Lane and register r take v = v0 + 32 r + lane, so a lane's
  // visits run 32 apart: (ring, column) of its first, and of a step of 32
  const int ring_l = lane / width, col_l = lane - ring_l * width;
  const int step_ring = 32 / width, step_col = 32 - step_ring * width;
  for (int l = threadIdx.x >> 5; l < tile_cells; l += kWarpsPerBlock) {
    const int ta = l / n_rings;
    const int e = l - ta * n_rings;
    const int ctr = (ta + window_az) * stride + e;
    unsigned long long L[P];
#pragma unroll
    for (int r = 0; r < P; ++r) L[r] = kEmptyKey;
    if (sid[ctr] >= 0) {  // the same for the whole warp
      const Point3 me = rec[ctr];
      int ring = ring_l, col = col_l;
      for (int v0 = 0; v0 < W; v0 += 32 * P) {
        const unsigned long long last = spt::warp_last<P>(L);
        unsigned long long C[P];
#pragma unroll
        for (int r = 0; r < P; ++r) {
          const int v = v0 + 32 * r + lane;
          C[r] = kEmptyKey;
          const int de = (ring & 1) ? -((ring + 1) >> 1) : ring >> 1;
          const int da = col - window_az;
          col += step_col;  // on to the lane's next visit, v + 32
          const bool wrap = col >= width;
          ring += step_ring + wrap;
          col -= wrap ? width : 0;
          if (v < W && e + de >= 0 && e + de < n_rings) {
            const float d = sqdist(me, rec[ctr + da * stride + de]);
            const unsigned long long key = spt::pack_key(
                __float_as_uint(d), (static_cast<unsigned>(da + window_az) << 16) | static_cast<unsigned>(de + window_el));
            if (d < kBig && key < last) C[r] = key;
          }
        }
        unsigned held[P];  // a register's lanes with a key below the last
        int keys = 0;
#pragma unroll
        for (int r = 0; r < P; ++r) {
          held[r] = __ballot_sync(0xffffffffu, C[r] != kEmptyKey);
          keys += __popc(held[r]);
        }
        if (!keys) continue;  // the vote: the whole chunk turned away
        if (v0 && keys <= kInsertMax) {
          // a few keys: each goes in at its rank (no sort, no merge)
#pragma unroll
          for (int r = 0; r < P; ++r) {
            for (unsigned b = held[r]; b; b &= b - 1)
              spt::warp_insert<P>(L, __shfl_sync(0xffffffffu, C[r], __ffs(b) - 1));
          }
        } else {
          spt::warp_sort<P>(C);
          if (v0 == 0) {  // the list is empty: the chunk is the list
#pragma unroll
            for (int r = 0; r < P; ++r) L[r] = C[r];
          } else {
            spt::warp_merge<P>(L, C);
          }
        }
      }
    }
    // out through shared memory: lane j writes entries j, j + 32, ...
#pragma unroll
    for (int r = 0; r < P; ++r) row[lane * P + r] = L[r];
    __syncwarp();
    const long long first = (static_cast<long long>(a0) * n_rings + l) * k;
    for (int i = lane; i < k; i += 32) {
      const unsigned long long key = row[i];
      const bool filled = key != kEmptyKey;
      const unsigned w = spt::key_lo(key);
      out_idx[first + i] = filled ? sid[ctr + (static_cast<int>(w >> 16) - window_az) * stride +
                                        static_cast<int>(w & 0xffffu) - window_el]
                                  : -1;
      out_d2[first + i] = filled ? __uint_as_float(spt::key_hi(key)) : kBig;
    }
    __syncwarp();  // the next cell reuses the row
  }
}

// Order-preserving uint32 key of a float (non-NaN): unsigned order equals
// float order, and no float's key is 0, so 0 is the neutral start of
// atomicMax. The min is kept as the max of the complemented key.
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : b | 0x80000000u;
}

__device__ __forceinline__ float from_order_key(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? k & 0x7fffffffu : ~k);
}

// Step 1 of a point as the plain version computes it: ok, az and el.
__device__ __forceinline__ bool point_angles(const float* __restrict__ points, const unsigned char* __restrict__ mask,
                                             int n, float* az, float* el) {
  const float x = __ldg(points + 3ll * n), y = __ldg(points + 3ll * n + 1), z = __ldg(points + 3ll * n + 2);
  const float r = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z)));
  *az = atan2f(y, x);
  *el = asinf(fminf(fmaxf(__fdiv_rn(z, fmaxf(r, 1e-9f)), -1.0f), 1.0f));
  return __ldg(mask + n) && isfinite(r) && r > 1e-6f;
}

// A few blocks stride over the scan, so that few same-address atomics meet
// at the two keys; a block's atomic is skipped where the key already holds.
__global__ void __launch_bounds__(kPointThreads)
range_image_elevation_kernel(const float* __restrict__ points, const unsigned char* __restrict__ mask, int N,
                             unsigned* __restrict__ keys) {
  __shared__ unsigned s_hi[kPointThreads / 32], s_lo[kPointThreads / 32];
  unsigned hi = 0u, lo = 0u;
  for (int n = blockIdx.x * blockDim.x + threadIdx.x; n < N; n += gridDim.x * blockDim.x) {
    float az, el;
    if (point_angles(points, mask, n, &az, &el)) {
      const unsigned k = order_key(el);
      hi = max(hi, k);
      lo = max(lo, ~k);
    }
  }
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) {
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, m));
    lo = max(lo, __shfl_xor_sync(0xffffffffu, lo, m));
  }
  if ((threadIdx.x & 31) == 0) {
    s_hi[threadIdx.x / 32] = hi;
    s_lo[threadIdx.x / 32] = lo;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kPointThreads / 32; ++w) {
      hi = max(hi, s_hi[w]);
      lo = max(lo, s_lo[w]);
    }
    volatile unsigned* v = keys;
    if (hi > v[0]) atomicMax(keys, hi);
    if (lo > v[1]) atomicMax(keys + 1, lo);
  }
}

__global__ void __launch_bounds__(kPointThreads)
range_image_cells_kernel(const float* __restrict__ points, const unsigned char* __restrict__ mask, int N, int n_az,
                         int n_rings, const unsigned* __restrict__ keys, float el_min, float el_max, int min_given,
                         int max_given, float pi, float inv_two_pi, int* __restrict__ occ, int* __restrict__ win1,
                         int* __restrict__ collisions, int* __restrict__ cell_out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  bool collided = false;
  if (n < N) {
    const int C = n_az * n_rings;
    float az, el;
    int cell = C;
    if (point_angles(points, mask, n, &az, &el)) {
      const float el_lo = min_given ? el_min : from_order_key(~__ldg(keys + 1));
      const float el_hi = max_given ? el_max : from_order_key(__ldg(keys));
      const float span = fmaxf(__fsub_rn(el_hi, el_lo), 1e-6f);
      float azf = floorf(__fadd_rn(__fmul_rn(__fmul_rn(__fadd_rn(az, pi), inv_two_pi), static_cast<float>(n_az)),
                                   0.5f));
      float elf = floorf(__fadd_rn(
          __fmul_rn(__fdiv_rn(__fsub_rn(el, el_lo), span), static_cast<float>(n_rings - 1)), 0.5f));
      if (!isfinite(azf)) azf = 0.0f;
      if (!isfinite(elf)) elf = 0.0f;
      int azb = static_cast<int>(static_cast<long long>(azf) % n_az);
      if (azb < 0) azb += n_az;
      const int elb = static_cast<int>(fminf(fmaxf(elf, 0.0f), static_cast<float>(n_rings - 1)));
      cell = azb * n_rings + elb;
      collided = atomicAdd(occ + cell, 1) > 0;
      atomicMax(win1 + cell, n + 1);
    }
    cell_out[n] = cell;
  }
  const unsigned b = __ballot_sync(0xffffffffu, collided);
  if ((threadIdx.x & 31) == 0 && b) atomicAdd(collisions, __popc(b));
}

__global__ void __launch_bounds__(kPointThreads)
range_image_rows_kernel(const int* __restrict__ idx_c, const float* __restrict__ d_c,
                        const int* __restrict__ cell, int N, int C, int K, int* __restrict__ out_idx,
                        float* __restrict__ out_d2) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(N) * K) return;
  const int n = static_cast<int>(i / K);
  const int j = static_cast<int>(i - static_cast<long long>(n) * K);
  const int c = __ldg(cell + n);
  int oi = n;
  float od = __int_as_float(0x7f800000);
  if (c < C) {
    const int ii = __ldg(idx_c + static_cast<long long>(c) * K + j);
    const float dd = __ldg(d_c + static_cast<long long>(c) * K + j);
    if (!(ii < 0 || dd >= kBig)) {
      oi = ii;
      od = dd;
    }
  }
  out_idx[i] = oi;
  out_d2[i] = od;
}

template <int K, bool kGather>
cudaError_t launch_tile(const float* pts, const int* ids, int n_az, int n_rings, int window_az, int window_el,
                        int tile_az, int k, int* out_idx, float* out_d2, cudaStream_t s) {
  const int threads = min(kTileThreads, (tile_az * n_rings + 31) / 32 * 32);
  const long long smem = 16ll * n_rings * (tile_az + 2 * window_az) + 8ll * threads * K;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(range_image_tile_kernel<K, kGather>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (n_az + tile_az - 1) / tile_az;
  range_image_tile_kernel<K, kGather><<<blocks, threads, static_cast<size_t>(smem), s>>>(
      pts, ids, n_az, n_rings, window_az, window_el, tile_az, k, out_idx, out_d2);
  return cudaGetLastError();
}

template <int K, bool kGather>
cudaError_t launch_warp(const float* pts, const int* ids, int n_az, int n_rings, int window_az, int window_el,
                        int tile_az, int k, int* out_idx, float* out_d2, cudaStream_t s) {
  const long long smem = 16ll * (n_rings | 1) * (tile_az + 2 * window_az) + 8ll * kWarpsPerBlock * K;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(range_image_warp_kernel<K, kGather>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (n_az + tile_az - 1) / tile_az;
  range_image_warp_kernel<K, kGather><<<blocks, kWarpThreads, static_cast<size_t>(smem), s>>>(
      pts, ids, n_az, n_rings, window_az, window_el, tile_az, k, out_idx, out_d2);
  return cudaGetLastError();
}

// The production window search: the tile kernel up to kFastK, the warp
// kernel above.
template <int K, bool kGather>
cudaError_t launch_window(const float* pts, const int* ids, int n_az, int n_rings, int window_az, int window_el,
                          int tile_az, int k, int* out_idx, float* out_d2, cudaStream_t s) {
  if constexpr (K <= spt::kFastK)
    return launch_tile<K, kGather>(pts, ids, n_az, n_rings, window_az, window_el, tile_az, k, out_idx, out_d2, s);
  else
    return launch_warp<K, kGather>(pts, ids, n_az, n_rings, window_az, window_el, tile_az, k, out_idx, out_d2, s);
}

// The window's arguments as every entry checks them: 1 <= k <= the window's
// candidates, the window within the keys' 16-bit fields.
bool window_args_ok(int window_az, int window_el, int k, int tile_az) {
  if (tile_az <= 0 || window_az < 0 || window_el < 0 || window_el > 0xffff || window_az > 0x7fff) return false;
  return k >= 1 && static_cast<long long>(k) <= (2ll * window_az + 1) * (2ll * window_el + 1);
}

}  // namespace

#define SPT_RANGE_IMAGE_CASE(KK, LAUNCH)                                                                       \
  case KK:                                                                                                     \
    return static_cast<int>(gather ? LAUNCH<KK, true>(pts, ids, n_az, n_rings, window_az, window_el, tile_az, \
                                                      k, out_idx, out_d2, s)                                   \
                                   : LAUNCH<KK, false>(pts, ids, n_az, n_rings, window_az, window_el, tile_az, \
                                                       k, out_idx, out_d2, s));
#define SPT_RANGE_IMAGE_WINDOW_CASE(KK) SPT_RANGE_IMAGE_CASE(KK, launch_window)
#define SPT_RANGE_IMAGE_SPILL_CASE(KK) SPT_RANGE_IMAGE_CASE(KK, launch_tile)

#define SPT_RANGE_IMAGE_SIMPLE_CASE(KK)                                         \
  case KK:                                                                      \
    range_image_window_simple_kernel<KK><<<blocks, kSimpleThreads, 0, s>>>(     \
        pts, ids, n_az, n_rings, window_az, window_el, out_idx, out_d2);        \
    break;

// The window search, TA = tile_az columns a block. gather = 0: pts the
// image [n_az * n_rings, 3] f32 and ids [n_az * n_rings] i32 (-1:
// unoccupied), row a * n_rings + e; gather = 1: pts the scan [N, 3] f32 and
// ids the winner's index + 1 a cell (0: unoccupied). out_idx / out_d2
// [n_az * n_rings, k], 1 <= k <= 128 (the instance best_k.cuh's instance_k
// picks; the tile planned for it) and k at most the window's candidates.
extern "C" int spt_range_image_window(const float* pts, const int* ids, int gather, int n_az, int n_rings,
                                      int window_az, int window_el, int k, int tile_az, int* out_idx,
                                      float* out_d2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_az <= 0 || n_rings <= 0) return static_cast<int>(cudaSuccess);
  if (!window_args_ok(window_az, window_el, k, tile_az)) return static_cast<int>(cudaErrorInvalidValue);
  switch (spt::instance_k(k)) {
    SPT_K_CASES(SPT_RANGE_IMAGE_WINDOW_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The one-thread tile kernel above 16 (its K-key list spills), kept for
// timing: the arguments of spt_range_image_window, 16 < k <= 128, the tile
// planned for it (ops/range_image_knn.spill_tile).
extern "C" int spt_range_image_window_spill(const float* pts, const int* ids, int gather, int n_az, int n_rings,
                                            int window_az, int window_el, int k, int tile_az, int* out_idx,
                                            float* out_d2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_az <= 0 || n_rings <= 0) return static_cast<int>(cudaSuccess);
  if (!window_args_ok(window_az, window_el, k, tile_az)) return static_cast<int>(cudaErrorInvalidValue);
  switch (spt::instance_k(k)) {
    SPT_RANGE_IMAGE_SPILL_CASE(32)
    SPT_RANGE_IMAGE_SPILL_CASE(64)
    SPT_RANGE_IMAGE_SPILL_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The first design, one thread a cell, on the image: the arguments of
// spt_range_image_window with gather = 0 and no tile; 1 <= k <= 16.
extern "C" int spt_range_image_window_simple(const float* pts, const int* ids, int n_az, int n_rings,
                                             int window_az, int window_el, int k, int* out_idx, float* out_d2,
                                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cells = n_az * n_rings;
  const int blocks = (cells + kSimpleThreads - 1) / kSimpleThreads;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  switch (k) {
    SPT_FAST_K_CASES(SPT_RANGE_IMAGE_SIMPLE_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// (a): points [N, 3] f32, mask [N] bool; keys [2] u32, zeroed by the caller:
// keys[0] the max of el's key, keys[1] the max of its complement.
extern "C" int spt_range_image_elevation(const float* points, const unsigned char* mask, int N, unsigned* keys,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = min((N + kPointThreads - 1) / kPointThreads, kElevationBlocks);
  range_image_elevation_kernel<<<blocks, kPointThreads, 0, s>>>(points, mask, N, keys);
  return static_cast<int>(cudaGetLastError());
}

// (b): occ, win1 [n_az * n_rings] i32 and collisions [1] i32 zeroed by the
// caller; el_min / el_max used where given, else from keys; cell_out [N]
// i32 (n_az * n_rings for an invalid point). pi and inv_two_pi: the f32
// values of pi and of 1 / f32(2 pi).
extern "C" int spt_range_image_cells(const float* points, const unsigned char* mask, int N, int n_az, int n_rings,
                                     const unsigned* keys, float el_min, float el_max, int min_given, int max_given,
                                     float pi, float inv_two_pi, int* occ, int* win1, int* collisions,
                                     int* cell_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0) return static_cast<int>(cudaSuccess);
  if (n_az <= 0 || n_rings <= 0) return static_cast<int>(cudaErrorInvalidValue);
  range_image_cells_kernel<<<(N + kPointThreads - 1) / kPointThreads, kPointThreads, 0, s>>>(
      points, mask, N, n_az, n_rings, keys, el_min, el_max, min_given, max_given, pi, inv_two_pi, occ, win1,
      collisions, cell_out);
  return static_cast<int>(cudaGetLastError());
}

// (d): idx_c / d_c [C, k] from the window search, cell [N] i32; out_idx /
// out_d2 [N, k].
extern "C" int spt_range_image_rows(const int* idx_c, const float* d_c, const int* cell, int N, int C, int k,
                                    int* out_idx, float* out_d2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(N) * k;
  if (total == 0) return static_cast<int>(cudaSuccess);
  range_image_rows_kernel<<<static_cast<unsigned>((total + kPointThreads - 1) / kPointThreads), kPointThreads, 0,
                            s>>>(idx_c, d_c, cell, N, C, k, out_idx, out_d2);
  return static_cast<int>(cudaGetLastError());
}
