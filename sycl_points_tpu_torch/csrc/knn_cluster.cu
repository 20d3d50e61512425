// Split-target nearest-neighbour kernels for Hopper (sm_90a), plain C
// interface: the production nn1 and knn_k.
//
// nn1   replaces the Pallas TPU kernel `nn1_pallas_prepped` / `_nn1_kernel`
//       (sycl_points_tpu/ops/pallas_knn.py): the exact 1-NN correspondence
//       search run every ICP iteration, with the 4x4 pose folded into the
//       queries in registers (the reference's transT).
// knn_k replaces `_approx_knn_single` (sycl_points_tpu/ops/knn.py), built on
//       the TPU-only `lax.approx_max_k`; here an exact k-NN (k <= 128), which
//       is what the CPU reference computes. It is built at K = 1 .. 16, 32,
//       64 and 128 (best_k.cuh); above 16 a request for k runs the smallest
//       K >= k and writes the first k entries of each K-list (ties by index,
//       so they are the k-list).
//
// What bounds them on this card: FP32 ALU issue, not bytes. A query/target
// pair costs 9 FP32 operations (3 sub, 3 mul, 2 add, 1 compare, built with
// --fmad=false so each rounds once, as in the Pallas kernel and the plain
// PyTorch versions), while the target, 12 bytes a point, streams from L2
// once per block. The first versions (knn.cu: one thread a query, the whole
// target per block) filled few SMs with few warps: nn1 at 1000 queries ran
// 8 blocks on 132 SMs, knn_k at 24,576 queries 1.45 waves of 4-warp blocks,
// latency-bound on a compare chain. The pairs that count are those against
// the valid rows only: a submap extraction holds ~430 valid rows of its
// 16,384-row capacity, so a sweep of the whole capacity spends ~97% of its
// pairs on +inf rows. Each stream's extent (1 + the index of its last valid
// row, made by prep_target on the device) bounds the sweep instead.
//
// The design:
//   * The grid is query tiles x S target slices. The S blocks of one query
//     tile form a thread-block cluster (S = 1 to 16, chosen by the wrapper
//     from Q so the grid holds about 4 blocks an SM); block r scans only
//     slice r of the stream's extent, so a small query count still fills the
//     card.
//   * The slices: the extent [0, extent) is cut into kUnit-row units (the
//     float4 spans of every warp group), rounded up into the +inf padding
//     (prep_target pads to a multiple of kTile, so the rounded extent stays
//     inside Mp), and block r takes units [r n / S, (r + 1) n / S). The
//     slices never overlap, so no target enters two blocks' lists, and a
//     stream of a few hundred valid rows still spreads over every block of
//     its cluster. A target prepared without an extent sweeps all of Mp.
//     Every row past the extent is +inf, which no strict `<` takes, so
//     cutting the sweep there cannot change a result.
//   * One query a thread. A block's 4 warps form G = 4 / QW groups of QW
//     warps: each group holds the block's QT = 32 * QW queries and scans 1/G
//     of every staged tile, so a block of 32 queries still has 4 warps at
//     work. knn_k runs QT = 128, nn1 32 to 128 by Q.
//   * Registers set the occupancy: 64 a thread up to k = 10 (8 blocks, 32
//     warps an SM), 80 above (6 blocks). Two queries a thread, which would
//     share each shared-memory load, cost more in occupancy than they saved.
//     The first instances above 16 (kept as spt_knn_k_spill_batched
//     for timing) took what the compiler asked: their lists of 64 to 256
//     registers spill at K = 64 and 128, and their merge lists, 2 x 128
//     threads x K floats (128 KiB at K = 128, one block an SM), fit a block's
//     227 KB at the 128-query tile; at most 8 slices, so that a cluster never
//     needs 16 SMs of one GPC at once.
//   * The slice streams through two shared-memory tiles of up to kTile rows
//     loaded with cp.async while the other is scanned: whole aligned units of
//     the prepared target, no mask, no edge test. A float4 load is a
//     warp-wide broadcast feeding 4 distances.
//   * Each thread keeps a sorted partial best-k in registers, with knn.cu's
//     insertion rule (strict `<`, after entries <= d, targets in index
//     order), so a partial list is the k smallest (d, idx) of its targets.
//   * knn_k prunes: the insertions, not the distances, held the unpruned
//     design back (the voxel order makes the distance fall target after
//     target for long runs, and a warp inserts when any lane does). Every
//     block first takes the best-k of every 16th target of its slice; the
//     cluster's least k-th distance over these samples, read through
//     distributed shared memory, bounds the query's true k-th distance from
//     above, and the full scan then inserts only distances <= that bound.
//     Anything pruned has k real neighbours closer, so the result does not
//     change. With fewer than k samples in every block the bound stays +inf.
//   * Merge: each group writes its lists to its block's shared memory,
//     cluster.sync(), then block r merges 1/S of the tile's queries by
//     reading every peer's lists through cluster.map_shared_rank, by
//     (d, idx) in lexicographic order, and writes idx/d2. A last
//     cluster.sync() keeps every block's shared memory alive until all peers
//     have read it. With the sweep cut to the extent, the merge and the
//     launch are most of a fleet's nn1: the slice count trades the two.
//
// Above 16 (K = 32, 64, 128: knn_warp_kernel), a warp a query, 8 queries a
// block, the same slices, staging, extent and sampled bound tau:
//   * The warp's list is the K smallest keys (d2 bits << 32 | idx) so far,
//     K/32 a lane in registers (warp_sort.cuh): d2 >= 0, so the key orders
//     as (d, idx), and any visiting order gives the same list.
//   * Lanes split each staged tile, one target a lane a step: a target is
//     admitted when d <= tau and its key is below the list's last. The
//     admitted go to a K-key buffer of the warp in shared memory (ballot and
//     popcount place them); a full buffer, and the last one, is bitonic-sorted
//     and merged into the list. No insertion shifts a list.
//   * Phase 1 fills the list from every 16th target of the slice; its last
//     distance, the least over the cluster, is tau, and the list restarts.
//   * The cluster's S lists of a query are merged by warp w of block w % S,
//     a bitonic merge a peer, through distributed shared memory.
//   * Query tiles run along the grid's x with the slices (x = tile * S +
//     rank), so Q is bounded by the grid's 2^31 blocks, not y's 65,535.
//
// Why the result equals knn.cu's bit for bit, ties included: that kernel
// returns the k smallest (d, idx) pairs in lexicographic order; a merge of
// per-slice k-smallest lists by the same key returns the same pairs, for any
// partition of the rows into disjoint slices. Slots with no valid neighbour
// stay idx 0, d2 = +inf: an +inf distance never enters a list, and (inf, 0)
// loses to any finite entry in the merge; a stream of extent 0 scans nothing
// and writes idx 0, d2 = +inf at every slot.
//
// The stream axis: a fleet of B independent streams runs as one launch, the
// grid's z dimension numbering the streams. Block z offsets its target
// (3 * Mp floats a stream), extent (1 int), queries (3 * Q), pose (16) and
// outputs (Q * K) by z; a cluster stays inside one stream, so every block computes what it
// computes in a single-stream launch, and the result equals B single-stream
// launches bit for bit. A single stream is the B = 1 case of the same entries.
//
// Every entry point launches on the caller's stream, allocates nothing, and
// returns the first error of cudaFuncSetAttribute, cudaLaunchKernelEx or
// cudaGetLastError, so a refused cluster launch raises in the wrapper.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "best_k.cuh"
#include "knn_cluster.cuh"
#include "warp_sort.cuh"

namespace cg = cooperative_groups;

namespace {

using spt::cp_async16;
using spt::cp_async_commit;
using spt::cp_async_wait;
using spt::insert_lex;
using spt::lex_less;
using spt::scan_span;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 512;         // targets a staged tile; prep_target pads to it
constexpr int kUnit = 32;          // rows a unit of the slices: whole float4 spans of G <= 4 groups
constexpr int kMaxSlices = 16;     // blocks a cluster; above 8 is a non-portable size
constexpr int kSampleStride = 16;  // knn_k's pruning sample: every 16th target
constexpr int kMaxQueryTiles = 65535;
constexpr int kMaxStreams = 65535;  // the grid's z extent

template <int K, int QW, bool kPrune>
struct Cfg {
  static constexpr int G = kWarps / QW;    // warp groups, each scans 1/G of a tile
  static constexpr int QT = 32 * QW;       // queries a block (and a cluster)
  static constexpr int kTileFloats = 2 * 3 * kTile;       // two staged tiles
  static constexpr int kListFloats = 2 * G * QT * K;      // (d, idx) lists
  static constexpr int kMain = kTileFloats > kListFloats ? kTileFloats : kListFloats;
  static constexpr int kPub = kPrune ? G * QT : 0;        // sampled k-th distances
  static constexpr size_t kSmemBytes = sizeof(float) * (kMain + kPub);
  // 64 / 80 registers a thread up to k = 16; the large instances take more
  static constexpr int kMinBlocks = K <= 10 ? 8 : K <= spt::kFastK ? 6 : K <= 32 ? 2 : 1;
  static_assert(kWarps % QW == 0, "QW divides the block's warps");
  static_assert(QT % kMaxSlices == 0, "every slice count divides the query tile");
  static_assert(kUnit % (4 * G) == 0 && kTile % kUnit == 0, "a unit is whole float4 spans of every group");
};

template <int K, int QW, bool kPose, bool kPrune>
__global__ void __launch_bounds__(kThreads, (Cfg<K, QW, kPrune>::kMinBlocks))
knn_cluster_kernel(const float* __restrict__ tgt, int Mp, const int* __restrict__ extent,
                   const float* __restrict__ queries, int Q, const float* __restrict__ pose, int k,
                   int* __restrict__ out_idx, float* __restrict__ out_d2) {
  using C = Cfg<K, QW, kPrune>;
  const int kw = spt::row_count<K>(k);  // entries a row of the output
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int S = static_cast<int>(cluster.num_blocks());
  const int g = (threadIdx.x / 32) / QW;
  const int slot = threadIdx.x % C::QT;  // the thread's query in the block's tile
  const int qbase = blockIdx.y * C::QT;
  // this block's stream
  const size_t z = blockIdx.z;
  tgt += z * 3 * static_cast<size_t>(Mp);
  queries += z * 3 * static_cast<size_t>(Q);
  if constexpr (kPose) pose += z * 16;
  out_idx += z * static_cast<size_t>(Q) * kw;
  out_d2 += z * static_cast<size_t>(Q) * kw;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (qbase + slot < Q) {
    const float* p = queries + 3 * static_cast<size_t>(qbase + slot);
    if constexpr (kPose) {
      // transform_points order: (R p) as a row-wise sum, then + t.
      qx = pose[0] * p[0] + pose[1] * p[1] + pose[2] * p[2] + pose[3];
      qy = pose[4] * p[0] + pose[5] * p[1] + pose[6] * p[2] + pose[7];
      qz = pose[8] * p[0] + pose[9] * p[1] + pose[10] * p[2] + pose[11];
    } else {
      qx = p[0];
      qy = p[1];
      qz = p[2];
    }
  }

  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = CUDART_INF_F;
    bi[s] = 0;
  }
  float cap = CUDART_INF_F, lim = CUDART_INF_F;

  // This block's slice: rows [r0, r1) of the stream's extent, whole units,
  // in ascending index order.
  const int ext = extent == nullptr ? Mp : min(max(extent[z], 0), Mp);
  const int n_units = (ext + kUnit - 1) / kUnit;
  const int r0 = static_cast<int>(static_cast<long long>(rank) * n_units / S) * kUnit;
  const int r1 = static_cast<int>(static_cast<long long>(rank + 1) * n_units / S) * kUnit;
  float* tiles = smem;

  if constexpr (kPrune) {
    // Phase 1: best-k of every kSampleStride-th target of the slice, staged
    // kTile samples at a time; a short last batch is padded with +inf to a
    // whole unit.
    const int n_sample = (r1 - r0) / kSampleStride;
    for (int c0 = 0; c0 < n_sample; c0 += kTile) {
      const int n = min(kTile, n_sample - c0);
      const int n_pad = (n + kUnit - 1) / kUnit * kUnit;
      __syncthreads();
      for (int j = threadIdx.x; j < n_pad; j += kThreads) {
        float x = CUDART_INF_F, y = CUDART_INF_F, w = CUDART_INF_F;
        if (j < n) {
          const size_t t = static_cast<size_t>(r0) + static_cast<size_t>(c0 + j) * kSampleStride;
          x = tgt[t];
          y = tgt[static_cast<size_t>(Mp) + t];
          w = tgt[2 * static_cast<size_t>(Mp) + t];
        }
        tiles[j] = x;
        tiles[kTile + j] = y;
        tiles[2 * kTile + j] = w;
      }
      __syncthreads();
      const int span = n_pad / C::G;
      scan_span<K>(tiles, tiles + kTile, tiles + 2 * kTile, g * span, (g + 1) * span,
                   r0 + c0 * kSampleStride, kSampleStride, qx, qy, qz, bd, bi, lim, cap);
    }
    // The cluster's bound: the least sampled k-th distance over every block
    // and group. nextafter keeps a distance equal to it: such a target can
    // still win on its index.
    float* pub = smem + C::kMain;
    pub[g * C::QT + slot] = bd[K - 1];
    cluster.sync();
    float tau = CUDART_INF_F;
    for (int r = 0; r < S; ++r) {
      const float* peer = cluster.map_shared_rank(pub, r);
#pragma unroll
      for (int gg = 0; gg < C::G; ++gg) tau = fminf(tau, peer[gg * C::QT + slot]);
    }
    cap = lim = nextafterf(tau, CUDART_INF_F);
#pragma unroll
    for (int s = 0; s < K; ++s) {
      bd[s] = CUDART_INF_F;
      bi[s] = 0;
    }
    __syncthreads();  // the sample buffer is free for the tiles
  }

  // Phase 2: the whole slice, kTile rows a step (the last one n < kTile rows,
  // whole units), double-buffered through cp.async.
  auto stage = [&](int start, int n, int buf) {
    float* dst = tiles + buf * 3 * kTile;
    const int n4 = n / 4;
    for (int c = threadIdx.x; c < 3 * n4; c += kThreads) {
      const int row = c / n4;
      const int off = (c - row * n4) * 4;
      cp_async16(dst + row * kTile + off, tgt + static_cast<size_t>(row) * Mp + start + off);
    }
    cp_async_commit();
  };
  const int n_steps = (r1 - r0 + kTile - 1) / kTile;
  if (n_steps > 0) stage(r0, min(kTile, r1 - r0), 0);
  for (int t = 0; t < n_steps; ++t) {
    const int start = r0 + t * kTile;
    const int n = min(kTile, r1 - start);
    const int buf = t & 1;
    if (t + 1 < n_steps) {
      stage(start + kTile, min(kTile, r1 - start - kTile), buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sx = tiles + buf * 3 * kTile;
    const int chunk = n / C::G;
    scan_span<K>(sx, sx + kTile, sx + 2 * kTile, g * chunk, (g + 1) * chunk, start, 1, qx, qy, qz, bd, bi,
                 lim, cap);
    __syncthreads();
  }

  // Merge: every group's lists into this block's shared memory ...
  float2* lists = reinterpret_cast<float2*>(smem);
  float2* mine = lists + (g * C::QT + slot) * K;
#pragma unroll
  for (int s = 0; s < K; ++s) mine[s] = make_float2(bd[s], __int_as_float(bi[s]));
  cluster.sync();
  // ... then block `rank` merges its share of the tile's queries from every
  // peer's lists, in lexicographic (d, idx) order.
  const int per_block = C::QT / S;
  if (threadIdx.x < per_block) {
    const int q_slot = rank * per_block + threadIdx.x;
    float md[K];
    int mi[K];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      md[s] = CUDART_INF_F;
      mi[s] = 0;
    }
    for (int r = 0; r < S; ++r) {
      const float2* peer = cluster.map_shared_rank(lists, r);
#pragma unroll
      for (int gg = 0; gg < C::G; ++gg) {
        const float2* l = peer + (gg * C::QT + q_slot) * K;
        if constexpr (K <= spt::kFastK) {
          float2 e[K];
#pragma unroll
          for (int s = 0; s < K; ++s) e[s] = l[s];
#pragma unroll
          for (int s = 0; s < K; ++s) {
            const float d = e[s].x;
            const int idx = __float_as_int(e[s].y);
            // a list ascends by (d, idx): the rest of it cannot enter either
            if (!lex_less(d, idx, md[K - 1], mi[K - 1])) break;
            insert_lex<K>(md, mi, d, idx);
          }
        } else {  // the long lists load an entry at a time
          for (int s = 0; s < K; ++s) {
            const float2 e = l[s];
            const int idx = __float_as_int(e.y);
            if (!lex_less(e.x, idx, md[K - 1], mi[K - 1])) break;
            insert_lex<K>(md, mi, e.x, idx);
          }
        }
      }
    }
    const int q = qbase + q_slot;
    if (q < Q) {
#pragma unroll
      for (int s = 0; s < K; ++s) {
        if (s < kw) {
          out_idx[static_cast<size_t>(q) * kw + s] = mi[s];
          out_d2[static_cast<size_t>(q) * kw + s] = md[s];
        }
      }
    }
  }
  cluster.sync();  // no block exits while a peer may still read its lists
}

template <int K, int QW, bool kPose, bool kPrune>
int launch(const float* tgt, int Mp, const int* extent, const float* queries, int Q, const float* pose, int B,
           int slices, int k, int* out_idx, float* out_d2, void* stream) {
  using C = Cfg<K, QW, kPrune>;
  if (Q <= 0 || B <= 0) return static_cast<int>(cudaSuccess);
  const int n_qtiles = (Q + C::QT - 1) / C::QT;
  const bool pow2 = slices > 0 && (slices & (slices - 1)) == 0;
  const int max_slices = K <= spt::kFastK ? kMaxSlices : 8;
  if (Mp % kTile != 0 || n_qtiles > kMaxQueryTiles || B > kMaxStreams || !pow2 || slices > max_slices)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = knn_cluster_kernel<K, QW, kPose, kPrune>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::kSmemBytes));
  if (err == cudaSuccess && slices > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = slices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(slices, n_qtiles, B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = C::kSmemBytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tgt, Mp, extent, queries, Q, pose, k, out_idx, out_d2);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// k above 16: a warp a query
// ---------------------------------------------------------------------------

constexpr int kWarpQueries = 8;  // queries a block (and a cluster), a warp each
constexpr int kWarpThreads = 32 * kWarpQueries;
constexpr int kMaxWarpSlices = 8;
constexpr unsigned long long kInitKey = 0x7f80000000000000ull;  // (+inf, idx 0): an empty slot

template <int K>
struct WarpCfg {
  static constexpr int P = K / 32;                          // list keys a lane
  static constexpr int kTileFloats = 2 * 3 * kTile;         // two staged tiles
  static constexpr int kListFloats = 2 * kWarpQueries * K;  // the lists the cluster merges (64-bit keys)
  static constexpr int kMain = kTileFloats > kListFloats ? kTileFloats : kListFloats;
  static constexpr int kBufFloats = 2 * kWarpQueries * K;   // the admitted candidates, K keys a warp
  static constexpr size_t kSmemBytes = sizeof(float) * (kMain + kBufFloats + kWarpQueries);
  static_assert(K % 32 == 0 && kMain % 2 == 0, "whole keys a lane; the buffer 8-byte aligned");
};

// The warp's buffer (cnt keys, warp-uniform) sorted and merged into its list.
template <int P>
__device__ __forceinline__ void flush_admitted(unsigned long long (&L)[P], const unsigned long long* buf, int& cnt,
                                               unsigned long long& last, int lane) {
  __syncwarp();
  unsigned long long c[P];
#pragma unroll
  for (int r = 0; r < P; ++r) c[r] = lane * P + r < cnt ? buf[lane * P + r] : spt::kEmptyKey;
  __syncwarp();
  spt::warp_sort<P>(c);
  spt::warp_merge<P>(L, c);
  last = spt::warp_last<P>(L);
  cnt = 0;
}

// One target a lane: admitted when live, d <= tau and its key below the
// list's last; the admitted take the next buffer slots in lane order, a full
// buffer being merged first.
template <int P>
__device__ __forceinline__ void admit(float d, int idx, bool live, float tau, unsigned long long (&L)[P],
                                      unsigned long long* buf, int& cnt, unsigned long long& last, int lane) {
  const unsigned long long key = spt::pack_key(__float_as_uint(d), static_cast<unsigned>(idx));
  bool in = live && d <= tau && key < last;
  unsigned b = __ballot_sync(0xffffffffu, in);
  if (b == 0) return;
  if (cnt + __popc(b) > 32 * P) {
    flush_admitted<P>(L, buf, cnt, last, lane);
    in = in && key < last;
    b = __ballot_sync(0xffffffffu, in);
  }
  if (in) buf[cnt + __popc(b & ((1u << lane) - 1u))] = key;
  cnt += __popc(b);
}

template <int K>
__global__ void __launch_bounds__(kWarpThreads)
knn_warp_kernel(const float* __restrict__ tgt, int Mp, const int* __restrict__ extent,
                const float* __restrict__ queries, int Q, int k, int* __restrict__ out_idx,
                float* __restrict__ out_d2) {
  using C = WarpCfg<K>;
  constexpr int P = C::P;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int S = static_cast<int>(cluster.num_blocks());
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = static_cast<int>(blockIdx.x / S) * kWarpQueries + warp;
  const bool live = q < Q;
  // this block's stream
  const size_t z = blockIdx.z;
  tgt += z * 3 * static_cast<size_t>(Mp);
  queries += z * 3 * static_cast<size_t>(Q);
  out_idx += z * static_cast<size_t>(Q) * k;
  out_d2 += z * static_cast<size_t>(Q) * k;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    qx = queries[3 * static_cast<size_t>(q)];
    qy = queries[3 * static_cast<size_t>(q) + 1];
    qz = queries[3 * static_cast<size_t>(q) + 2];
  }
  unsigned long long* const buf = reinterpret_cast<unsigned long long*>(smem + C::kMain) + warp * K;
  float* const pub = smem + C::kMain + C::kBufFloats;
  unsigned long long L[P];
#pragma unroll
  for (int r = 0; r < P; ++r) L[r] = kInitKey;
  unsigned long long last = kInitKey;
  int cnt = 0;
  float tau = CUDART_INF_F;

  const int ext = extent == nullptr ? Mp : min(max(extent[z], 0), Mp);
  const int n_units = (ext + kUnit - 1) / kUnit;
  const int r0 = static_cast<int>(static_cast<long long>(rank) * n_units / S) * kUnit;
  const int r1 = static_cast<int>(static_cast<long long>(rank + 1) * n_units / S) * kUnit;
  float* tiles = smem;

  // Phase 1: the list of every kSampleStride-th target of the slice, kTile
  // samples a step, a short last batch padded with +inf to whole warps.
  const int n_sample = (r1 - r0) / kSampleStride;
  for (int c0 = 0; c0 < n_sample; c0 += kTile) {
    const int n = min(kTile, n_sample - c0);
    const int n_pad = (n + 31) / 32 * 32;
    __syncthreads();
    for (int j = threadIdx.x; j < n_pad; j += kWarpThreads) {
      float x = CUDART_INF_F, y = CUDART_INF_F, w = CUDART_INF_F;
      if (j < n) {
        const size_t t = static_cast<size_t>(r0) + static_cast<size_t>(c0 + j) * kSampleStride;
        x = tgt[t];
        y = tgt[static_cast<size_t>(Mp) + t];
        w = tgt[2 * static_cast<size_t>(Mp) + t];
      }
      tiles[j] = x;
      tiles[kTile + j] = y;
      tiles[2 * kTile + j] = w;
    }
    __syncthreads();
    for (int j = lane; j < n_pad; j += 32)
      admit<P>(spt::sqdist(qx, qy, qz, tiles[j], tiles[kTile + j], tiles[2 * kTile + j]),
               r0 + (c0 + j) * kSampleStride, live, tau, L, buf, cnt, last, lane);
  }
  if (cnt) flush_admitted<P>(L, buf, cnt, last, lane);
  // The cluster's bound: the least sampled K-th distance of the query over
  // its blocks (+inf with fewer than K samples in each).
  if (lane == 0) pub[warp] = __uint_as_float(spt::key_hi(last));
  cluster.sync();
  for (int r = 0; r < S; ++r) tau = fminf(tau, cluster.map_shared_rank(pub, r)[warp]);
#pragma unroll
  for (int r = 0; r < P; ++r) L[r] = kInitKey;
  last = kInitKey;

  // Phase 2: the whole slice, kTile rows a step, double-buffered through
  // cp.async.
  auto stage = [&](int start, int n, int b) {
    float* dst = tiles + b * 3 * kTile;
    const int n4 = n / 4;
    for (int c = threadIdx.x; c < 3 * n4; c += kWarpThreads) {
      const int row = c / n4;
      const int off = (c - row * n4) * 4;
      cp_async16(dst + row * kTile + off, tgt + static_cast<size_t>(row) * Mp + start + off);
    }
    cp_async_commit();
  };
  const int n_steps = (r1 - r0 + kTile - 1) / kTile;
  if (n_steps > 0) stage(r0, min(kTile, r1 - r0), 0);
  for (int t = 0; t < n_steps; ++t) {
    const int start = r0 + t * kTile;
    const int n = min(kTile, r1 - start);
    const int b = t & 1;
    if (t + 1 < n_steps) {
      stage(start + kTile, min(kTile, r1 - start - kTile), b ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sx = tiles + b * 3 * kTile;
    for (int j = lane; j < n; j += 32)
      admit<P>(spt::sqdist(qx, qy, qz, sx[j], sx[kTile + j], sx[2 * kTile + j]), start + j, live, tau, L, buf, cnt,
               last, lane);
    __syncthreads();
  }
  if (cnt) flush_admitted<P>(L, buf, cnt, last, lane);

  // Merge: warp w of block w % S merges the query's lists of every block.
  if (S > 1) {
    unsigned long long* lists = reinterpret_cast<unsigned long long*>(smem);
#pragma unroll
    for (int r = 0; r < P; ++r) lists[warp * K + lane * P + r] = L[r];
    cluster.sync();
    if (warp % S == rank) {
      for (int rr = 0; rr < S; ++rr) {
        if (rr == rank) continue;
        const unsigned long long* peer = cluster.map_shared_rank(lists, rr) + warp * K;
        unsigned long long c[P];
#pragma unroll
        for (int r = 0; r < P; ++r) c[r] = peer[lane * P + r];
        spt::warp_merge<P>(L, c);
      }
    }
  }
  if (warp % S == rank && live) {
#pragma unroll
    for (int r = 0; r < P; ++r) {
      const int i = lane * P + r;
      if (i < k) {
        out_idx[static_cast<size_t>(q) * k + i] = static_cast<int>(spt::key_lo(L[r]));
        out_d2[static_cast<size_t>(q) * k + i] = __uint_as_float(spt::key_hi(L[r]));
      }
    }
  }
  if (S > 1) cluster.sync();  // no block exits while a peer may still read its lists
}

template <int K>
int launch_warp(const float* tgt, int Mp, const int* extent, const float* queries, int Q, int B, int slices, int k,
                int* out_idx, float* out_d2, void* stream) {
  using C = WarpCfg<K>;
  if (Q <= 0 || B <= 0) return static_cast<int>(cudaSuccess);
  const long long n_blocks = static_cast<long long>((Q + kWarpQueries - 1) / kWarpQueries) * slices;
  const bool pow2 = slices > 0 && (slices & (slices - 1)) == 0;
  if (Mp % kTile != 0 || n_blocks > 0x7fffffffll || B > kMaxStreams || !pow2 || slices > kMaxWarpSlices)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = knn_warp_kernel<K>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = slices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_blocks), 1, B);
  cfg.blockDim = dim3(kWarpThreads, 1, 1);
  cfg.dynamicSmemBytes = C::kSmemBytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tgt, Mp, extent, queries, Q, k, out_idx, out_d2);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int QW>
int launch_nn1(const float* tgt, int Mp, const int* extent, const float* queries, int Q, const float* pose, int B,
               int slices, int* out_idx, float* out_d2, void* stream) {
  if (pose != nullptr)
    return launch<1, QW, true, false>(tgt, Mp, extent, queries, Q, pose, B, slices, 1, out_idx, out_d2, stream);
  return launch<1, QW, false, false>(tgt, Mp, extent, queries, Q, pose, B, slices, 1, out_idx, out_d2, stream);
}

}  // namespace

// Exact 1-NN of the queries [B,Q,3] of B streams (moved by their poses
// [B,4,4] row-major if not null) against their prepared targets [B,3,Mp]:
// stream b's queries search stream b's target only, its rows [0, extent[b])
// (all Mp if extent is null). The wrapper chooses from B * Q the queries a
// cluster (query_tile: 32, 64 or 128) and the target slices, blocks a
// cluster (slices: 1, 2, 4, 8 or 16).
extern "C" int spt_nn1_batched(const float* tgt, int Mp, const int* extent, const float* queries, int Q,
                               const float* pose, int B, int query_tile, int slices, int* out_idx, float* out_d2,
                               void* stream) {
  switch (query_tile) {
    case 32:
      return launch_nn1<1>(tgt, Mp, extent, queries, Q, pose, B, slices, out_idx, out_d2, stream);
    case 64:
      return launch_nn1<2>(tgt, Mp, extent, queries, Q, pose, B, slices, out_idx, out_d2, stream);
    case 128:
      return launch_nn1<4>(tgt, Mp, extent, queries, Q, pose, B, slices, out_idx, out_d2, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

#define SPT_KNN_CLUSTER_CASE(KV)                                                                          \
  case KV:                                                                                                \
    return launch<KV, 4, false, true>(tgt, Mp, extent, queries, Q, nullptr, B, slices, k, out_idx, out_d2, \
                                      stream);

// Exact k-NN (1 <= k <= 128) of the queries [B,Q,3] of B streams against
// their prepared targets [B,3,Mp] and extents [B] (all Mp if null),
// ascending by (d, idx): up to 16, 128 queries a cluster; above, a warp a
// query (knn_warp_kernel), 8 queries a cluster; the slices the wrapper
// chooses from B * Q (as for nn1; at most 8 for k above 16).
extern "C" int spt_knn_k_batched(const float* tgt, int Mp, const int* extent, const float* queries, int Q, int B,
                                 int k, int slices, int* out_idx, float* out_d2, void* stream) {
  switch (spt::instance_k(k)) {
    SPT_FAST_K_CASES(SPT_KNN_CLUSTER_CASE)
    case 32:
      return launch_warp<32>(tgt, Mp, extent, queries, Q, B, slices, k, out_idx, out_d2, stream);
    case 64:
      return launch_warp<64>(tgt, Mp, extent, queries, Q, B, slices, k, out_idx, out_d2, stream);
    case 128:
      return launch_warp<128>(tgt, Mp, extent, queries, Q, B, slices, k, out_idx, out_d2, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The first instances above 16: one thread a query with its K-list
// in registers (spilled at K = 64 and 128), 128 queries a cluster; for
// timing against knn_warp_kernel. 16 < k <= 128.
extern "C" int spt_knn_k_spill_batched(const float* tgt, int Mp, const int* extent, const float* queries, int Q,
                                       int B, int k, int slices, int* out_idx, float* out_d2, void* stream) {
  switch (k > spt::kFastK ? spt::instance_k(k) : 0) {
    SPT_KNN_CLUSTER_CASE(32)
    SPT_KNN_CLUSTER_CASE(64)
    SPT_KNN_CLUSTER_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
