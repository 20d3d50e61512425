// Three formulations of the exact 1-NN for Hopper (sm_90a), plain C
// interface. They replace the TPU variant study `wrap(kernel, query_tile,
// target_chunk, with_bias).nn1` (scripts/bench_nn1_variants.py:37-74,
// pallas_call at :55); its v0 is the production `nn1`, knn_cluster.cu's
// cluster kernel.
//
// nn1_bias     (v1, `make_v1`, :106-131) adds a 0 / 3.0e38 bias to every
//              distance in place of a select on the mask.
// nn1_lanes<L> (v2, `make_v2`, :134-165) is v1 with L lanes a query (8 or
//              32), each keeping its own running (best, idx) over its rows,
//              reduced once at the end: v2's per-column accumulator.
// nn1_unroll2  (v3, `make_v3`, :168-200) is v1 with two targets a step,
//              folded into one candidate before the running best.
//
// What bounds them on the card: FP32 issue. A query/target pair costs 9
// FP32 operations of the distance and its compare (3 sub, 3 mul, 2 add, 1
// compare; the bias adds one); the target is 16 B a row, read once a query
// tile from L2. ~0.006 ms at 1,000 queries against 24,000 valid rows.
//
// All three run in nn1_ring.cuh's pipeline, as nn1_tiled does (nn1_tiles.cu):
// two query slots a thread, the target packed once and streamed by bulk
// copies through a two-stage mbarrier ring, split over gridDim.y, each
// (query, split) merged by a 64-bit atomicMin of (d2 bits << 32) | index.
// Their forms read a bias-packed target (ops/cuda_knn.pack_bias_target):
// [M', 4] f32 rows x, y, z, b, b = 0 for a valid row and kBig for a masked
// one, masked rows keeping their coordinates, M' even (one masked pad row
// (0, 0, 0, kBig) after an odd M). The bias rides in the pad lane that the
// 16-byte row moves anyway, so v1 costs one FADD a pair and no load.
//   - Trait: valid squared distances must stay below kBig (coordinates below
//     ~1e19). A masked row's biased distance is kBig or above (+inf for an
//     infinite coordinate, NaN for a NaN one), and the running best starts
//     at kBig, so the strict `<` never takes it; a split whose best is still
//     kBig posts nothing, so a query with no valid row unpacks to idx 0,
//     d2 = +inf (v2 on the TPU returns idx 2^31 - 1, d = 3e38 there).
//   - Bit-equality with nn1_plain: d + 0.0f == d for d >= 0, and the library
//     is built with --fmad=false, so the biased distance of a valid row is
//     spt::sqdist's, and the merge keeps the first least index.
//   - nn1_lanes<L> is BiasForm<L>, v1's compare over rows l, l + L, ... of
//     each chunk for lane l = threadIdx.x % L of a query's L consecutive
//     threads; v1 is BiasForm<1>. There is no reduction across lanes a
//     chunk: after the split's last chunk the ring's __shfl_xor_sync reduce
//     (log2 L steps of two shuffles a query) takes the smaller distance and,
//     on equal distance, the smaller index (v2's smallest winning index
//     among tied columns), and lane 0 posts the split's word. Each lane's
//     strict `<` in index order keeps its first least row, so the reduce
//     gives the split's first least row. Its query_tile counts (query, lane)
//     slots, query_tile / 2 threads as for every form: a block holds
//     query_tile / L queries and reads the target L times as often from L2
//     as v1 at the same tile; the wrapper's split (ops/cuda_knn.nn1_tiled_span
//     with lanes = L) counts those query blocks.
//   - nn1_unroll2 takes rows j and j + 1, adjacent, a step. For each query
//     the pair folds to fminf(d0, d1) with index j where it equals d0: v3's
//     `d0 <= d1` select, j on a tie, written so that a NaN on either side
//     loses to its partner. The fold's winner meets the running best with a
//     strict `<`, so pairs taken in index order keep the first least index
//     (a row paired with one half a stage away would let a later low index
//     beat an earlier high one on a tie). The last lone row of an odd M is
//     handled by the packing, not the kernel: M' is even, every span is
//     rounded up to even by the wrapper (ops/cuda_knn.nn1_even_span) and every
//     chunk is a multiple of 512, so each chunk a bulk copy fills holds an
//     even count of rows and row j + 1 is never stale.
//
// The first designs stay for timing (nn1_bias_simple, nn1_lanes_simple,
// nn1_unroll2_simple): the raw target and its mask staged by the computing
// threads between two __syncthreads, one scalar shared-memory load a
// coordinate (and the bias) a pair, no overlap of copy and compute, no
// split of the target. nn1_bias_simple and nn1_unroll2_simple run one
// thread a query, 128 threads a block (8 of the 132 SMs at 1,000 queries);
// nn1_lanes_simple<L> runs L consecutive threads a query, 256 threads a
// block, with the same end-of-target shuffle reduce.
//
// All are exact and equal nn1_plain bit for bit. The queries come already
// moved by the pose, as in the TPU study. Every entry point launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>

#include "nn1_common.cuh"
#include "nn1_ring.cuh"

namespace {

using spt::sqdist;
using spt::stage_tile;

constexpr int kThreads = 128;       // nn1_bias_simple, nn1_unroll2_simple: one thread a query
constexpr int kLaneThreads = 256;   // nn1_lanes_simple: 256 / L queries a block
constexpr int kTile = 2048;
constexpr float kBig = 3.0e38f;     // the TPU kernels' _BIG

__device__ __forceinline__ void load_query(const float* __restrict__ queries, int qi,
                                           int Q, float& qx, float& qy, float& qz) {
  qx = qy = qz = 0.f;
  if (qi < Q) {
    qx = queries[3 * qi + 0];
    qy = queries[3 * qi + 1];
    qz = queries[3 * qi + 2];
  }
}

// v1, first design. A masked or padded target keeps its coordinates and gets the bias
// kBig, so its biased distance rounds to kBig (or above) and the running
// best, which starts at kBig, never takes it: a row with no valid target keeps
// idx 0. Valid squared distances must stay below kBig (coordinates below
// ~1e19). The epilogue maps d >= kBig to +inf, as pallas_knn.py does after its
// kernel, so the timed work stays one launch.
__global__ void __launch_bounds__(kThreads)
nn1_bias_kernel(const float* __restrict__ tgt, const unsigned char* __restrict__ mask,
                int M, const float* __restrict__ queries, int Q,
                int* __restrict__ out_idx, float* __restrict__ out_d2) {
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  __shared__ float sz[kTile];
  __shared__ float sb[kTile];

  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  float qx, qy, qz;
  load_query(queries, qi, Q, qx, qy, qz);

  float best_d = kBig;
  int best_i = 0;
  for (int base = 0; base < M; base += kTile) {
    __syncthreads();
    for (int j = threadIdx.x; j < kTile; j += blockDim.x) {
      int g = base + j;
      float x = 0.f, y = 0.f, z = 0.f, b = kBig;
      if (g < M) {
        x = tgt[3 * g + 0];
        y = tgt[3 * g + 1];
        z = tgt[3 * g + 2];
        b = mask[g] != 0 ? 0.f : kBig;
      }
      sx[j] = x;
      sy[j] = y;
      sz[j] = z;
      sb[j] = b;
    }
    __syncthreads();
    const int n = min(kTile, M - base);
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      float d = sqdist(qx, qy, qz, sx[j], sy[j], sz[j]) + sb[j];
      if (d < best_d) {
        best_d = d;
        best_i = base + j;
      }
    }
  }
  if (qi < Q) {
    out_idx[qi] = best_i;
    out_d2[qi] = best_d >= kBig ? CUDART_INF_F : best_d;
  }
}

// v2, first design. Threads of a partial last group still stage tiles and
// join every shuffle; only lane 0 of a group whose query exists writes.
template <int L>
__global__ void __launch_bounds__(kLaneThreads)
nn1_lanes_simple_kernel(const float* __restrict__ tgt, const unsigned char* __restrict__ mask,
                 int M, const float* __restrict__ queries, int Q,
                 int* __restrict__ out_idx, float* __restrict__ out_d2) {
  static_assert(L >= 1 && L <= 32 && (32 % L) == 0, "L lanes must divide a warp");
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  __shared__ float sz[kTile];

  const int lane = threadIdx.x % L;
  const int qi = blockIdx.x * (kLaneThreads / L) + threadIdx.x / L;
  float qx, qy, qz;
  load_query(queries, qi, Q, qx, qy, qz);

  float best_d = CUDART_INF_F;
  int best_i = 0;
  for (int base = 0; base < M; base += kTile) {
    __syncthreads();
    stage_tile<kTile>(tgt, mask, M, base, sx, sy, sz);
    __syncthreads();
    const int n = min(kTile, M - base);
#pragma unroll 4
    for (int j = lane; j < n; j += L) {
      float d = sqdist(qx, qy, qz, sx[j], sy[j], sz[j]);
      if (d < best_d) {
        best_d = d;
        best_i = base + j;
      }
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
    float od = __shfl_xor_sync(0xffffffffu, best_d, off);
    int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
    if (od < best_d || (od == best_d && oi < best_i)) {
      best_d = od;
      best_i = oi;
    }
  }
  if (lane == 0 && qi < Q) {
    out_idx[qi] = best_i;
    out_d2[qi] = best_d;
  }
}

// v3, first design. kTile is even and targets past M are staged as +inf, so target j + 1
// can always be read; `<=` keeps the earlier of an equal pair and the strict
// `<` against the running best keeps the earliest index overall.
__global__ void __launch_bounds__(kThreads)
nn1_unroll2_kernel(const float* __restrict__ tgt, const unsigned char* __restrict__ mask,
                   int M, const float* __restrict__ queries, int Q,
                   int* __restrict__ out_idx, float* __restrict__ out_d2) {
  static_assert(kTile % 2 == 0, "nn1_unroll2 reads targets in pairs");
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  __shared__ float sz[kTile];

  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  float qx, qy, qz;
  load_query(queries, qi, Q, qx, qy, qz);

  float best_d = CUDART_INF_F;
  int best_i = 0;
  for (int base = 0; base < M; base += kTile) {
    __syncthreads();
    stage_tile<kTile>(tgt, mask, M, base, sx, sy, sz);
    __syncthreads();
    const int n = min(kTile, M - base);
#pragma unroll 4
    for (int j = 0; j < n; j += 2) {
      float d0 = sqdist(qx, qy, qz, sx[j], sy[j], sz[j]);
      float d1 = sqdist(qx, qy, qz, sx[j + 1], sy[j + 1], sz[j + 1]);
      float cd = d0 <= d1 ? d0 : d1;
      int ci = d0 <= d1 ? j : j + 1;
      if (cd < best_d) {
        best_d = cd;
        best_i = base + ci;
      }
    }
  }
  if (qi < Q) {
    out_idx[qi] = best_i;
    out_d2[qi] = best_d;
  }
}

// v1 (L = 1) and v2 (L = 8, 32) in the ring: the biased distance, a strict
// `<` from kBig, rows lane, lane + L, ... of the chunk a step.
template <int L>
struct BiasForm {
  static constexpr int kStep = 1;
  static constexpr int kLanes = L;
  __device__ __forceinline__ static float none() { return kBig; }
  template <int R>
  __device__ __forceinline__ static void sweep(const float4* t, int n, int base, const float (&qx)[R],
                                               const float (&qy)[R], const float (&qz)[R], float (&bd)[R],
                                               int (&bi)[R]) {
#pragma unroll 4
    for (int j = threadIdx.x % L; j < n; j += L) {
      const float4 p = t[j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float d = sqdist(qx[r], qy[r], qz[r], p.x, p.y, p.z) + p.w;
        if (d < bd[r]) {
          bd[r] = d;
          bi[r] = base + j;
        }
      }
    }
  }
};

// v3 in the ring: rows j and j + 1 a step (n is even), folded per query,
// then a strict `<` from kBig.
struct Unroll2Form {
  static constexpr int kStep = 2;
  static constexpr int kLanes = 1;
  __device__ __forceinline__ static float none() { return kBig; }
  template <int R>
  __device__ __forceinline__ static void sweep(const float4* t, int n, int base, const float (&qx)[R],
                                               const float (&qy)[R], const float (&qz)[R], float (&bd)[R],
                                               int (&bi)[R]) {
#pragma unroll 2
    for (int j = 0; j < n; j += 2) {
      const float4 p0 = t[j];
      const float4 p1 = t[j + 1];
      const int i0 = base + j;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float d0 = sqdist(qx[r], qy[r], qz[r], p0.x, p0.y, p0.z) + p0.w;
        const float d1 = sqdist(qx[r], qy[r], qz[r], p1.x, p1.y, p1.z) + p1.w;
        const float cd = fminf(d0, d1);
        const int ci = cd == d0 ? i0 : i0 + 1;
        if (cd < bd[r]) {
          bd[r] = cd;
          bi[r] = ci;
        }
      }
    }
  }
};

inline int blocks_for(int rows, int per_block) { return (rows + per_block - 1) / per_block; }

}  // namespace

extern "C" int spt_nn1_bias_simple(const float* tgt, const unsigned char* mask, int M,
                            const float* queries, int Q, int* out_idx, float* out_d2,
                            void* stream) {
  nn1_bias_kernel<<<blocks_for(Q, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tgt, mask, M, queries, Q, out_idx, out_d2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spt_nn1_lanes_simple(const float* tgt, const unsigned char* mask, int M,
                                    const float* queries, int Q, int lanes, int* out_idx,
                                    float* out_d2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 8:
      nn1_lanes_simple_kernel<8><<<blocks_for(Q, kLaneThreads / 8), kLaneThreads, 0, s>>>(
          tgt, mask, M, queries, Q, out_idx, out_d2);
      break;
    case 32:
      nn1_lanes_simple_kernel<32><<<blocks_for(Q, kLaneThreads / 32), kLaneThreads, 0, s>>>(
          tgt, mask, M, queries, Q, out_idx, out_d2);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spt_nn1_unroll2_simple(const float* tgt, const unsigned char* mask, int M,
                               const float* queries, int Q, int* out_idx, float* out_d2,
                               void* stream) {
  nn1_unroll2_kernel<<<blocks_for(Q, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tgt, mask, M, queries, Q, out_idx, out_d2);
  return static_cast<int>(cudaGetLastError());
}

// v1, v2 and v3 in the ring, against a bias-packed target (tgt [M, 4] f32,
// M even, 16-byte aligned): query_tile in {64, 128, 256, 512} (for v2 (query,
// lane) slots: query_tile / lanes queries a block), chunk in {512, 1024,
// 2048, 4096}, span >= 2 rows a split and even (v2: span >= 1); best [Q] u64
// scratch; out_idx [Q] i32, out_d2 [Q] f32. A memset and two kernels.
extern "C" int spt_nn1_bias(const float* tgt, int M, const float* queries, int Q, int query_tile, int chunk,
                            int span, unsigned long long* best, int* out_idx, float* out_d2, void* stream) {
  return spt::run_nn1_ring<BiasForm<1>>(tgt, M, queries, Q, query_tile, chunk, span, best, out_idx, out_d2,
                                        stream);
}

extern "C" int spt_nn1_lanes(const float* tgt, int M, const float* queries, int Q, int lanes, int query_tile,
                             int chunk, int span, unsigned long long* best, int* out_idx, float* out_d2,
                             void* stream) {
  switch (lanes) {
    case 8:
      return spt::run_nn1_ring<BiasForm<8>>(tgt, M, queries, Q, query_tile, chunk, span, best, out_idx, out_d2,
                                            stream);
    case 32:
      return spt::run_nn1_ring<BiasForm<32>>(tgt, M, queries, Q, query_tile, chunk, span, best, out_idx, out_d2,
                                             stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int spt_nn1_unroll2(const float* tgt, int M, const float* queries, int Q, int query_tile, int chunk,
                               int span, unsigned long long* best, int* out_idx, float* out_d2, void* stream) {
  return spt::run_nn1_ring<Unroll2Form>(tgt, M, queries, Q, query_tile, chunk, span, best, out_idx, out_d2,
                                        stream);
}
