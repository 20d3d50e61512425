// Three formulations of the exact 1-NN for Hopper (sm_90a), plain C
// interface. They replace the TPU variant study `wrap(kernel, query_tile,
// target_chunk, with_bias).nn1` (scripts/bench_nn1_variants.py); its v0 is
// the production `nn1` of knn.cu.
//
// nn1_bias     (v1, `make_v1`) adds a staged 0 / 3.0e38 bias to every
//              distance in place of the +inf staging of masked targets.
// nn1_lanes<L> (v2, `make_v2`) gives each query L lanes with their own
//              running (best, idx), reduced once at the end.
// nn1_unroll2  (v3, `make_v3`) takes two targets a step and folds the pair
//              into the running best.
//
// What bounds them on the card: the same as nn1 (knn.cu). About 9 FP32 ALU
// operations a query/target pair and a target that is read from L2 into
// shared memory once per block, so FP32 ALU issue is the limit, and how many
// SMs the grid fills decides how close a kernel gets to it. What each design
// does about that:
//   - nn1_bias trades the masked targets' +inf coordinates for one add a
//     pair. On the TPU the bias replaced a select; here the +inf staging
//     already costs nothing a pair, so this measures the price of the add.
//   - nn1_lanes<L> runs L consecutive threads on one query: lane l scans
//     targets l, l+L, ... of each shared tile with a strict `<`, and a
//     __shfl_xor_sync reduce at the end takes the smaller distance and, on
//     equal distance, the smaller index (v2's tie rule). The grid has L times
//     as many threads as there are queries, so 1000 queries fill the card.
//   - nn1_unroll2 keeps one thread a query and halves the loop's compare-
//     and-branch count against the running best.
//
// All three are exact: the distance is spt::sqdist (nn1_common.cuh) and the
// library is built with --fmad=false, so each equals nn1 and the plain
// PyTorch version bit for bit. Masked and none-valid semantics are nn1's:
// idx 0, d2 = +inf. The queries come already moved by the pose, as in the TPU
// study. Every entry point launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>

#include "nn1_common.cuh"

namespace {

using spt::sqdist;
using spt::stage_tile;

constexpr int kThreads = 128;       // nn1_bias, nn1_unroll2: one thread a query
constexpr int kLaneThreads = 256;   // nn1_lanes: 256 / L queries a block
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

// v1. A masked or padded target keeps its coordinates and gets the bias
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

// v2. Threads of a partial last group still stage tiles and join every
// shuffle; only lane 0 of a group whose query exists writes.
template <int L>
__global__ void __launch_bounds__(kLaneThreads)
nn1_lanes_kernel(const float* __restrict__ tgt, const unsigned char* __restrict__ mask,
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

// v3. kTile is even and targets past M are staged as +inf, so target j + 1
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

inline int blocks_for(int rows, int per_block) { return (rows + per_block - 1) / per_block; }

}  // namespace

extern "C" int spt_nn1_bias(const float* tgt, const unsigned char* mask, int M,
                            const float* queries, int Q, int* out_idx, float* out_d2,
                            void* stream) {
  nn1_bias_kernel<<<blocks_for(Q, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tgt, mask, M, queries, Q, out_idx, out_d2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spt_nn1_lanes(const float* tgt, const unsigned char* mask, int M,
                             const float* queries, int Q, int lanes, int* out_idx,
                             float* out_d2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 8:
      nn1_lanes_kernel<8><<<blocks_for(Q, kLaneThreads / 8), kLaneThreads, 0, s>>>(
          tgt, mask, M, queries, Q, out_idx, out_d2);
      break;
    case 32:
      nn1_lanes_kernel<32><<<blocks_for(Q, kLaneThreads / 32), kLaneThreads, 0, s>>>(
          tgt, mask, M, queries, Q, out_idx, out_d2);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spt_nn1_unroll2(const float* tgt, const unsigned char* mask, int M,
                               const float* queries, int Q, int* out_idx, float* out_d2,
                               void* stream) {
  nn1_unroll2_kernel<<<blocks_for(Q, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tgt, mask, M, queries, Q, out_idx, out_d2);
  return static_cast<int>(cudaGetLastError());
}
