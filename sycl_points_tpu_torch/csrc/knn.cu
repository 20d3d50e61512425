// Exact nearest-neighbour kernels for Hopper (sm_90a), plain C interface.
//
// nn1   replaces the Pallas TPU kernel `nn1_pallas_prepped` / `_nn1_kernel`
//       (sycl_points_tpu/ops/pallas_knn.py): the exact 1-NN correspondence
//       search run every ICP iteration, with the 4x4 pose folded into the
//       queries inside the kernel (the reference's transT).
// nn1_tiled replaces the TPU tile sweep `make_nn1(query_tile,
//       target_chunk).nn1` (scripts/bench_pallas_tiles.py): the same kernel
//       as nn1, instantiated over threads per block {64, 128, 256, 512} x
//       shared-memory target tile {512, 1024, 2048, 4096} points. The
//       production nn1 is the <128, 2048> instance. 3 x 4096 x 4 B = 48 KB is
//       the static shared-memory limit, so 4096 is the largest tile; that
//       limit is this card's counterpart of the TPU sweep's VMEM skip.
// knn_k replaces `_approx_knn_single` (sycl_points_tpu/ops/knn.py), which is
//       built on the TPU-only `lax.approx_max_k`; here it is an exact k-NN
//       (k <= 16), which is what the CPU reference computes.
//
// What bounds them on the card: both are brute force. Each query/target pair
// costs ~9 FP32 ALU operations (3 sub, 3 mul, 2 add, 1 compare), so the
// kernels are FP32-ALU bound: the target (16 bytes a point) streams from L2
// into shared memory once per block and is read back as a warp-wide
// broadcast, so device memory is never the limit.
//
// The simple design: one thread per query holds its query and its running
// best (1-NN) or its sorted best-k list in registers. A block stages the
// target through shared memory in tiles, in ascending index order
// (nn1_common.cuh). Masked targets are staged as +inf coordinates, so their
// distance is +inf and the strict `<` never takes them: no per-pair mask
// test. Distances use the exact difference form (q - t)^2 summed as
// e0*e0 + e1*e1 + e2*e2; the library is built with --fmad=false so every
// operation rounds once, as in the Pallas kernel and the PyTorch plain
// version. A strict `<` keeps the earliest index on ties.
//
// Known limit of this first version: nn1 at 1000 queries fills only a few
// of the 132 SMs. nn1_variants.cu holds the lanes-per-query formulation that
// puts more warps on the card.
//
// Every entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "nn1_common.cuh"

namespace {

using spt::sqdist;
using spt::stage_tile;

constexpr int kThreads = 128;
constexpr int kTile = 2048;

template <int kBlock, int kTileN>
__global__ void __launch_bounds__(kBlock)
nn1_kernel(const float* __restrict__ tgt, const unsigned char* __restrict__ mask,
           int M, const float* __restrict__ queries, int Q,
           const float* __restrict__ pose, int* __restrict__ out_idx,
           float* __restrict__ out_d2) {
  __shared__ float sx[kTileN];
  __shared__ float sy[kTileN];
  __shared__ float sz[kTileN];

  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (qi < Q) {
    float px = queries[3 * qi + 0];
    float py = queries[3 * qi + 1];
    float pz = queries[3 * qi + 2];
    if (pose != nullptr) {
      // transform_points order: (R p) as a row-wise sum, then + t.
      qx = pose[0] * px + pose[1] * py + pose[2] * pz + pose[3];
      qy = pose[4] * px + pose[5] * py + pose[6] * pz + pose[7];
      qz = pose[8] * px + pose[9] * py + pose[10] * pz + pose[11];
    } else {
      qx = px;
      qy = py;
      qz = pz;
    }
  }

  float best_d = CUDART_INF_F;
  int best_i = 0;
  for (int base = 0; base < M; base += kTileN) {
    __syncthreads();
    stage_tile<kTileN>(tgt, mask, M, base, sx, sy, sz);
    __syncthreads();
    const int n = min(kTileN, M - base);
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      float d = sqdist(qx, qy, qz, sx[j], sy[j], sz[j]);
      if (d < best_d) {
        best_d = d;
        best_i = base + j;
      }
    }
  }
  if (qi < Q) {
    out_idx[qi] = best_i;
    out_d2[qi] = best_d;
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ tgt, const unsigned char* __restrict__ mask,
           int M, const float* __restrict__ queries, int Q,
           int* __restrict__ out_idx, float* __restrict__ out_d2) {
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  __shared__ float sz[kTile];

  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (qi < Q) {
    qx = queries[3 * qi + 0];
    qy = queries[3 * qi + 1];
    qz = queries[3 * qi + 2];
  }

  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = CUDART_INF_F;
    bi[s] = 0;
  }

  for (int base = 0; base < M; base += kTile) {
    __syncthreads();
    stage_tile<kTile>(tgt, mask, M, base, sx, sy, sz);
    __syncthreads();
    const int n = min(kTile, M - base);
    for (int j = 0; j < n; ++j) {
      float d = sqdist(qx, qy, qz, sx[j], sy[j], sz[j]);
      if (d < bd[K - 1]) {
        // Insert after every entry <= d (ties keep the lower index), shifting
        // the larger entries up one slot; the old k-th falls off the end.
        // bd[s] still holds its old value when slot s is decided.
        const int idx = base + j;
#pragma unroll
        for (int s = K - 1; s > 0; --s) {
          if (bd[s] > d) {
            if (bd[s - 1] > d) {
              bd[s] = bd[s - 1];
              bi[s] = bi[s - 1];
            } else {
              bd[s] = d;
              bi[s] = idx;
            }
          }
        }
        if (bd[0] > d) {
          bd[0] = d;
          bi[0] = idx;
        }
      }
    }
  }
  if (qi < Q) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      out_idx[qi * K + s] = bi[s];
      out_d2[qi * K + s] = bd[s];
    }
  }
}

inline int num_blocks(int Q, int threads = kThreads) { return (Q + threads - 1) / threads; }

}  // namespace

extern "C" int spt_nn1(const float* tgt, const unsigned char* mask, int M,
                       const float* queries, int Q, const float* pose,
                       int* out_idx, float* out_d2, void* stream) {
  nn1_kernel<kThreads, kTile><<<num_blocks(Q), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tgt, mask, M, queries, Q, pose, out_idx, out_d2);
  return static_cast<int>(cudaGetLastError());
}

#define SPT_NN1_TILE_CASE(TH, TI)                                            \
  case TI:                                                                   \
    nn1_kernel<TH, TI><<<num_blocks(Q, TH), TH, 0, s>>>(tgt, mask, M, queries, \
                                                       Q, nullptr, out_idx,  \
                                                       out_d2);              \
    break;

#define SPT_NN1_THREADS_CASE(TH)                      \
  case TH:                                            \
    switch (tile) {                                   \
      SPT_NN1_TILE_CASE(TH, 512)                      \
      SPT_NN1_TILE_CASE(TH, 1024)                     \
      SPT_NN1_TILE_CASE(TH, 2048)                     \
      SPT_NN1_TILE_CASE(TH, 4096)                     \
      default:                                        \
        return static_cast<int>(cudaErrorInvalidValue); \
    }                                                 \
    break;

// nn1 without a pose at a chosen (threads per block, target tile) instance.
extern "C" int spt_nn1_tiled(const float* tgt, const unsigned char* mask, int M,
                             const float* queries, int Q, int threads, int tile,
                             int* out_idx, float* out_d2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (threads) {
    SPT_NN1_THREADS_CASE(64)
    SPT_NN1_THREADS_CASE(128)
    SPT_NN1_THREADS_CASE(256)
    SPT_NN1_THREADS_CASE(512)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

#define SPT_KNN_CASE(KV)                                                      \
  case KV:                                                                    \
    knn_kernel<KV><<<num_blocks(Q), kThreads, 0, s>>>(tgt, mask, M, queries, \
                                                      Q, out_idx, out_d2);   \
    break;

extern "C" int spt_knn_k(const float* tgt, const unsigned char* mask, int M,
                         const float* queries, int Q, int k, int* out_idx,
                         float* out_d2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    SPT_KNN_CASE(1)
    SPT_KNN_CASE(2)
    SPT_KNN_CASE(3)
    SPT_KNN_CASE(4)
    SPT_KNN_CASE(5)
    SPT_KNN_CASE(6)
    SPT_KNN_CASE(7)
    SPT_KNN_CASE(8)
    SPT_KNN_CASE(9)
    SPT_KNN_CASE(10)
    SPT_KNN_CASE(11)
    SPT_KNN_CASE(12)
    SPT_KNN_CASE(13)
    SPT_KNN_CASE(14)
    SPT_KNN_CASE(15)
    SPT_KNN_CASE(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
