// The TPU tile study's 1-NN kernel written for Hopper (sm_90a), plain C
// interface.
//
// It replaces `make_nn1(query_tile, target_chunk).nn1`
// (scripts/bench_pallas_tiles.py:27-81, pallas_call at :62): a kernel that
// keeps a tile of queries and streams the target through VMEM in chunks,
// swept over the tile and the chunk to set ops/pallas_knn.py's constants.
// This kernel keeps the study's two parameters, queries a block (QT in 64,
// 128, 256, 512) and target points a chunk (TC in 512 .. 4096), and is
// designed for the card; knn.cu's nn1_kernel, one thread a query with a
// synchronous shared-memory stage, is its first design, kept as
// nn1_tiled_simple.
//
// What bounds it: ~9 FP32 operations a query/target pair (3 sub, 3 mul, 2
// add, 1 compare), ~0.006 ms at 1,000 queries against 22,000 valid targets;
// the target is 16 B a point, read once a query tile from L2. The first
// design reaches 8 of the 132 SMs at 1,000 queries (one thread a query) and
// stalls every thread on each tile's copy.
//
//   - Registers: a thread holds R = 2 queries (QT / 2 threads a block), so
//     each target point read from shared memory (one 16-byte broadcast load)
//     feeds two distances.
//   - The target is packed once (ops/cuda_knn.pack_target): [M, 4] f32, x y
//     z and a pad, masked rows at +inf, so a 1-D bulk copy moves a chunk as
//     it lies and an +inf row never passes the strict `<`.
//   - Chunks: a block streams its rows through a two-stage shared-memory
//     ring of min(TC, span) points a stage. One thread fills it with
//     cp.async.bulk (TMA 1-D copies) completing on an mbarrier a stage, so
//     chunk c + 1 lands while chunk c is compared; a stage is refilled
//     (chunk c + 2) once every thread is past it. 2 x 4,096 x 16 B = 128 KB.
//   - Filling the card: the target is split over gridDim.y into spans of
//     `span` rows, the split chosen by the wrapper from Q and the SM count
//     (ops/cuda_knn.nn1_tiled_span: up to 32 warps an SM, no split under 256
//     rows), so that few queries still fill the card: 1,000 against 24,576
//     rows run 16 x 96 blocks at 64 queries a block.
//   - The merge: each (query, split) leaves (d2 bits << 32) | index, its
//     best, in a [Q] word by a 64-bit atomicMin; the words start at ~0 (a
//     memset) and one unpack kernel writes idx and d2. A split with no finite
//     distance leaves nothing, and a word still at ~0 unpacks to idx 0, d2 =
//     +inf.
//   - Bit-equality with nn1_plain: d2 >= 0, so the bits order as the floats,
//     and on equal d2 the lower index is the smaller word; within a split the
//     strict `<` in index order keeps the first. The distance is knn.cu's
//     sqdist, one rounding an operation (--fmad=false).
//
// The entry point launches on the caller's stream (a memset and two
// kernels), allocates nothing, and returns the first CUDA error.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "nn1_common.cuh"

namespace {

using spt::sqdist;

constexpr int kR = 2;                  // queries a thread
constexpr int kMaxChunk = 4096;        // target points a stage
constexpr int kThreadsUnpack = 256;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Arms the stage's mbarrier for `bytes` and starts the 1-D bulk copy of
// `bytes` from src into dst; the copy completes the barrier's phase.
__device__ __forceinline__ void bulk_load(float4* dst, const float4* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// Waits until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void wait_phase(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Block (x, y): queries [x QT, (x + 1) QT) against target rows [y span,
// (y + 1) span), streamed `chunk` rows a stage.
template <int kQT>
__global__ void __launch_bounds__(kQT / kR)
nn1_tiles_kernel(const float4* __restrict__ tgt, int M, int span, int chunk, const float* __restrict__ queries,
                 int Q, unsigned long long* __restrict__ best) {
  constexpr int kThreadsB = kQT / kR;
  extern __shared__ float4 ring[];  // 2 stages of `chunk` points
  __shared__ unsigned long long bar[2];

  const int row0 = blockIdx.y * span;
  const int rows = min(span, M - row0);
  const int n_chunks = (rows + chunk - 1) / chunk;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&bar[0])) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&bar[1])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int c = 0; c < 2 && c < n_chunks; ++c) {
      const int n = min(chunk, rows - c * chunk);
      bulk_load(ring + c * chunk, tgt + row0 + c * chunk, 16u * n, &bar[c]);
    }
  }

  float qx[kR], qy[kR], qz[kR], bd[kR];
  int bi[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int q = blockIdx.x * kQT + r * kThreadsB + threadIdx.x;
    qx[r] = q < Q ? queries[3 * q] : 0.f;
    qy[r] = q < Q ? queries[3 * q + 1] : 0.f;
    qz[r] = q < Q ? queries[3 * q + 2] : 0.f;
    bd[r] = CUDART_INF_F;
    bi[r] = 0;
  }

  for (int c = 0; c < n_chunks; ++c) {
    const int s = c & 1;
    wait_phase(&bar[s], (c >> 1) & 1);
    const float4* const t = ring + s * chunk;
    const int base = row0 + c * chunk;
    const int n = min(chunk, rows - c * chunk);
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float4 p = t[j];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float d = sqdist(qx[r], qy[r], qz[r], p.x, p.y, p.z);
        if (d < bd[r]) {
          bd[r] = d;
          bi[r] = base + j;
        }
      }
    }
    __syncthreads();  // every thread is past stage s
    if (threadIdx.x == 0 && c + 2 < n_chunks) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const int n2 = min(chunk, rows - (c + 2) * chunk);
      bulk_load(ring + s * chunk, tgt + row0 + (c + 2) * chunk, 16u * n2, &bar[s]);
    }
  }

#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int q = blockIdx.x * kQT + r * kThreadsB + threadIdx.x;
    if (q < Q && bd[r] < CUDART_INF_F)
      atomicMin(best + q, (static_cast<unsigned long long>(__float_as_uint(bd[r])) << 32) |
                              static_cast<unsigned>(bi[r]));
  }
}

__global__ void __launch_bounds__(kThreadsUnpack)
nn1_tiles_unpack_kernel(const unsigned long long* __restrict__ best, int Q, int* __restrict__ out_idx,
                        float* __restrict__ out_d2) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  const unsigned long long w = best[q];
  const bool none = w == ~0ull;
  out_idx[q] = none ? 0 : static_cast<int>(static_cast<unsigned>(w));
  out_d2[q] = none ? CUDART_INF_F : __uint_as_float(static_cast<unsigned>(w >> 32));
}

template <int kQT>
cudaError_t launch_tiles(const float4* tgt, int M, int span, int chunk, const float* queries, int Q,
                         unsigned long long* best, cudaStream_t s) {
  const int stage = min(chunk, span);
  const int smem = 2 * stage * static_cast<int>(sizeof(float4));
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(nn1_tiles_kernel<kQT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((Q + kQT - 1) / kQT, (M + span - 1) / span);
  nn1_tiles_kernel<kQT><<<grid, kQT / kR, smem, s>>>(tgt, M, span, stage, queries, Q, best);
  return cudaGetLastError();
}

}  // namespace

// nn1 without a pose against a packed target (tgt [M, 4] f32, masked rows at
// +inf, 16-byte aligned): query_tile in {64, 128, 256, 512}, chunk in {512,
// 1024, 2048, 4096} (a multiple of 512 up to kMaxChunk), span >= 1 rows a
// split; best [Q] u64 scratch; out_idx [Q] i32, out_d2 [Q] f32.
extern "C" int spt_nn1_tiled(const float* tgt, int M, const float* queries, int Q, int query_tile, int chunk,
                             int span, unsigned long long* best, int* out_idx, float* out_d2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (span < 1 || chunk < 512 || chunk > kMaxChunk || chunk % 512) return static_cast<int>(cudaErrorInvalidValue);
  if (query_tile != 64 && query_tile != 128 && query_tile != 256 && query_tile != 512)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Q <= 0) return static_cast<int>(cudaSuccess);
  cudaError_t e = cudaMemsetAsync(best, 0xff, sizeof(unsigned long long) * static_cast<size_t>(Q), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (M > 0) {
    const float4* t = reinterpret_cast<const float4*>(tgt);
    switch (query_tile) {
      case 64: e = launch_tiles<64>(t, M, span, chunk, queries, Q, best, s); break;
      case 128: e = launch_tiles<128>(t, M, span, chunk, queries, Q, best, s); break;
      case 256: e = launch_tiles<256>(t, M, span, chunk, queries, Q, best, s); break;
      default: e = launch_tiles<512>(t, M, span, chunk, queries, Q, best, s); break;
    }
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  nn1_tiles_unpack_kernel<<<(Q + kThreadsUnpack - 1) / kThreadsUnpack, kThreadsUnpack, 0, s>>>(best, Q, out_idx,
                                                                                              out_d2);
  return static_cast<int>(cudaGetLastError());
}
