// The bulk-copied ring of the study 1-NN kernels (nn1_tiles.cu, nn1_variants.cu):
// one pipeline, whose per-chunk compare is a template parameter (a "form").
//
//   - The target is packed once: [M, 4] f32, 16 B a row, so that a 1-D bulk
//     copy (cp.async.bulk, TMA) moves a chunk of rows as it lies.
//   - A block has kQT / 2 threads, each holding R = 2 query slots, so that
//     each 16-byte load of a target row from shared memory feeds two
//     distances. A form of one lane (kLanes = 1) gives each thread two
//     queries: kQT queries a block. A lane form (kLanes = L > 1) gives each
//     query L consecutive threads of a warp, lane l = threadIdx.x % L taking
//     rows l, l + L, ... of each chunk with its own running best: kQT counts
//     (query, lane) slots, and a block holds kQT / L queries, so the target
//     is read from L2 L times as often as by a one-lane form at the same kQT.
//     Query r of a thread is blockIdx.x kQT / L + r (kQT / 2) / L +
//     threadIdx.x / L (ring_query).
//   - Block (x, y) takes its queries against target rows [y span, (y + 1)
//     span) (the split over gridDim.y is chosen by the wrapper), streamed
//     through a two-stage shared-memory ring of min(chunk, span) rows a
//     stage: one thread arms a stage's mbarrier and starts its copy, chunk
//     c + 1 lands while chunk c is compared, and a stage is refilled (chunk
//     c + 2) once every thread is past it.
//   - After the split's last chunk a lane form's L lanes reduce their bests
//     by __shfl_xor_sync, the smaller distance winning and, on equal
//     distance, the smaller index; lane 0 posts. Every thread of the block
//     joins the shuffles, those of a query past Q too.
//   - The merge: each (query, split) leaves (d2 bits << 32) | index, its best,
//     in a [Q] word by a 64-bit atomicMin; the words start at ~0 (a memset)
//     and one unpack kernel writes idx and d2. A split whose best is still at
//     the form's start value posts nothing, and a word still at ~0 unpacks to
//     idx 0, d2 = +inf. The posted d2 are finite and >= 0, so their bits order
//     as the floats, and on equal d2 the lower index is the smaller word.
//
// A form is a struct with
//   kStep                 rows a step (1, or 2: every span, chunk and M even);
//   kLanes                threads a query (1, or 2 to 32 dividing 32);
//   none()                the running best's start (a best still at it posts
//                         nothing);
//   sweep<R>(t, n, base, qx, qy, qz, bd, bi)
//                         the compare of one chunk: rows t[0, n) of shared
//                         memory (a lane form's lane its rows of them),
//                         global rows base + j, into each query's running
//                         (bd, bi), in index order, so that the first least
//                         distance of the rows it takes wins.
//
// The kernels live in an unnamed namespace: each source that includes this
// header has its own.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "nn1_common.cuh"

namespace spt {
namespace {

constexpr int kRingR = 2;             // queries a thread
constexpr int kRingMaxChunk = 4096;   // target rows a stage: 2 x 4,096 x 16 B = 128 KB
constexpr int kRingThreadsUnpack = 256;

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

// The query of slot r of the calling thread (see the header).
template <int kQT, int kLanes>
__device__ __forceinline__ int ring_query(int r) {
  constexpr int kThreadsB = kQT / kRingR;
  return blockIdx.x * (kQT / kLanes) + r * (kThreadsB / kLanes) + threadIdx.x / kLanes;
}

template <int kQT, class Form>
__global__ void __launch_bounds__(kQT / kRingR)
nn1_ring_kernel(const float4* __restrict__ tgt, int M, int span, int chunk, const float* __restrict__ queries,
                int Q, unsigned long long* __restrict__ best) {
  constexpr int kLanes = Form::kLanes;
  static_assert(32 % kLanes == 0 && (kQT / kRingR) % 32 == 0, "a query's lanes lie in one warp");
  extern __shared__ float4 ring[];  // 2 stages of `chunk` rows
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

  float qx[kRingR], qy[kRingR], qz[kRingR], bd[kRingR];
  int bi[kRingR];
#pragma unroll
  for (int r = 0; r < kRingR; ++r) {
    const int q = ring_query<kQT, kLanes>(r);
    qx[r] = q < Q ? queries[3 * q] : 0.f;
    qy[r] = q < Q ? queries[3 * q + 1] : 0.f;
    qz[r] = q < Q ? queries[3 * q + 2] : 0.f;
    bd[r] = Form::none();
    bi[r] = 0;
  }

  for (int c = 0; c < n_chunks; ++c) {
    const int s = c & 1;
    wait_phase(&bar[s], (c >> 1) & 1);
    Form::template sweep<kRingR>(ring + s * chunk, min(chunk, rows - c * chunk), row0 + c * chunk, qx, qy, qz,
                                 bd, bi);
    __syncthreads();  // every thread is past stage s
    if (threadIdx.x == 0 && c + 2 < n_chunks) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const int n2 = min(chunk, rows - (c + 2) * chunk);
      bulk_load(ring + s * chunk, tgt + row0 + (c + 2) * chunk, 16u * n2, &bar[s]);
    }
  }

#pragma unroll
  for (int r = 0; r < kRingR; ++r) {
    // a lane form's end-of-split reduce (no step for one lane): the smaller
    // distance, then the smaller index
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd[r], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi[r], off);
      if (od < bd[r] || (od == bd[r] && oi < bi[r])) {
        bd[r] = od;
        bi[r] = oi;
      }
    }
    const int q = ring_query<kQT, kLanes>(r);
    if (threadIdx.x % kLanes == 0 && q < Q && bd[r] < Form::none())
      atomicMin(best + q, (static_cast<unsigned long long>(__float_as_uint(bd[r])) << 32) |
                              static_cast<unsigned>(bi[r]));
  }
}

__global__ void __launch_bounds__(kRingThreadsUnpack)
nn1_ring_unpack_kernel(const unsigned long long* __restrict__ best, int Q, int* __restrict__ out_idx,
                       float* __restrict__ out_d2) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  const unsigned long long w = best[q];
  const bool none = w == ~0ull;
  out_idx[q] = none ? 0 : static_cast<int>(static_cast<unsigned>(w));
  out_d2[q] = none ? CUDART_INF_F : __uint_as_float(static_cast<unsigned>(w >> 32));
}

template <int kQT, class Form>
cudaError_t launch_ring(const float4* tgt, int M, int span, int chunk, const float* queries, int Q,
                        unsigned long long* best, cudaStream_t s) {
  const int stage = min(chunk, span);
  const int smem = 2 * stage * static_cast<int>(sizeof(float4));
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(nn1_ring_kernel<kQT, Form>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  constexpr int kQueries = kQT / Form::kLanes;  // queries a block
  const dim3 grid((Q + kQueries - 1) / kQueries, (M + span - 1) / span);
  nn1_ring_kernel<kQT, Form><<<grid, kQT / kRingR, smem, s>>>(tgt, M, span, stage, queries, Q, best);
  return cudaGetLastError();
}

// The entry points' body: a memset of `best`, the ring kernel at `query_tile`
// in {64, 128, 256, 512} (query slots a block: queries, or for a lane form
// (query, lane) pairs, query_tile / kLanes queries) and `chunk` in {512, ...,
// 4096} (a multiple of 512, so of every kLanes), and the unpack, on the
// caller's stream; allocates nothing and returns the first CUDA error. tgt
// [M, 4] f32, 16-byte aligned; span >= 1 rows a split (for a form of two
// rows a step, M and span even); best [Q] u64 scratch; out_idx [Q] i32,
// out_d2 [Q] f32.
template <class Form>
int run_nn1_ring(const float* tgt, int M, const float* queries, int Q, int query_tile, int chunk, int span,
                 unsigned long long* best, int* out_idx, float* out_d2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (span < 1 || chunk < 512 || chunk > kRingMaxChunk || chunk % 512) return static_cast<int>(cudaErrorInvalidValue);
  if (query_tile != 64 && query_tile != 128 && query_tile != 256 && query_tile != 512)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M % Form::kStep || span % Form::kStep) return static_cast<int>(cudaErrorInvalidValue);
  if (Q <= 0) return static_cast<int>(cudaSuccess);
  cudaError_t e = cudaMemsetAsync(best, 0xff, sizeof(unsigned long long) * static_cast<size_t>(Q), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (M > 0) {
    const float4* t = reinterpret_cast<const float4*>(tgt);
    switch (query_tile) {
      case 64: e = launch_ring<64, Form>(t, M, span, chunk, queries, Q, best, s); break;
      case 128: e = launch_ring<128, Form>(t, M, span, chunk, queries, Q, best, s); break;
      case 256: e = launch_ring<256, Form>(t, M, span, chunk, queries, Q, best, s); break;
      default: e = launch_ring<512, Form>(t, M, span, chunk, queries, Q, best, s); break;
    }
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  nn1_ring_unpack_kernel<<<(Q + kRingThreadsUnpack - 1) / kRingThreadsUnpack, kRingThreadsUnpack, 0, s>>>(
      best, Q, out_idx, out_d2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace spt
