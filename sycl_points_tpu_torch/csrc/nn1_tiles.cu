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
//     The ring, the query registers and the merge are nn1_ring.cuh's, shared
//     with nn1_variants.cu's nn1_bias and nn1_unroll2; this file's form is
//     the plain compare below.
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

#include "nn1_ring.cuh"

namespace {

using spt::sqdist;

// The plain form: the distance, a strict `<` from +inf, a row a step.
struct PlainForm {
  static constexpr int kStep = 1;
  static constexpr int kLanes = 1;
  __device__ __forceinline__ static float none() { return CUDART_INF_F; }
  template <int R>
  __device__ __forceinline__ static void sweep(const float4* t, int n, int base, const float (&qx)[R],
                                               const float (&qy)[R], const float (&qz)[R], float (&bd)[R],
                                               int (&bi)[R]) {
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float4 p = t[j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float d = sqdist(qx[r], qy[r], qz[r], p.x, p.y, p.z);
        if (d < bd[r]) {
          bd[r] = d;
          bi[r] = base + j;
        }
      }
    }
  }
};

}  // namespace

// nn1 without a pose against a packed target (tgt [M, 4] f32, masked rows at
// +inf, 16-byte aligned): query_tile in {64, 128, 256, 512}, chunk in {512,
// 1024, 2048, 4096} (a multiple of 512 up to 4,096), span >= 1 rows a
// split; best [Q] u64 scratch; out_idx [Q] i32, out_d2 [Q] f32.
extern "C" int spt_nn1_tiled(const float* tgt, int M, const float* queries, int Q, int query_tile, int chunk,
                             int span, unsigned long long* best, int* out_idx, float* out_d2, void* stream) {
  return spt::run_nn1_ring<PlainForm>(tgt, M, queries, Q, query_tile, chunk, span, best, out_idx, out_d2, stream);
}
