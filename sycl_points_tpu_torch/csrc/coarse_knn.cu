// The coarse-to-fine candidate refine for Hopper (sm_90a), plain C interface.
//
// coarse_refine replaces the refine and the certificate of the JAX package's
// CoarseKNN (sycl_points_tpu/ops/coarse_knn.py:157-188, CoarseKNN.search):
// JAX gathers a [q, P, L] candidate block from the P selected cells, takes an
// argmin or top_k over it in XLA ops, and certifies the result against the
// unexplored cells' lower bound. It is not a Pallas kernel, so this kernel
// ports no TPU kernel. The [q, C] ranking before it is a plain f32 matrix
// product (torch.matmul, as JAX leaves it to XLA) and a top-k on the card.
//
// What bounds it on the card: per query up to P L candidate points (16 B
// each with the mask; the selected cells of neighbouring queries overlap, so
// most come from L2) and ~9 FP32 operations each. Device memory sees the
// queries, the selection, the touched target rows and the outputs; the bound
// is the FP32 lanes over the candidates this run's data holds.
//
// The simple design: one thread a query. The P cells are walked in their
// selected order and the L lanes of each in order (slot p L + l), a lane
// valid when l < count, the cell valid and the point unmasked, at position
// clip(start + l, 0, M - 1); d2 = dx*dx + dy*dy + dz*dz joins the
// strict-`<` list of best_k.cuh. Empty slots get JAX's padding: the first
// slots without a finite candidate, in the same order, at +inf. Then the
// certificate: sqrt(k-th d2) <= the unexplored bound, every selected cell
// holds at most L points, and the build lost no cell and no point.
// Indices refer to the target's SORTED layout, as JAX's do.
//
// The entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>

#include "best_k.cuh"

namespace {

constexpr int kThreads = 128;

template <int K>
__global__ void __launch_bounds__(kThreads)
coarse_refine_kernel(const float* __restrict__ queries, int Q, const int* __restrict__ cells, int P,
                     const float* __restrict__ lb_unexplored, const float* __restrict__ pts,
                     const unsigned char* __restrict__ pmask, int M, const int* __restrict__ starts,
                     const int* __restrict__ counts, const unsigned char* __restrict__ cvalid, int L,
                     const int* __restrict__ cells_lost, const int* __restrict__ points_lost,
                     int* __restrict__ out_idx, float* __restrict__ out_d2, unsigned char* __restrict__ certified) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  const float qx = __ldg(queries + 3 * q), qy = __ldg(queries + 3 * q + 1), qz = __ldg(queries + 3 * q + 2);
  const int* my_cells = cells + static_cast<long long>(q) * P;

  float bd[K];
  int bi[K];
  best_k_init<K>(bd, bi);
  bool complete = true;
  for (int c = 0; c < P; ++c) {
    const int cell = __ldg(my_cells + c);
    const int start = __ldg(starts + cell), count = __ldg(counts + cell);
    complete = complete && count <= L;
    if (!__ldg(cvalid + cell)) continue;
    const int n = min(count, L);
    for (int l = 0; l < n; ++l) {
      const int p = min(max(start + l, 0), M - 1);
      if (!__ldg(pmask + p)) continue;
      const float dx = __ldg(pts + 3 * p) - qx;
      const float dy = __ldg(pts + 3 * p + 1) - qy;
      const float dz = __ldg(pts + 3 * p + 2) - qz;
      best_k_insert<K>(bd, bi, dx * dx + dy * dy + dz * dz, p);
    }
  }

  int* oi = out_idx + static_cast<long long>(q) * K;
  float* od = out_d2 + static_cast<long long>(q) * K;
  int t = best_k_store<K>(bd, bi, oi, od);
  const float inf = __int_as_float(0x7f800000);
  const float kth = t == K ? bd[K - 1] : inf;
  for (int c = 0; c < P && t < K; ++c) {
    const int cell = __ldg(my_cells + c);
    const int start = __ldg(starts + cell), count = __ldg(counts + cell);
    const bool cell_ok = __ldg(cvalid + cell);
    for (int l = 0; l < L && t < K; ++l) {
      const int p = min(max(start + l, 0), M - 1);
      bool finite = false;
      if (cell_ok && l < count && __ldg(pmask + p)) {
        const float dx = __ldg(pts + 3 * p) - qx;
        const float dy = __ldg(pts + 3 * p + 1) - qy;
        const float dz = __ldg(pts + 3 * p + 2) - qz;
        finite = dx * dx + dy * dy + dz * dz < inf;
      }
      if (!finite) {
        oi[t] = p;
        od[t] = inf;
        ++t;
      }
    }
  }
  certified[q] = sqrtf(kth) <= __ldg(lb_unexplored + q) && complete && __ldg(cells_lost) == 0 &&
                 __ldg(points_lost) == 0;
}

}  // namespace

#define SPT_COARSE_CASE(KK)                                                                        \
  case KK:                                                                                         \
    coarse_refine_kernel<KK><<<blocks, kThreads, 0, s>>>(queries, Q, cells, P, lb_unexplored, pts,  \
                                                          pmask, M, starts, counts, cvalid, L,      \
                                                          cells_lost, points_lost, out_idx, out_d2, \
                                                          certified);                               \
    break;

// queries [Q,3] f32 (already moved by the pose), cells [Q,P] i32 selected in
// order, lb_unexplored [Q] f32; the sorted target [M,3] f32 and mask [M]
// bool; starts / counts [C] i32, valid [C] bool; cells_lost / points_lost
// 0-dim i32 on the card; out_idx [Q,k] i32 (sorted layout), out_d2 [Q,k]
// f32, certified [Q] bool; 1 <= k <= 16.
extern "C" int spt_coarse_refine(const float* queries, int Q, const int* cells, int P, const float* lb_unexplored,
                                 const float* pts, const unsigned char* pmask, int M, const int* starts,
                                 const int* counts, const unsigned char* cvalid, int L, const int* cells_lost,
                                 const int* points_lost, int k, int* out_idx, float* out_d2,
                                 unsigned char* certified, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (Q + kThreads - 1) / kThreads;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  if (M <= 0 || P <= 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (k) {
    SPT_COARSE_CASE(1)
    SPT_COARSE_CASE(2)
    SPT_COARSE_CASE(3)
    SPT_COARSE_CASE(4)
    SPT_COARSE_CASE(5)
    SPT_COARSE_CASE(6)
    SPT_COARSE_CASE(7)
    SPT_COARSE_CASE(8)
    SPT_COARSE_CASE(9)
    SPT_COARSE_CASE(10)
    SPT_COARSE_CASE(11)
    SPT_COARSE_CASE(12)
    SPT_COARSE_CASE(13)
    SPT_COARSE_CASE(14)
    SPT_COARSE_CASE(15)
    SPT_COARSE_CASE(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
