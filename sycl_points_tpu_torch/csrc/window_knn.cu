// The Morton-window self-k-NN pass for Hopper (sm_90a), plain C interface.
//
// morton_window replaces the window search of one pass of the JAX package's
// window_self_knn (sycl_points_tpu/ops/window_knn.py:103-122, _window_pass):
// JAX builds the [N, 2W] distances to the points at sorted offsets -W .. -1,
// 1 .. W from 2W rolls of the Morton-sorted cloud, takes a top_k over them,
// maps the offsets back through the sort and scatters the rows to the
// original order, all in XLA ops. It is not a Pallas kernel, so this kernel
// ports no TPU kernel; it takes the place of a self-k-NN (knn_k) for clouds
// with no scan structure.
//
// What bounds it on the card: per sorted position it reads the 2W
// neighbours in the sorted order (16 B each with the validity; neighbouring
// threads read overlapping windows, so device memory sees the sorted cloud
// about once) and does ~9 FP32 operations a column: the FP32 lanes bound it
// (2W x 9 operations a point against 20 B read and 8 k B written).
//
// The simple design: one thread a sorted position s. Columns in JAX's order
// (offsets -W .. -1, then 1 .. W); a column's value is d2 = dx*dx + dy*dy +
// dz*dz when s, its partner s + o (inside [0, N)) and both validities hold,
// else 3e38, as JAX's where(); the k smallest by the strict-`<` list of
// best_k.cuh (equal values keep the earlier column, as lax.top_k). Columns
// whose value is not finite (a d2 that overflowed) never enter the list, and
// the slots they leave get the first such columns in order, at their value.
// Each slot's index is the original index of the clipped partner position,
// and the row is written at the ORIGINAL position idx_s[s] (JAX's final
// scatter), so the outputs come back in the cloud's order.
//
// It is built at K = 1 .. 16, 32, 64 and 128 (best_k.cuh); above 16 a request
// for k runs the smallest K >= k and writes the first k entries of the list
// (a K-list's first k entries are the k-list, padding included).
//
// The entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>

#include "best_k.cuh"

namespace {

constexpr int kThreads = 128;
constexpr float kBig = 3.0e38f;

__device__ __forceinline__ float column(const float* __restrict__ pts, const unsigned char* __restrict__ ok,
                                        int N, int s, bool ok_s, float px, float py, float pz, int o) {
  const int j = s + o;
  if (!(ok_s && j >= 0 && j < N && __ldg(ok + j))) return kBig;
  const float dx = px - __ldg(pts + 3 * j);
  const float dy = py - __ldg(pts + 3 * j + 1);
  const float dz = pz - __ldg(pts + 3 * j + 2);
  return dx * dx + dy * dy + dz * dz;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
morton_window_kernel(const float* __restrict__ pts, const unsigned char* __restrict__ ok,
                     const int* __restrict__ idx_s, int N, int W, int k, int* __restrict__ out_idx,
                     float* __restrict__ out_d2) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= N) return;
  const bool ok_s = __ldg(ok + s);
  const float px = __ldg(pts + 3 * s), py = __ldg(pts + 3 * s + 1), pz = __ldg(pts + 3 * s + 2);

  float bd[K];
  int bi[K];
  best_k_init<K>(bd, bi);
  for (int c = 0; c < 2 * W; ++c) {
    const int o = c < W ? c - W : c - W + 1;
    best_k_insert<K>(bd, bi, column(pts, ok, N, s, ok_s, px, py, pz, o), o);
  }

  const int kw = spt::row_count<K>(k);
  const long long row = static_cast<long long>(__ldg(idx_s + s)) * kw;
  int* oi = out_idx + row;
  float* od = out_d2 + row;
  int t = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (j < kw && bd[j] < __int_as_float(0x7f800000)) {
      oi[j] = __ldg(idx_s + min(max(s + bi[j], 0), N - 1));
      od[j] = bd[j];
      t = j + 1;
    }
  }
  for (int c = 0; c < 2 * W && t < kw; ++c) {
    const int o = c < W ? c - W : c - W + 1;
    const float d = column(pts, ok, N, s, ok_s, px, py, pz, o);
    if (!(d < __int_as_float(0x7f800000))) {
      oi[t] = __ldg(idx_s + min(max(s + o, 0), N - 1));
      od[t] = d;
      ++t;
    }
  }
}

}  // namespace

#define SPT_WINDOW_CASE(KK)                                                                          \
  case KK:                                                                                           \
    morton_window_kernel<KK><<<blocks, kThreads, 0, s>>>(pts, ok, idx_s, N, W, k, out_idx, out_d2); \
    break;

// pts [N,3] f32 and ok [N] bool in Morton order, idx_s [N] i32 the original
// index of each sorted position (a permutation); W the one-sided window,
// 2 W >= k; out_idx [N,k] i32 and out_d2 [N,k] f32 in the ORIGINAL order;
// 1 <= k <= 128.
extern "C" int spt_morton_window(const float* pts, const unsigned char* ok, const int* idx_s, int N, int W, int k,
                                 int* out_idx, float* out_d2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (N + kThreads - 1) / kThreads;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  if (W <= 0 || 2 * W < k) return static_cast<int>(cudaErrorInvalidValue);
  switch (spt::instance_k(k)) {
    SPT_K_CASES(SPT_WINDOW_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
