// The range-image window search for Hopper (sm_90a), plain C interface.
//
// range_image_window replaces steps 3-4 of the JAX package's range_image_knn
// (sycl_points_tpu/ops/range_image_knn.py:113-128): for every cell of the
// dense [n_az, n_rings] range image, the squared distances to the points of
// the (2 window_az + 1) x (2 window_el + 1) cells around it (azimuth
// circular, elevation not), then the k smallest. JAX builds the window from
// 117 image rolls and a top_k over [C, 117] in XLA ops; it is not a Pallas
// kernel, so this kernel ports no TPU kernel: it takes the place of the
// self-k-NN (knn_k) on the raw-features frames.
//
// What bounds it on the card: per cell it reads the window's points and
// indices (16 B a candidate, almost all from L1/L2: neighbouring threads
// read neighbouring cells) and does ~9 FP32 operations a valid candidate,
// so device memory sees the image once and the bound is the FP32 lanes
// (117 x 9 operations a cell against 16 B read and 8 k B written).
//
// The simple design: one thread a cell. The candidates are scanned in JAX's
// column order, da outer and de inner, and kept in a sorted register list of
// K by insertion with a strict `<`, so that an equal distance stays behind
// the earlier column, as lax.top_k keeps it. Unoccupied cells (index -1) and
// elevation offsets off the image are skipped; a cell that is unoccupied
// itself gets no candidate. Slots not filled stay at 3e38 with index -1.
// Distances are (p - q)^2 summed as dx*dx + dy*dy + dz*dz; the library is
// built with --fmad=false, so every operation rounds once, as in the plain
// PyTorch version.
//
// The entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kThreads = 256;

template <int K>
__global__ void __launch_bounds__(kThreads)
range_image_window_kernel(const float* __restrict__ pts, const int* __restrict__ ids, int n_az,
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
        const float dx = px - __ldg(pts + 3 * c2);
        const float dy = py - __ldg(pts + 3 * c2 + 1);
        const float dz = pz - __ldg(pts + 3 * c2 + 2);
        const float d = dx * dx + dy * dy + dz * dz;
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

}  // namespace

#define SPT_RANGE_IMAGE_CASE(KK)                                                        \
  case KK:                                                                              \
    range_image_window_kernel<KK><<<blocks, kThreads, 0, s>>>(                          \
        pts, ids, n_az, n_rings, window_az, window_el, out_idx, out_d2);                \
    break;

// pts [n_az * n_rings, 3] f32 and ids [n_az * n_rings] i32 (-1: unoccupied),
// row a * n_rings + e; out_idx / out_d2 [n_az * n_rings, k], 1 <= k <= 16.
extern "C" int spt_range_image_window(const float* pts, const int* ids, int n_az, int n_rings,
                                      int window_az, int window_el, int k, int* out_idx,
                                      float* out_d2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cells = n_az * n_rings;
  const int blocks = (cells + kThreads - 1) / kThreads;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  switch (k) {
    SPT_RANGE_IMAGE_CASE(1)
    SPT_RANGE_IMAGE_CASE(2)
    SPT_RANGE_IMAGE_CASE(3)
    SPT_RANGE_IMAGE_CASE(4)
    SPT_RANGE_IMAGE_CASE(5)
    SPT_RANGE_IMAGE_CASE(6)
    SPT_RANGE_IMAGE_CASE(7)
    SPT_RANGE_IMAGE_CASE(8)
    SPT_RANGE_IMAGE_CASE(9)
    SPT_RANGE_IMAGE_CASE(10)
    SPT_RANGE_IMAGE_CASE(11)
    SPT_RANGE_IMAGE_CASE(12)
    SPT_RANGE_IMAGE_CASE(13)
    SPT_RANGE_IMAGE_CASE(14)
    SPT_RANGE_IMAGE_CASE(15)
    SPT_RANGE_IMAGE_CASE(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
