// Standalone Bucketize for Hopper (sm_90a): for each float32 value, the
// count of borders strictly below it.
//
// Replaces the Pallas TPU kernel bucketize of
// src/repro/kernels/bucketize.py:30 (pallas_call at :44, body _kernel).
// The same compare runs inside fused_transform (op BUCKETIZE_F) on the
// main path; this standalone form has no caller on a path of the port,
// only repro_torch.kernels.ops.bucketize.
//
// It is a count, not a binary search, so it equals the reference for
// unsorted borders and NaN borders too: C's `v > b` is false when either
// side is NaN (a NaN value gives 0, a NaN border is never counted), and
// -0.0 is not above +0.0.  Built without --use_fast_math and --ftz, so
// subnormal values and borders compare as they are.
//
// What bounds it on an H100: bytes.  Each value is one 4-byte load, nb
// compares against borders in shared memory and one 4-byte store.  At one
// dlrm-paper batch's dense tile, (512, 504) float32 with the reference's
// 63 borders (np.linspace(-3, 3, 63)), that is 2.1 MB, ~0.6 us at
// 3.35 TB/s, and 16 M compares: launch latency dominates.
//
// Design: the borders are staged in shared memory once per block when
// they fit (nb <= 4096), else in slices of 4096 per pass; one thread per
// value in a grid-stride loop, the compares in the borders' order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStage = 4096;   // borders held in shared memory at a time

__global__ void __launch_bounds__(kThreads)
bucketize_kernel(const float* __restrict__ vals, const float* __restrict__ borders,
                 int32_t* __restrict__ out, int64_t n, int nb) {
  __shared__ float s_b[kStage];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  if (nb <= kStage) {
    for (int k = threadIdx.x; k < nb; k += blockDim.x) s_b[k] = borders[k];
    __syncthreads();
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
         i += stride) {
      const float v = vals[i];
      int32_t count = 0;
      for (int k = 0; k < nb; ++k) count += v > s_b[k] ? 1 : 0;
      out[i] = count;
    }
    return;
  }
  // many borders: every thread of the block walks the same slices, so the
  // barriers are reached by all of them
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * blockDim.x; base < n;
       base += stride) {
    const int64_t i = base + threadIdx.x;
    const float v = i < n ? vals[i] : 0.0f;
    int32_t count = 0;
    for (int b0 = 0; b0 < nb; b0 += kStage) {
      const int m = min(kStage, nb - b0);
      __syncthreads();
      for (int k = threadIdx.x; k < m; k += blockDim.x) s_b[k] = borders[b0 + k];
      __syncthreads();
      for (int k = 0; k < m; ++k) count += v > s_b[k] ? 1 : 0;
    }
    if (i < n) out[i] = count;
  }
}

}  // namespace

extern "C" {

// vals and out: n float32 / int32; borders: nb float32 (nb >= 0)
int bucketize_launch(const void* vals, const void* borders, void* out, int64_t n, int nb,
                     void* stream) {
  if (nb < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    int64_t blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 132 * 32) blocks = 132 * 32;   // the grid-stride loop takes the rest
    bucketize_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(vals), static_cast<const float*>(borders),
        static_cast<int32_t*>(out), n, nb);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
