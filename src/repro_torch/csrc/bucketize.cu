// Standalone Bucketize for Hopper (sm_90a): for each float32 value, the
// count of borders strictly below it.
//
// Replaces the Pallas TPU kernel bucketize of
// src/repro/kernels/bucketize.py:30 (pallas_call at :44, body _kernel).
// The same compare runs inside fused_transform (op BUCKETIZE_F) on the
// main path; this standalone form has no caller on a path of the port,
// only repro_torch.kernels.ops.bucketize.
//
// Its function is a count, not a search, so it equals the reference for
// unsorted borders and NaN borders too: C's `v > b` is false when either
// side is NaN (a NaN value gives 0, a NaN border is never counted), and
// -0.0 is not above +0.0.  Built without --use_fast_math and --ftz, so
// subnormal values and borders compare as they are.
//
// What bounds it on an H100: bytes.  Each value is one 4-byte load and one
// 4-byte store.  At one dlrm-paper batch's dense tile, (512, 504) float32
// with the reference's 63 borders (np.linspace(-3, 3, 63)), that is 2.1 MB,
// ~0.6 us at 3.35 TB/s: launch latency and one chain of dependent loads
// dominate.  The first form (one value a thread, a serial count over the
// borders, one shared-memory load a compare, 1,008 blocks each staging the
// borders behind a barrier) lost to torch.bucketize.  So:
//   * sorted and NaN-free borders are searched, not counted: there `v >
//     b[k]` holds for a prefix of k (ties, -0.0/+0.0 pairs and infinities
//     included), so a branch-free binary search of ceil(log2(nb + 1))
//     steps gives the count, and a NaN value never advances and gets 0, as
//     the count gives it;
//   * whether they are sorted and NaN-free is decided in the kernel, from
//     the borders, with no copy to the host: each warp checks b[k] <=
//     b[k+1] over all pairs (false for a NaN; a single border is checked
//     with b == b) through L1 and votes with __all_sync, with no block
//     barrier; past 512 borders the block's 16 warps split the pairs and
//     vote with one __syncthreads_and, since one warp's walk over them
//     would cost more than the barrier;
//   * the search runs beside the check, so its chain of border loads (L1
//     hits after the first) overlaps the check's; where the vote finds the
//     borders unsorted or NaN, the count in the borders' order replaces it;
//   * each thread takes 2 consecutive values (one float2 load and one int2
//     store where the pointers are 8-byte aligned, scalar ones otherwise)
//     in blocks of 512 threads.  Against borders staged in shared memory
//     behind a __syncthreads_and at 4 values a thread, and against 1, 2 or
//     4 values in blocks of 128 to 1024, this was the fastest on an H100.
//     Borders are read through L1 whatever their number, so no slicing is
//     needed past 4096.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kPer = 2;        // values per thread
constexpr int kWarpCheck = 512;  // borders one warp checks alone

__global__ void __launch_bounds__(kThreads)
bucketize_kernel(const float* __restrict__ vals, const float* __restrict__ borders,
                 int32_t* __restrict__ out, int64_t n, int nb, int vec_ok) {
  const int64_t i = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kPer;
  const bool vec = vec_ok != 0 && i + kPer <= n;
  float v[kPer];
  if (vec) {
    const float2 f = *reinterpret_cast<const float2*>(vals + i);
    v[0] = f.x;
    v[1] = f.y;
  } else {
#pragma unroll
    for (int u = 0; u < kPer; ++u) v[u] = i + u < n ? vals[i + u] : 0.0f;
  }

  // each warp checks every pair, or, past kWarpCheck borders, the block
  // splits the pairs over its warps (nb is the same for every thread, so
  // the whole block takes one branch and reaches the barrier below)
  const bool by_block = nb > kWarpCheck;
  const int first_pair = by_block ? threadIdx.x : (threadIdx.x & 31);
  const int pair_step = by_block ? kThreads : 32;
  int ok = 1;
#pragma unroll 4
  for (int k = first_pair; k < nb; k += pair_step) {
    const float b = __ldg(borders + k);
    ok &= k + 1 < nb ? (b <= __ldg(borders + k + 1)) : (b == b);
  }
  // the search, from the least power of two above nb (nb < 2^31)
  int32_t c[kPer] = {0, 0};
  for (uint32_t step = (1u << (32 - __clz(nb))) >> 1; step > 0; step >>= 1) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int next = c[u] + static_cast<int>(step);
      if (next <= nb && v[u] > __ldg(borders + next - 1)) c[u] = next;
    }
  }
  const bool sorted = by_block ? __syncthreads_and(ok) != 0 : __all_sync(0xffffffffu, ok) != 0;
  if (!sorted) {                             // unsorted or NaN borders: count
#pragma unroll
    for (int u = 0; u < kPer; ++u) c[u] = 0;
    for (int k = 0; k < nb; ++k) {
      const float b = __ldg(borders + k);
#pragma unroll
      for (int u = 0; u < kPer; ++u) c[u] += v[u] > b ? 1 : 0;
    }
  }

  if (vec) {
    *reinterpret_cast<int2*>(out + i) = make_int2(c[0], c[1]);
  } else {
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      if (i + u < n) out[i + u] = c[u];
  }
}

}  // namespace

extern "C" {

// vals and out: n float32 / int32; borders: nb float32 (nb >= 0)
int bucketize_launch(const void* vals, const void* borders, void* out, int64_t n, int nb,
                     void* stream) {
  const int64_t per_block = static_cast<int64_t>(kThreads) * kPer;
  const int64_t blocks = (n + per_block - 1) / per_block;
  if (nb < 0 || blocks >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const int vec_ok = (reinterpret_cast<uintptr_t>(vals) % 8 == 0 &&
                        reinterpret_cast<uintptr_t>(out) % 8 == 0);
    bucketize_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(vals), static_cast<const float*>(borders),
        static_cast<int32_t*>(out), n, nb, vec_ok);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
