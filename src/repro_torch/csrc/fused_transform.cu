// Fused multi-feature transform for Hopper (sm_90a): one launch applies a
// per-feature op to every column of a packed int32 tile.
//
// Replaces the Pallas TPU kernel fused_transform of
// src/repro/kernels/fused_transform.py:81 (body _kernel, :40).
//
// What bounds it on an H100: bytes.  Each element costs one 4-byte load,
// one 4-byte store and at most a few dozen integer operations (the hash)
// or nb float compares (BUCKETIZE_F, nb <= 512 borders held in shared
// memory).  At the main path's waves, 32 x ~8.7k sparse ids and 171 x 512
// dense values, that is ~2.2 MB and ~0.7 MB, under a microsecond of
// memory time each, so launch latency and the host<->device copies
// dominate.
//
// Design: the TPU kernel computed every candidate op over a VMEM tile and
// selected by code with a where-chain.  Here one block row handles one
// feature, so the feature's code, params and border row sit in shared
// memory and each thread takes one element through a switch on the code;
// the result is the same bits as the where-chain.  The tile may be
// features-major (F, rows) or rows-major (rows, F): element (f, r) is at
// f * stride_f + r * stride_r, so the engine's (F, rows_pad) packing needs
// no transpose.
//
// Bit-exactness against the reference:
//   * SIGRID_HASH is uint32 arithmetic, modulus max((uint32)p1, 1u);
//   * POSITIVE_MODULUS and BUCKETIZE floor while C's % and / truncate, so
//     the sign is fixed; id - p0 wraps as in int32 (computed unsigned);
//   * CLAMP_F uses explicit compares on the bit patterns (fminf/fmaxf
//     would drop NaN), with the NaN and signed-zero order of the reference;
//   * built without --use_fast_math and --ftz: subnormals stay.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OP_SIGRID_HASH = 1;
constexpr int OP_POSITIVE_MODULUS = 2;
constexpr int OP_CLAMP = 3;
constexpr int OP_BUCKETIZE = 4;
constexpr int OP_CLAMP_F = 5;
constexpr int OP_BUCKETIZE_F = 6;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ bool is_nan(float v) { return v != v; }

// jnp.clip(bits(x), bits(lo), bits(hi)) on bit patterns: a NaN upper bound
// wins, then a NaN value, then a NaN lower bound; +0.0 is above -0.0
__device__ __forceinline__ int32_t clamp_f_bits(int32_t x, int32_t lo, int32_t hi) {
  const float f = __int_as_float(x);
  const float l = __int_as_float(lo);
  int32_t m;
  if (is_nan(f)) {
    m = x;
  } else if (is_nan(l)) {
    m = lo;
  } else {
    m = (f > l || (f == l && x >= 0)) ? x : lo;
  }
  const float mf = __int_as_float(m);
  const float h = __int_as_float(hi);
  if (is_nan(h)) return hi;
  if (is_nan(mf)) return m;
  return (mf < h || (mf == h && m < 0)) ? m : hi;
}

__global__ void __launch_bounds__(kThreads)
fused_transform_kernel(const int32_t* __restrict__ ids,
                       const int32_t* __restrict__ codes,
                       const int32_t* __restrict__ p0s,
                       const int32_t* __restrict__ p1s,
                       const float* __restrict__ borders, int32_t* __restrict__ out,
                       int nb, int64_t rows, int64_t stride_f, int64_t stride_r) {
  extern __shared__ float s_borders[];
  const int f = blockIdx.x;
  const int code = codes[f];
  const int32_t p0 = p0s[f];
  const int32_t p1 = p1s[f];
  if (code == OP_BUCKETIZE_F) {
    for (int i = threadIdx.x; i < nb; i += blockDim.x) {
      s_borders[i] = borders[static_cast<int64_t>(f) * nb + i];
    }
    __syncthreads();
  }
  const int64_t base = static_cast<int64_t>(f) * stride_f;
  for (int64_t r = blockIdx.y * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       r < rows; r += static_cast<int64_t>(gridDim.y) * blockDim.x) {
    const int64_t at = base + r * stride_r;
    const int32_t x = ids[at];
    int32_t y;
    switch (code) {
      case OP_SIGRID_HASH: {
        const uint32_t h = hash_u32(static_cast<uint32_t>(x) ^ static_cast<uint32_t>(p0));
        const uint32_t m = max(static_cast<uint32_t>(p1), 1u);
        y = static_cast<int32_t>(h % m);
        break;
      }
      case OP_POSITIVE_MODULUS: {
        const int32_t m = max(p1, 1);
        int32_t q = x % m;            // truncated; m >= 1 so no overflow
        if (q < 0) q += m;            // floored: the divisor's sign
        y = q;
        break;
      }
      case OP_CLAMP:
        y = min(max(x, p0), p1);
        break;
      case OP_BUCKETIZE: {
        const int32_t d = static_cast<int32_t>(static_cast<uint32_t>(x) -
                                               static_cast<uint32_t>(p0));
        const int32_t s = max(p1, 1);
        int32_t q = d / s;
        if ((d % s) != 0 && d < 0) q -= 1;   // floor toward -inf
        y = min(max(q, 0), 255);
        break;
      }
      case OP_CLAMP_F:
        y = clamp_f_bits(x, p0, p1);
        break;
      case OP_BUCKETIZE_F: {
        const float v = __int_as_float(x);
        int32_t n = 0;
        for (int i = 0; i < nb; ++i) n += v > s_borders[i] ? 1 : 0;
        y = n;
        break;
      }
      default:                        // OP_IDENTITY and unknown codes
        y = x;
    }
    out[at] = y;
  }
}

}  // namespace

extern "C" {

// ids and out: n_feats x rows int32 at (f, r) -> f * stride_f + r * stride_r;
// codes, p0, p1: n_feats int32; borders: n_feats x nb float32
int fused_transform_launch(const void* ids, const void* codes, const void* p0,
                           const void* p1, const void* borders, void* out,
                           int n_feats, int64_t rows, int64_t stride_f,
                           int64_t stride_r, int nb, void* stream) {
  if (n_feats > 0 && rows > 0) {
    int64_t chunks = (rows + kThreads - 1) / kThreads;
    if (chunks > 65535) chunks = 65535;   // grid.y limit; the loop strides the rest
    const dim3 grid(n_feats, static_cast<unsigned>(chunks));
    const size_t smem = static_cast<size_t>(nb) * sizeof(float);
    fused_transform_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(ids), static_cast<const int32_t*>(codes),
        static_cast<const int32_t*>(p0), static_cast<const int32_t*>(p1),
        static_cast<const float*>(borders), static_cast<int32_t*>(out), nb, rows,
        stride_f, stride_r);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
