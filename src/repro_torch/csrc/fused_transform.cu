// Fused multi-feature transform for Hopper (sm_90a): one launch applies a
// per-feature op to every column of a packed int32 tile.  Two kernels,
// picked by the wrapper from the operands (kernels/fused_transform.py,
// route): the 16-byte-lane kernel for the engine's features-major tiles,
// and the general kernel below for every other tile.
//
// Replaces the Pallas TPU kernel fused_transform of
// src/repro/kernels/fused_transform.py:81 (body _kernel, :40).
//
// What bounds it on an H100: bytes.  Each element costs one 4-byte load,
// one 4-byte store and at most a few dozen integer operations (the hash)
// or a search of nb float borders (BUCKETIZE_F).  At the main path's
// waves, 32 x 8192 sparse ids and 171 x 512 dense values, that is ~2.1 MB
// and ~0.7 MB, under a microsecond of memory time each, so launch latency
// and one thread's chain of dependent loads set the time.
//
// The TPU kernel computed every candidate op over a VMEM tile and selected
// by code with a where-chain.  Here each feature's op is taken through a
// switch on its code; the result is the same bits as the where-chain.
//
// Bit-exactness against the reference (both kernels share transform_one):
//   * SIGRID_HASH is uint32 arithmetic, modulus max((uint32)p1, 1u);
//   * POSITIVE_MODULUS and BUCKETIZE floor while C's % and / truncate, so
//     the sign is fixed; id - p0 wraps as in int32 (computed unsigned);
//   * CLAMP_F uses explicit compares on the bit patterns (fminf/fmaxf
//     would drop NaN), with the NaN and signed-zero order of the reference;
//   * BUCKETIZE_F is the count of borders strictly below the value, which
//     a search gives only on sorted, NaN-free borders (see the vec kernel);
//   * built without --use_fast_math and --ftz: subnormals stay.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sigrid_hash.cuh"

namespace {

constexpr int OP_SIGRID_HASH = 1;
constexpr int OP_POSITIVE_MODULUS = 2;
constexpr int OP_CLAMP = 3;
constexpr int OP_BUCKETIZE = 4;
constexpr int OP_CLAMP_F = 5;
constexpr int OP_BUCKETIZE_F = 6;
constexpr int kThreads = 256;       // the general kernel's block
constexpr int kVecThreads = 128;    // the 16-byte-lane kernel's largest block

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

// every op but BUCKETIZE_F, which needs the feature's borders
__device__ __forceinline__ int32_t transform_one(int code, int32_t x, int32_t p0, int32_t p1) {
  switch (code) {
    case OP_SIGRID_HASH:
      return sigrid_hash_one(x, static_cast<uint32_t>(p0), max(static_cast<uint32_t>(p1), 1u));
    case OP_POSITIVE_MODULUS: {
      const int32_t m = max(p1, 1);
      int32_t q = x % m;            // truncated; m >= 1 so no overflow
      if (q < 0) q += m;            // floored: the divisor's sign
      return q;
    }
    case OP_CLAMP:
      return min(max(x, p0), p1);
    case OP_BUCKETIZE: {
      const int32_t d = static_cast<int32_t>(static_cast<uint32_t>(x) -
                                             static_cast<uint32_t>(p0));
      const int32_t s = max(p1, 1);
      int32_t q = d / s;
      if ((d % s) != 0 && d < 0) q -= 1;   // floor toward -inf
      return min(max(q, 0), 255);
    }
    case OP_CLAMP_F:
      return clamp_f_bits(x, p0, p1);
    default:                        // OP_IDENTITY and unknown codes
      return x;
  }
}

// The general kernel: any layout, element (f, r) at f * stride_f +
// r * stride_r.  One block row a feature, one element a thread; the
// feature's borders are staged in shared memory and counted.
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
    if (code == OP_BUCKETIZE_F) {
      const float v = __int_as_float(x);
      int32_t n = 0;
      for (int i = 0; i < nb; ++i) n += v > s_borders[i] ? 1 : 0;
      y = n;
    } else {
      y = transform_one(code, x, p0, p1);
    }
    out[at] = y;
  }
}

// The 16-byte-lane kernel, for features-major (F, rows) tiles with rows a
// multiple of 4 and 16-byte aligned bases: every tile the engine launches.
// The general kernel at the main path's waves ran 6.1x and 14.9x its
// bound (3.835 and 3.314 us on an H100 at 700 W): one 4-byte element a
// thread, and each block paid device-memory latencies in series before
// its one load of work (code and params, then the borders behind a
// __syncthreads(), which the ids load could not be hoisted above), then
// 63 dependent shared-memory compares an element for BUCKETIZE_F.  Here:
//   * a thread takes one 16-byte lane (4 elements) and a block one
//     feature's chunk of kVecThreads lanes, so the code is uniform in a
//     block and the switch does not diverge; the grid is (chunks,
//     features), one block a chunk with no loop, and fits the card at once
//     at the main path (512 blocks of 128 threads for 32 x 8192, 171 for
//     171 x 512).  Two or four lanes
//     a thread were slower on an H100: a thread's chain of hashes or
//     searches, not the bytes, sets the time at these sizes;
//   * every load a thread needs is issued at its start, with no block
//     barrier anywhere: its 16-byte ids load, the feature's code and
//     params, and, where the row has at most kRegBorders borders (the
//     kRegs kernel), its warp's copy of the border row (border k in lane
//     k % 32's register k / 32), whatever the code.  So a thread waits on
//     one memory latency, not a chain of them;
//   * BUCKETIZE_F searches the border row: a branch-free binary search of
//     ceil(log2(nb + 1)) steps (6 at 63 borders), each border fetched from
//     its lane by __shfl_sync (from L1 by __ldg past kRegBorders).  The
//     search equals the count only on sorted, NaN-free borders, so each
//     warp checks b[k] <= b[k+1] over every pair (false for a NaN; the last
//     border is checked with b == b) and votes with __all_sync, as
//     csrc/bucketize.cu does; where the vote fails, the count in the
//     borders' order replaces the search.  The engine fuses only sorted,
//     finite borders padded with +inf, so its waves always search; any
//     other border row still gets the count.  On an H100 the register
//     search beat a warp's copy of the row in shared memory and four-way
//     searches from either.
constexpr int kRegBorders = 64;              // two registers a lane

template <bool kRegs>
__global__ void __launch_bounds__(kVecThreads)
fused_transform_vec_kernel(const int4* __restrict__ ids,
                           const int32_t* __restrict__ codes,
                           const int32_t* __restrict__ p0s,
                           const int32_t* __restrict__ p1s,
                           const float* __restrict__ borders, int4* __restrict__ out,
                           int nb, int64_t q4) {
  const int f = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int64_t row0 = static_cast<int64_t>(f) * q4;
  const float* b = borders + static_cast<int64_t>(f) * nb;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  // lanes past the row's end still run the shuffles and the vote below
  const int4 x = j < q4 ? __ldg(ids + row0 + j) : make_int4(0, 0, 0, 0);
  const int code = __ldg(codes + f);
  const int32_t p0 = __ldg(p0s + f);
  const int32_t p1 = __ldg(p1s + f);
  float b_lo = 0.0f, b_hi = 0.0f;
  if (kRegs) {
    if (lane < nb) b_lo = __ldg(b + lane);
    if (lane + 32 < nb) b_hi = __ldg(b + lane + 32);
  }
  int32_t y[4];
  if (code != OP_BUCKETIZE_F) {            // uniform in the block
    y[0] = transform_one(code, x.x, p0, p1);
    y[1] = transform_one(code, x.y, p0, p1);
    y[2] = transform_one(code, x.z, p0, p1);
    y[3] = transform_one(code, x.w, p0, p1);
  } else {
    const float v[4] = {__int_as_float(x.x), __int_as_float(x.y), __int_as_float(x.z),
                        __int_as_float(x.w)};
    int ok = 1;
    if (kRegs) {
      // pairs (k, k+1) for k = lane and k = lane + 32
      const float lo_next = __shfl_down_sync(0xffffffffu, b_lo, 1);
      const float hi_first = __shfl_sync(0xffffffffu, b_hi, 0);
      const float hi_next = __shfl_down_sync(0xffffffffu, b_hi, 1);
      const float after_lo = lane < 31 ? lo_next : hi_first;
      if (lane < nb) ok &= lane + 1 < nb ? (b_lo <= after_lo) : (b_lo == b_lo);
      if (lane + 32 < nb) ok &= lane + 33 < nb ? (b_hi <= hi_next) : (b_hi == b_hi);
    } else {
      for (int k = lane; k < nb; k += 32) {
        const float bk = __ldg(b + k);
        ok &= k + 1 < nb ? (bk <= __ldg(b + k + 1)) : (bk == bk);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) y[e] = 0;
    // from the least power of two above nb (1 <= nb < 2^31)
    for (uint32_t step = (1u << (32 - __clz(nb))) >> 1; step > 0; step >>= 1) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int next = y[e] + static_cast<int>(step);
        float bk;
        if (kRegs) {                       // every lane shuffles
          const float lo = __shfl_sync(0xffffffffu, b_lo, (next - 1) & 31);
          const float hi = __shfl_sync(0xffffffffu, b_hi, (next - 1) & 31);
          bk = next - 1 < 32 ? lo : hi;
        } else {
          bk = next <= nb ? __ldg(b + next - 1) : 0.0f;
        }
        if (next <= nb && v[e] > bk) y[e] = next;
      }
    }
    if (!__all_sync(0xffffffffu, ok)) {    // unsorted or NaN borders: count
#pragma unroll
      for (int e = 0; e < 4; ++e) y[e] = 0;
      for (int k = 0; k < nb; ++k) {
        const float bk = __ldg(b + k);
#pragma unroll
        for (int e = 0; e < 4; ++e) y[e] += v[e] > bk ? 1 : 0;
      }
    }
  }
  if (j < q4) out[row0 + j] = make_int4(y[0], y[1], y[2], y[3]);
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

// ids and out: n_feats x rows int32, features-major and contiguous, rows a
// multiple of 4, both 16-byte aligned, n_feats <= 65535 (grid.y);
// codes, p0, p1: n_feats int32; borders: n_feats x nb float32 (1 <= nb)
int fused_transform_vec_launch(const void* ids, const void* codes, const void* p0,
                               const void* p1, const void* borders, void* out,
                               int n_feats, int64_t rows, int nb, void* stream) {
  if (rows % 4 != 0 || nb < 1 || n_feats > 65535 || rows / 4 / 32 >= (1ll << 31) ||
      reinterpret_cast<uintptr_t>(ids) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_feats > 0 && rows > 0) {
    const int64_t q4 = rows / 4;
    // kVecThreads lanes a block, or fewer (a multiple of 32) where a
    // feature's row is short
    const int threads =
        q4 >= kVecThreads ? kVecThreads : static_cast<int>((q4 + 31) / 32 * 32);
    const dim3 grid(static_cast<unsigned>((q4 + threads - 1) / threads), n_feats);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int4* in = static_cast<const int4*>(ids);
    int4* o = static_cast<int4*>(out);
    const int32_t* c = static_cast<const int32_t*>(codes);
    const int32_t* a = static_cast<const int32_t*>(p0);
    const int32_t* b = static_cast<const int32_t*>(p1);
    const float* bd = static_cast<const float*>(borders);
    if (nb <= kRegBorders) {
      fused_transform_vec_kernel<true><<<grid, threads, 0, s>>>(in, c, a, b, bd, o, nb, q4);
    } else {
      fused_transform_vec_kernel<false><<<grid, threads, 0, s>>>(in, c, a, b, bd, o, nb, q4);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
