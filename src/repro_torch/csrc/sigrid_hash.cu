// Standalone SigridHash for Hopper (sm_90a): hash(id ^ salt) % max_value
// over an int32 tile, elementwise.
//
// Replaces the Pallas TPU kernel sigrid_hash of
// src/repro/kernels/sigrid_hash.py:34 (pallas_call at :48, body _kernel).
// The same op runs inside fused_transform (op SIGRID_HASH) on the main
// path; this standalone form has no caller on a path of the port, only
// repro_torch.kernels.ops.sigrid_hash.
//
// What bounds it on an H100: at one dlrm-paper batch's sparse id tile,
// (512, 1344) int32 (42 tables x 32 ids), 5.5 MB read and written, ~1.6 us
// at 3.35 TB/s, so the launch and each thread's serial chain set the time,
// not the bytes.  Each element is one 4-byte load, one 4-byte store, the
// mixer (two multiplies, three xor-shifts) and the remainder.
//
// Design: one thread per element in a grid-stride loop of 256-thread
// blocks, 16-byte vector loads and stores (int4) with streaming hints
// (__ldcs/__stcs: the tile is touched once) where both pointers are
// 16-byte aligned, the tail (and an unaligned tile) element by element.
// The remainder is Lemire, Kaser and Kurz's direct remainder ("Faster
// Remainder by Direct Computation", 2019) with the magic
// (2^64 - 1) / max_value + 1 (mod 2^64) computed by the wrapper on the
// host: four integer multiplies, where a % by a runtime divisor costs a
// float reciprocal (I2F, MUFU.RCP, F2I) and compare-and-correct steps on
// every thread's only chain.  At one batch's tile every thread is resident
// at once, so nothing hides that chain: the remainder is the whole gain
// there (PERF.md section 6, row 6, with the grids and load counts tried).
// Salt and max_value are kernel arguments, in uint32 as the reference's
// jnp.uint32 takes them; the wrapper refuses values outside [0, 2^32) and
// a max_value of 0.  The result is the bits of the uint32 remainder as
// int32, as the reference's astype(int32) gives them.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sigrid_hash.cuh"

namespace {

constexpr int kThreads = 256;

// x % d for every uint32 x and d in [1, 2^32), given magic = (2^64 - 1) / d
// + 1 (mod 2^64): the high 64 bits of (magic * x mod 2^64) * d.  Since
// d < 2^32 that is (hi * d + umulhi(lo, d)) >> 32 over the halves of
// magic * x, which cannot overflow 64 bits.
__device__ __forceinline__ uint32_t fastmod_u32(uint32_t x, uint64_t magic, uint32_t d) {
  const uint64_t low = magic * x;
  const uint32_t lo = static_cast<uint32_t>(low);
  const uint32_t hi = static_cast<uint32_t>(low >> 32);
  return static_cast<uint32_t>((static_cast<uint64_t>(hi) * d + __umulhi(lo, d)) >> 32);
}

__device__ __forceinline__ int32_t hash_fastmod(int32_t id, uint32_t salt, uint64_t magic,
                                                uint32_t d) {
  return static_cast<int32_t>(
      fastmod_u32(sigrid_mix_u32(static_cast<uint32_t>(id) ^ salt), magic, d));
}

__global__ void __launch_bounds__(kThreads)
sigrid_hash_kernel(const int32_t* __restrict__ ids, int32_t* __restrict__ out, int64_t n,
                   int64_t n_vec, uint32_t salt, uint64_t magic, uint32_t d) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int4* in4 = reinterpret_cast<const int4*>(ids);
  int4* out4 = reinterpret_cast<int4*>(out);
  for (int64_t i = t0; i < n_vec; i += stride) {
    int4 v = __ldcs(in4 + i);
    v.x = hash_fastmod(v.x, salt, magic, d);
    v.y = hash_fastmod(v.y, salt, magic, d);
    v.z = hash_fastmod(v.z, salt, magic, d);
    v.w = hash_fastmod(v.w, salt, magic, d);
    __stcs(out4 + i, v);
  }
  for (int64_t i = 4 * n_vec + t0; i < n; i += stride) {
    out[i] = hash_fastmod(ids[i], salt, magic, d);
  }
}

}  // namespace

extern "C" {

// ids and out: n int32 each; 1 <= max_value < 2^32 and magic =
// (2^64 - 1) / max_value + 1 (mod 2^64), as the wrapper computes it
int sigrid_hash_launch(const void* ids, void* out, int64_t n, uint32_t salt, uint64_t magic,
                       uint32_t max_value, void* stream) {
  if (max_value == 0 || magic != UINT64_MAX / max_value + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const bool aligned = (reinterpret_cast<uintptr_t>(ids) % 16 == 0) &&
                         (reinterpret_cast<uintptr_t>(out) % 16 == 0);
    const int64_t n_vec = aligned ? n / 4 : 0;
    const int64_t work = n_vec + (n - 4 * n_vec);
    int64_t blocks = (work + kThreads - 1) / kThreads;
    if (blocks > 132 * 32) blocks = 132 * 32;   // the grid-stride loop takes the rest
    sigrid_hash_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(ids), static_cast<int32_t*>(out), n, n_vec, salt, magic,
        max_value);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
