// Standalone SigridHash for Hopper (sm_90a): hash(id ^ salt) % max_value
// over an int32 tile, elementwise.
//
// Replaces the Pallas TPU kernel sigrid_hash of
// src/repro/kernels/sigrid_hash.py:34 (pallas_call at :48, body _kernel).
// The same op runs inside fused_transform (op SIGRID_HASH) on the main
// path; this standalone form has no caller on a path of the port, only
// repro_torch.kernels.ops.sigrid_hash.
//
// What bounds it on an H100: bytes.  Each element is one 4-byte load, one
// 4-byte store and ~10 integer operations.  At one dlrm-paper batch's
// sparse id tile, (512, 1344) int32 (42 tables x 32 ids), that is 5.5 MB,
// ~1.6 us at 3.35 TB/s: launch latency dominates.
//
// Design: one thread per element in a grid-stride loop, 16-byte vector
// loads and stores (int4) where both pointers are 16-byte aligned, the
// tail (and an unaligned tile) element by element.  Salt and max_value are
// kernel arguments, in uint32 as the reference's jnp.uint32 takes them;
// the wrapper refuses values outside [0, 2^32) and a max_value of 0.
// The result is the bits of the uint32 remainder as int32, as the
// reference's astype(int32) gives them.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sigrid_hash.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sigrid_hash_kernel(const int32_t* __restrict__ ids, int32_t* __restrict__ out, int64_t n,
                   int64_t n_vec, uint32_t salt, uint32_t max_value) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int4* in4 = reinterpret_cast<const int4*>(ids);
  int4* out4 = reinterpret_cast<int4*>(out);
  for (int64_t i = t0; i < n_vec; i += stride) {
    int4 v = in4[i];
    v.x = sigrid_hash_one(v.x, salt, max_value);
    v.y = sigrid_hash_one(v.y, salt, max_value);
    v.z = sigrid_hash_one(v.z, salt, max_value);
    v.w = sigrid_hash_one(v.w, salt, max_value);
    out4[i] = v;
  }
  for (int64_t i = 4 * n_vec + t0; i < n; i += stride) {
    out[i] = sigrid_hash_one(ids[i], salt, max_value);
  }
}

}  // namespace

extern "C" {

// ids and out: n int32 each; 1 <= max_value < 2^32
int sigrid_hash_launch(const void* ids, void* out, int64_t n, uint32_t salt,
                       uint32_t max_value, void* stream) {
  if (max_value == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const bool aligned = (reinterpret_cast<uintptr_t>(ids) % 16 == 0) &&
                         (reinterpret_cast<uintptr_t>(out) % 16 == 0);
    const int64_t n_vec = aligned ? n / 4 : 0;
    const int64_t work = n_vec + (n - 4 * n_vec);
    int64_t blocks = (work + kThreads - 1) / kThreads;
    if (blocks > 132 * 32) blocks = 132 * 32;   // the grid-stride loop takes the rest
    sigrid_hash_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(ids), static_cast<int32_t*>(out), n, n_vec, salt,
        max_value);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
