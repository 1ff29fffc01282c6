// Pooled embedding bag for Hopper (sm_90a): the device-tier lookup of the
// DLRM trainer's tiered embedding store, one launch per lookup.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/embedding_bag.py:
//   embedding_bag (embedding_bag.py:40, pallas_call at :67)
//     -> embedding_bag_kernel
//
// It computes what the TPU kernel's _kernel computes, in the same order:
// for l = 0..L-1 in turn, out += table[ids[b,l]] * mask[b,l] and
// denom += mask[b,l] -- every slot, masked ones too, so a NaN or inf row
// under a mask of 0 gives NaN as it does there -- and then, in "mean"
// mode, out / max(denom, 1).  Each product and sum is rounded on its own
// (__fmul_rn, __fadd_rn: nvcc would contract a*b+c into one FMA), the
// division is IEEE (__fdiv_rn), and max(denom, 1) keeps a NaN denom as
// jnp.maximum does (fmaxf would drop it).  So the kernel agrees bit for
// bit with the plain PyTorch version (repro_torch.kernels.ref), which
// loops over l the same way.  Nothing is built with --ftz: subnormal rows
// stay subnormal.
//
// What bounds it on an H100: bytes.  Two float operations per table
// element read (21 MFLOP at the main path's 2,544 fully-hot bags of 32
// slots, E=128) is far below the card's operations per byte; the least
// time is every table row the ids name read once, ids and mask read once
// and the output written once over 3.35 TB/s (at the main path: 1,893
// rows of a (43008, 128) hot-slot table, 0.65 MB of ids and mask, 1.3 MB
// out: ~0.9 us).
//
// Design (simple and right first):
//   * one block per bag, one thread per column (E rounded up to a warp),
//     so the read of a table row by a warp is coalesced;
//   * the bag's ids (as row offsets) and mask are staged in shared memory
//     in chunks of kChunk slots, read once from device memory by the block;
//   * row offsets are int64: a flat (T*V, E) table has more than 2^31
//     elements;
//   * ids are clamped to [0, V-1] before the read, as the plain version
//     clamps them, so a bad id cannot fault.
// The rows of one bag are summed in sequence (the order above), so each
// thread's loop is a chain of dependent adds.  At the main path's 2,544
// bags the grid is about one wave, so the launch floor and one bag's
// chain of loads set the time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 256;

__global__ void embedding_bag_kernel(const float* __restrict__ table,
                                     const int32_t* __restrict__ ids,
                                     const float* __restrict__ mask,
                                     float* __restrict__ out,
                                     int64_t v, int e, int l, int mean) {
  __shared__ int64_t s_row[kChunk];
  __shared__ float s_w[kChunk];
  const int64_t bag = blockIdx.x;
  const int32_t* bag_ids = ids + bag * l;
  const float* bag_mask = mask + bag * l;
  const int col = threadIdx.x;
  float acc = 0.0f;
  float denom = 0.0f;
  for (int l0 = 0; l0 < l; l0 += kChunk) {
    const int n = min(kChunk, l - l0);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      int64_t id = bag_ids[l0 + i];
      id = id < 0 ? 0 : (id >= v ? v - 1 : id);
      s_row[i] = id * e;
      s_w[i] = bag_mask[l0 + i];
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float w = s_w[i];
      denom = __fadd_rn(denom, w);
      if (col < e) {
        acc = __fadd_rn(acc, __fmul_rn(table[s_row[i] + col], w));
      }
    }
    __syncthreads();
  }
  if (col < e) {
    if (mean) {
      // jnp.maximum(denom, 1): a NaN denom stays NaN
      const float d = (denom >= 1.0f || denom != denom) ? denom : 1.0f;
      acc = __fdiv_rn(acc, d);
    }
    out[bag * e + col] = acc;
  }
}

}  // namespace

extern "C" {

// table (v, e) f32, ids (bags, l) int32, mask (bags, l) f32, out (bags, e)
// f32; 1 <= e <= 1024; mean != 0 divides by max(sum(mask), 1)
int embedding_bag_launch(const void* table, const void* ids, const void* mask,
                         void* out, int64_t v, int e, int64_t bags, int l,
                         int mean, void* stream) {
  if (bags > 0) {
    const int threads = (e + 31) / 32 * 32;
    embedding_bag_kernel<<<static_cast<unsigned>(bags), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(table), static_cast<const int32_t*>(ids),
        static_cast<const float*>(mask), static_cast<float*>(out), v, e, l, mean);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
