// Pooled embedding bag for Hopper (sm_90a): the device-tier lookup of the
// DLRM trainer's tiered embedding store, one launch per lookup.  Two
// kernels, picked by the wrapper from the operands
// (kernels/embedding_bag.py, route): one warp a bag for E a multiple of 4
// up to 512 with 16-byte aligned table and output, which the trainer's
// E = 128 lookups take, and one block a bag for every other operand.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/embedding_bag.py:
//   embedding_bag (embedding_bag.py:40, pallas_call at :67)
//     -> embedding_bag_kernel, embedding_bag_warp_kernel
//
// Both compute what the TPU kernel's _kernel computes, in the same order:
// for l = 0..L-1 in turn, out += table[ids[b,l]] * mask[b,l] and
// denom += mask[b,l] -- every slot, masked ones too, so a NaN or inf row
// under a mask of 0 gives NaN as it does there -- and then, in "mean"
// mode, out / max(denom, 1).  Each product and sum is rounded on its own
// (__fmul_rn, __fadd_rn: nvcc would contract a*b+c into one FMA), the
// division is IEEE (__fdiv_rn), and max(denom, 1) keeps a NaN denom as
// jnp.maximum does (fmaxf would drop it).  So both kernels agree bit for
// bit with the plain PyTorch version (repro_torch.kernels.ref), which
// loops over l the same way.  Nothing is built with --ftz: subnormal rows
// stay subnormal.  Ids are clamped to [0, V-1] before the read, as the
// plain version clamps them, so a bad id cannot fault; row offsets are
// int64, since a flat (T*V, E) table has more than 2^31 elements.
//
// What bounds it on an H100: bytes.  Two float operations per table
// element read (21 MFLOP at the main path's 2,544 fully-hot bags of 32
// slots, E=128) is far below the card's operations per byte; the least
// time is every table row the ids name read once, ids and mask read once
// and the output written once over 3.35 TB/s (at the main path: 1,893
// rows of a (43008, 128) hot-slot table, 0.65 MB of ids and mask, 1.3 MB
// out: ~0.9 us).  Each bag still reads all of its 32 rows, 41.7 MB from
// L2 or L1 at the main path, and a bag's adds are a chain in slot order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 256;

// The general kernel: one block per bag, one thread per column (E rounded
// up to a warp), so the read of a table row by a warp is coalesced; the
// bag's ids (as row offsets) and mask are staged in shared memory in
// chunks of kChunk slots, read once from device memory by the block.  At
// the main path it ran 9.7x its bound (8.262 us on an H100 at 700 W):
// 2,544 blocks of 128 threads in 1.2 waves, and each bag's ids load, a
// barrier and 32 row loads that each wait on a shared-memory offset.
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

// The warp kernel: one warp a bag, kWarpBags bags a block (636 blocks of
// 128 threads for the main path's 2,544 bags, all resident at once).
//   * Lanes.  Lane j holds columns [4j, 4j+4) of each 128-column stripe
//     as a float4 (S stripes, one at E = 128), so a warp reads a row's
//     stripe as one 512-byte coalesced load and writes it likewise.
//   * Ids and mask without shared memory.  For each run of 32 slots lane
//     j loads ids[bag, j] (clamped) and mask[bag, j], one coalesced read
//     each, and __shfl_sync hands them out: no barrier, no staging.
//   * Row loads in flight together.  A group of G slots' row loads (G * S
//     float4s, 8 at E = 128) is issued before the group's first add, so a
//     bag waits on four groups' latencies at L <= 32, not on 32 in a row.
//     What bounds a launch at the main path is the gather's traffic (each
//     bag reads all 32 of its rows, 41.7 MB from L2 or L1 for 1.0 MB of
//     distinct rows), not one bag's chain, so the kernel is sized for
//     occupancy: G * S is held at 8 or less, so kWarpMinBlocks blocks an
//     SM fit (<= 80 registers a thread), 24 warps an SM keep their loads
//     in flight and the main path's grid runs in one wave.  On an H100,
//     groups of 16 or 32 slots and 8 bags a block were slower.
//   * The adds then run in slot order with __fmul_rn and __fadd_rn, and
//     the denominator is summed in slot order from the shuffled weights:
//     the plain version's order and roundings, so the same bits.
//   * L > 32 runs in consecutive runs of 32 slots, in order.
constexpr int kWarpBags = 4;
constexpr int kWarpThreads = 32 * kWarpBags;
constexpr int kWarpMinBlocks = 6;
constexpr int kStripe = 128;                     // columns: 32 lanes x float4

template <int S, int G>
__global__ void __launch_bounds__(kWarpThreads, kWarpMinBlocks)
embedding_bag_warp_kernel(const float* __restrict__ table,
                          const int32_t* __restrict__ ids,
                          const float* __restrict__ mask,
                          float* __restrict__ out,
                          int64_t v, int e, int64_t bags, int l, int mean) {
  static_assert(32 % G == 0, "a group must divide a run of 32 slots");
  const int lane = threadIdx.x & 31;
  const int64_t bag = static_cast<int64_t>(blockIdx.x) * kWarpBags + (threadIdx.x >> 5);
  if (bag >= bags) return;          // the whole warp: nothing below spans warps
  const int32_t* bag_ids = ids + bag * l;
  const float* bag_mask = mask + bag * l;
  const int col = 4 * lane;
  float4 acc[S];
#pragma unroll
  for (int s = 0; s < S; ++s) acc[s] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float denom = 0.0f;
  for (int l0 = 0; l0 < l; l0 += 32) {
    const int n = min(32, l - l0);                 // uniform in the warp
    int32_t my_row = 0;
    float my_w = 0.0f;
    if (lane < n) {
      const int32_t id = __ldg(bag_ids + l0 + lane);
      my_row = id < 0 ? 0 : (id >= v ? static_cast<int32_t>(v - 1) : id);
      my_w = __ldg(bag_mask + l0 + lane);
    }
    for (int g0 = 0; g0 < n; g0 += G) {
      float4 r[G][S];
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const int64_t row = __shfl_sync(0xffffffffu, my_row, g0 + i);
        const float* src = table + row * e + col;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          r[i][s] = (g0 + i < n && col + kStripe * s < e)
                        ? __ldg(reinterpret_cast<const float4*>(src + kStripe * s))
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      }
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const float w = __shfl_sync(0xffffffffu, my_w, g0 + i);
        if (g0 + i < n) {
          denom = __fadd_rn(denom, w);
#pragma unroll
          for (int s = 0; s < S; ++s) {
            acc[s].x = __fadd_rn(acc[s].x, __fmul_rn(r[i][s].x, w));
            acc[s].y = __fadd_rn(acc[s].y, __fmul_rn(r[i][s].y, w));
            acc[s].z = __fadd_rn(acc[s].z, __fmul_rn(r[i][s].z, w));
            acc[s].w = __fadd_rn(acc[s].w, __fmul_rn(r[i][s].w, w));
          }
        }
      }
    }
  }
  // jnp.maximum(denom, 1): a NaN denom stays NaN
  const float d = (denom >= 1.0f || denom != denom) ? denom : 1.0f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (col + kStripe * s < e) {
      float4 o = acc[s];
      if (mean) {
        o.x = __fdiv_rn(o.x, d);
        o.y = __fdiv_rn(o.y, d);
        o.z = __fdiv_rn(o.z, d);
        o.w = __fdiv_rn(o.w, d);
      }
      *reinterpret_cast<float4*>(out + bag * e + col + kStripe * s) = o;
    }
  }
}

template <int S, int G>
void launch_warp(const void* table, const void* ids, const void* mask, void* out,
                 int64_t v, int e, int64_t bags, int l, int mean, cudaStream_t stream) {
  const int64_t blocks = (bags + kWarpBags - 1) / kWarpBags;
  embedding_bag_warp_kernel<S, G><<<static_cast<unsigned>(blocks), kWarpThreads, 0, stream>>>(
      static_cast<const float*>(table), static_cast<const int32_t*>(ids),
      static_cast<const float*>(mask), static_cast<float*>(out), v, e, bags, l, mean);
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

// the warp kernel: table (v, e) f32 and out (bags, e) f32 16-byte aligned,
// e a multiple of 4 up to 4 * kStripe; ids (bags, l) int32, mask (bags, l)
// f32; mean != 0 divides by max(sum(mask), 1)
int embedding_bag_warp_launch(const void* table, const void* ids, const void* mask,
                              void* out, int64_t v, int e, int64_t bags, int l,
                              int mean, void* stream) {
  if (e < 4 || e % 4 != 0 || e > 4 * kStripe || v < 1 ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      (bags + kWarpBags - 1) / kWarpBags >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bags > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch ((e + kStripe - 1) / kStripe) {   // stripes; G * S float4s in flight
      case 1: launch_warp<1, 8>(table, ids, mask, out, v, e, bags, l, mean, s); break;
      case 2: launch_warp<2, 4>(table, ids, mask, out, v, e, bags, l, mean, s); break;
      case 3: launch_warp<3, 2>(table, ids, mask, out, v, e, bags, l, mean, s); break;
      default: launch_warp<4, 2>(table, ids, mask, out, v, e, bags, l, mean, s); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
