// Batched stripe decode for Hopper (sm_90a): the extract half of the DPP
// worker, three launches per stripe.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/decode.py:
//   xor_decrypt   (decode.py:49)  -> xor_decrypt_kernel
//   dense_unpack  (decode.py:87)  -> dense_unpack_warp_kernel, dense_unpack_kernel
//   ragged_gather (decode.py:125) -> ragged_gather_vec_kernel, ragged_gather_kernel
//
// What bounds them on an H100: bytes.  Each does a handful of integer
// operations per 4-byte word, far below the card's ~300 operations per
// byte of memory traffic, so the least time is the bytes moved over
// 3.35 TB/s: at the main path's shapes (a few hundred KB to 1 MB a
// launch) well under 2 us, which means launch latency and the host<->device
// copies around them dominate.
//
// Design:
//   * xor_decrypt: at the main path's ~0.74 MB a launch it sits at the
//     launch floor, so the grid is what counts: 128-thread blocks sized to
//     the work (no grid-stride loop), each thread two independent 16-byte
//     loads through the read-only path, both issued before either store,
//     neighbouring threads on neighbouring addresses.  Timed in turns on an
//     H100 (PERF.md) it beat torch.bitwise_xor, where a grid-stride loop
//     of one load a step in 256-thread blocks, one load a thread, or four
//     a thread did not.
//   * dense_unpack, two routes (kernels/decode.py picks one from W before
//     the launch).  The TPU kernel expanded the whole bitmap and took a
//     cumsum over a VMEM tile; here a __popc scan over the bitmap words
//     gives every word's exclusive prefix.  np.packbits is MSB-first per
//     byte, so row 32w+k sits at bit 8*(k/8)+7-(k%8) of the LE word; a bit
//     reversal within each byte (__brev + __byte_perm) moves it to bit k,
//     so the rank within the word is __popc of the bits below k.  Ranks
//     are clipped to [0, C-1] exactly as the reference clips them.
//     - warp route (W <= 32 words, every stripe of up to 1,024 rows): a
//       block of 8 W threads a feature, each thread 4 consecutive rows
//       written as one 16-byte store (rows are 128 W bytes apart).  Every
//       warp loads the feature's words (one a lane) and scans them with
//       shuffles itself, so there is no shared memory and no barrier: the
//       block's one dependent step is the bitmap load, then each thread's
//       four value loads, issued together.  At the main path's 504 x 16
//       words that is 16 warps an SM.  Probe builds on an H100 (PERF.md)
//       ran slower with one warp a feature (four features a block, each
//       lane four groups) and with the value row staged in shared memory by
//       cp.async before the scan: the thread-level parallelism, not the
//       second L2 round trip, sets the time at this size.
//     - block route (any W): one 256-thread block a feature, the scan over
//       the block in chunks of 256 words, a gather from global memory.
//   * ragged_gather, two routes (picked from the operands' layout):
//     __funnelshift_r(lo, hi, sh) is lo >>> sh | hi << (32 - sh) and
//     exactly lo for sh = 0; indices outside the source read as 0 instead
//     of faulting.
//     - vec route (contiguous idx, shift and output with 8-byte aligned
//       bases and an even count: every (M, 128) operand the engine
//       builds): two outputs a thread, idx and shift as two int2 loads
//       issued together, one 8-byte store, 256-thread blocks sized to the
//       work (no grid-stride loop).  The engine lays out each region as
//       one run of even length, so every pair of its outputs reads
//       consecutive words at one shift: the pair loads 3 source words once
//       and splices them, where two general pairs would load 4.  Any other
//       pair (a mixed shift, indices that jump) takes the general pairs.
//       Probe builds on an H100 (PERF.md) ran four outputs a thread (5
//       words for a run of 4, 16-byte lanes) slower in 64- to 512-thread
//       blocks: more threads in flight, not fewer loads, set the time.
//     - scalar route: one output a thread through a grid-stride loop.
//
// Kernels allocate nothing: the wrappers allocate outputs.  All work is in
// the int32 bit domain, so NaN payloads and subnormals move exactly.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kXorKey32 = 0x5A5A5A5Au;
constexpr int32_t kNanBits = 0x7FC00000;
constexpr int kUnpackThreads = 256;
constexpr int kXorThreads = 128;
constexpr int kXorLoads = 2;    // independent 16-byte loads a thread
constexpr int kUnpackWarpMaxWords = 32;                       // a bitmap word a lane
constexpr int kUnpackWarpMaxThreads = 8 * kUnpackWarpMaxWords;  // 4 rows a thread
constexpr int kGatherVecThreads = 256;

__global__ void __launch_bounds__(kXorThreads)
xor_decrypt_kernel(const int4* __restrict__ in, int4* __restrict__ out, int64_t n4) {
  const int k = static_cast<int>(kXorKey32);
  const int64_t base = static_cast<int64_t>(blockIdx.x) * (kXorThreads * kXorLoads) + threadIdx.x;
  int4 v[kXorLoads];
#pragma unroll
  for (int j = 0; j < kXorLoads; ++j) {
    const int64_t i = base + j * kXorThreads;
    if (i < n4) v[j] = __ldg(in + i);
  }
#pragma unroll
  for (int j = 0; j < kXorLoads; ++j) {
    const int64_t i = base + j * kXorThreads;
    if (i < n4) {
      int4 w = v[j];
      w.x ^= k;
      w.y ^= k;
      w.z ^= k;
      w.w ^= k;
      out[i] = w;
    }
  }
}

// bit k of the result is row k of the word's 32 rows (packbits order)
__device__ __forceinline__ uint32_t rows_order(uint32_t word) {
  return __byte_perm(__brev(word), 0, 0x0123);
}

__global__ void __launch_bounds__(kUnpackThreads)
dense_unpack_kernel(const int32_t* __restrict__ bitmap,
                    const int32_t* __restrict__ values,
                    int32_t* __restrict__ out, int w, int c) {
  __shared__ uint32_t s_rows[kUnpackThreads];
  __shared__ int32_t s_prefix[kUnpackThreads];
  __shared__ int32_t s_warp[kUnpackThreads / 32];
  const int f = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int32_t* bm = bitmap + static_cast<int64_t>(f) * w;
  const int32_t* vals = values + static_cast<int64_t>(f) * c;
  int32_t* o = out + static_cast<int64_t>(f) * w * 32;
  int32_t carry = 0;
  for (int base = 0; base < w; base += kUnpackThreads) {
    const int wi = base + t;
    const uint32_t r = wi < w ? rows_order(static_cast<uint32_t>(bm[wi])) : 0u;
    const int32_t pop = __popc(r);
    // inclusive scan of the per-word popcounts: within warps, then across
    int32_t incl = pop;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int32_t s = lane < kUnpackThreads / 32 ? s_warp[lane] : 0;
#pragma unroll
      for (int d = 1; d < kUnpackThreads / 32; d <<= 1) {
        const int32_t y = __shfl_up_sync(0xffffffffu, s, d);
        if (lane >= d) s += y;
      }
      if (lane < kUnpackThreads / 32) s_warp[lane] = s;   // inclusive warp sums
    }
    __syncthreads();
    const int32_t warp_base = warp > 0 ? s_warp[warp - 1] : 0;
    s_rows[t] = r;
    s_prefix[t] = carry + warp_base + incl - pop;       // exclusive prefix
    const int32_t chunk_total = s_warp[kUnpackThreads / 32 - 1];
    __syncthreads();
    const int nw = min(kUnpackThreads, w - base);
    int32_t* ob = o + static_cast<int64_t>(base) * 32;
    for (int j = t; j < nw * 32; j += kUnpackThreads) {
      const int wl = j >> 5;
      const int k = j & 31;
      const uint32_t rw = s_rows[wl];
      int32_t v = kNanBits;
      if ((rw >> k) & 1u) {
        const int32_t rank = s_prefix[wl] + __popc(rw & ((1u << k) - 1u));
        v = vals[min(max(rank, 0), c - 1)];
      }
      ob[j] = v;
    }
    carry += chunk_total;
    __syncthreads();   // s_rows / s_prefix / s_warp are rewritten next chunk
  }
}

// source word a, 0 outside the source
__device__ __forceinline__ uint32_t src_word(const int32_t* __restrict__ src, int64_t a,
                                             int64_t n_src) {
  return (a >= 0 && a < n_src) ? static_cast<uint32_t>(__ldg(src + a)) : 0u;
}

__global__ void ragged_gather_kernel(const int32_t* __restrict__ src,
                                     const int32_t* __restrict__ idx,
                                     const int32_t* __restrict__ shift,
                                     int32_t* __restrict__ out, int64_t n_src,
                                     int64_t n_out) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n_out; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t a = idx[i];
    out[i] = static_cast<int32_t>(__funnelshift_r(src_word(src, a, n_src),
                                                  src_word(src, a + 1, n_src),
                                                  static_cast<uint32_t>(shift[i])));
  }
}

// the warp route: a block a feature of 8 W threads (W <= 32 rounded up to a
// warp), thread q writing rows 4q..4q+3 of word q/8.  Every warp loads the
// feature's W bitmap words (one a lane) and scans their popcounts itself, so
// the block shares nothing and needs no barrier.
__global__ void __launch_bounds__(kUnpackWarpMaxThreads)
dense_unpack_warp_kernel(const int32_t* __restrict__ bitmap,
                         const int32_t* __restrict__ values,
                         int32_t* __restrict__ out, int w, int c) {
  const int feat = blockIdx.x;
  const int q = threadIdx.x;
  const int lane = q & 31;
  const uint32_t word =
      lane < w ? static_cast<uint32_t>(__ldg(bitmap + static_cast<int64_t>(feat) * w + lane))
               : 0u;
  const uint32_t r = rows_order(word);
  const int32_t pop = __popc(r);
  int32_t incl = pop;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  // q's word and the rows present before it, from the lane that holds it
  const uint32_t rw = __shfl_sync(0xffffffffu, r, q >> 3);
  const int32_t pre = __shfl_sync(0xffffffffu, incl - pop, q >> 3);
  if (q >= 8 * w) return;                      // the padding of a W below 4
  const int32_t* vals = values + static_cast<int64_t>(feat) * c;
  const int b0 = (q & 7) * 4;
  int32_t v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {                // four independent gathers in flight
    const int bit = b0 + k;
    v[k] = kNanBits;
    if ((rw >> bit) & 1u) {
      const int32_t rank = pre + __popc(rw & ((1u << bit) - 1u));
      v[k] = __ldg(vals + min(rank, c - 1));
    }
  }
  reinterpret_cast<int4*>(out + static_cast<int64_t>(feat) * w * 32)[q] =
      make_int4(v[0], v[1], v[2], v[3]);
}

// the vec route: two outputs a thread, idx and shift as int2 loads issued
// together, one 8-byte store
__global__ void __launch_bounds__(kGatherVecThreads)
ragged_gather_vec_kernel(const int32_t* __restrict__ src, const int2* __restrict__ idx,
                         const int2* __restrict__ shift, int2* __restrict__ out,
                         int64_t n_src, int64_t n2) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kGatherVecThreads + threadIdx.x;
  if (i >= n2) return;
  const int2 a = __ldg(idx + i);
  const int2 s = __ldg(shift + i);
  const int64_t a0 = a.x;
  uint32_t r0, r1;
  if (a.y == a0 + 1 && s.y == s.x) {
    // a run: 3 consecutive source words, the middle one loaded once
    const uint32_t w0 = src_word(src, a0, n_src);
    const uint32_t w1 = src_word(src, a0 + 1, n_src);
    const uint32_t w2 = src_word(src, a0 + 2, n_src);
    r0 = __funnelshift_r(w0, w1, static_cast<uint32_t>(s.x));
    r1 = __funnelshift_r(w1, w2, static_cast<uint32_t>(s.x));
  } else {
    const int64_t a1 = a.y;
    r0 = __funnelshift_r(src_word(src, a0, n_src), src_word(src, a0 + 1, n_src),
                         static_cast<uint32_t>(s.x));
    r1 = __funnelshift_r(src_word(src, a1, n_src), src_word(src, a1 + 1, n_src),
                         static_cast<uint32_t>(s.y));
  }
  out[i] = make_int2(static_cast<int32_t>(r0), static_cast<int32_t>(r1));
}

int grid_for(int64_t n, int threads) {
  const int64_t blocks = (n + threads - 1) / threads;
  // enough blocks to fill 132 SMs many times over; the loops stride the rest
  return static_cast<int>(blocks < 132 * 16 ? (blocks > 0 ? blocks : 1) : 132 * 16);
}

}  // namespace

extern "C" {

// words: n_words int32 (a multiple of 4), in and out 16-byte aligned
int xor_decrypt_launch(const void* in, void* out, int64_t n_words, void* stream) {
  const int64_t n4 = n_words / 4;
  const int64_t blocks = (n4 + kXorThreads * kXorLoads - 1) / (kXorThreads * kXorLoads);
  if (blocks >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (n4 > 0) {
    xor_decrypt_kernel<<<static_cast<unsigned>(blocks), kXorThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int4*>(in), static_cast<int4*>(out), n4);
  }
  return static_cast<int>(cudaGetLastError());
}

// bitmap (f, w), values (f, c) with c >= 1, out (f, 32 w); all int32
int dense_unpack_launch(const void* bitmap, const void* values, void* out,
                        int f, int w, int c, void* stream) {
  if (f > 0 && w > 0) {
    dense_unpack_kernel<<<f, kUnpackThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(bitmap), static_cast<const int32_t*>(values),
        static_cast<int32_t*>(out), w, c);
  }
  return static_cast<int>(cudaGetLastError());
}

// the warp route: bitmap (f, w) with 1 <= w <= 32, values (f, c) with c >= 1,
// out (f, 32 w) 16-byte aligned; all int32
int dense_unpack_warp_launch(const void* bitmap, const void* values, void* out,
                             int f, int w, int c, void* stream) {
  if (w < 1 || w > kUnpackWarpMaxWords || c < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (f > 0) {
    const int threads = (8 * w + 31) / 32 * 32;
    dense_unpack_warp_kernel<<<f, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(bitmap), static_cast<const int32_t*>(values),
        static_cast<int32_t*>(out), w, c);
  }
  return static_cast<int>(cudaGetLastError());
}

// the vec route: src n_src int32; idx, shift, out n_out int32, n_out even,
// idx, shift and out 8-byte aligned
int ragged_gather_vec_launch(const void* src, const void* idx, const void* shift,
                             void* out, int64_t n_src, int64_t n_out, void* stream) {
  const int64_t n2 = n_out / 2;
  const int64_t blocks = (n2 + kGatherVecThreads - 1) / kGatherVecThreads;
  if (n_out % 2 || blocks >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (n2 > 0) {
    ragged_gather_vec_kernel<<<static_cast<unsigned>(blocks), kGatherVecThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(src), static_cast<const int2*>(idx),
        static_cast<const int2*>(shift), static_cast<int2*>(out), n_src, n2);
  }
  return static_cast<int>(cudaGetLastError());
}

// src n_src int32; idx, shift, out n_out int32
int ragged_gather_launch(const void* src, const void* idx, const void* shift,
                         void* out, int64_t n_src, int64_t n_out, void* stream) {
  if (n_out > 0) {
    ragged_gather_kernel<<<grid_for(n_out, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(src), static_cast<const int32_t*>(idx),
        static_cast<const int32_t*>(shift), static_cast<int32_t*>(out), n_src, n_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
