// Batched stripe decode for Hopper (sm_90a): the extract half of the DPP
// worker, three launches per stripe.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/decode.py:
//   xor_decrypt   (decode.py:49)  -> xor_decrypt_kernel
//   dense_unpack  (decode.py:87)  -> dense_unpack_kernel
//   ragged_gather (decode.py:125) -> ragged_gather_kernel
//
// What bounds them on an H100: bytes.  Each does a handful of integer
// operations per 4-byte word, far below the card's ~300 operations per
// byte of memory traffic, so the least time is the bytes moved over
// 3.35 TB/s: at the main path's shapes (a few hundred KB to 1 MB a
// launch) well under 2 us, which means launch latency and the host<->device
// copies around them dominate.
//
// Design:
//   * xor_decrypt: grid-stride loop over 16-byte int4 loads and stores,
//     neighbouring threads on neighbouring addresses.
//   * dense_unpack: one block per feature.  The TPU kernel expanded the
//     whole bitmap and took a cumsum over a VMEM tile; here each thread
//     takes one bitmap word, a warp-shuffle scan of __popc gives every
//     word's exclusive prefix, and the block then writes the word's 32
//     output rows with coalesced stores.  np.packbits is MSB-first per
//     byte, so row 32w+k sits at bit 8*(k/8)+7-(k%8) of the LE word; a
//     bit reversal within each byte (__brev + __byte_perm) moves it to
//     bit k, so the rank within the word is __popc of the bits below k.
//     Ranks are clipped to [0, C-1] exactly as the reference clips them.
//   * ragged_gather: one thread per output word; __funnelshift_r(lo, hi,
//     sh) is lo >>> sh | hi << (32 - sh) and exactly lo for sh = 0.
//     Indices outside the source read as 0 instead of faulting.
//
// Kernels allocate nothing: the wrappers allocate outputs.  All work is in
// the int32 bit domain, so NaN payloads and subnormals move exactly.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kXorKey32 = 0x5A5A5A5Au;
constexpr int32_t kNanBits = 0x7FC00000;
constexpr int kUnpackThreads = 256;

__global__ void xor_decrypt_kernel(const int4* __restrict__ in,
                                   int4* __restrict__ out, int64_t n4) {
  const int k = static_cast<int>(kXorKey32);
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n4; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    int4 v = in[i];
    v.x ^= k;
    v.y ^= k;
    v.z ^= k;
    v.w ^= k;
    out[i] = v;
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

__global__ void ragged_gather_kernel(const int32_t* __restrict__ src,
                                     const int32_t* __restrict__ idx,
                                     const int32_t* __restrict__ shift,
                                     int32_t* __restrict__ out, int64_t n_src,
                                     int64_t n_out) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n_out; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t a = idx[i];
    const uint32_t lo = (a >= 0 && a < n_src) ? static_cast<uint32_t>(src[a]) : 0u;
    const uint32_t hi =
        (a + 1 >= 0 && a + 1 < n_src) ? static_cast<uint32_t>(src[a + 1]) : 0u;
    out[i] = static_cast<int32_t>(__funnelshift_r(lo, hi, static_cast<uint32_t>(shift[i])));
  }
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
  if (n4 > 0) {
    xor_decrypt_kernel<<<grid_for(n4, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
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
