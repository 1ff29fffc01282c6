// Flash attention forward for Hopper (sm_90a): the attention of every
// dense decoder layer's prefill, one launch per layer.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:
//   flash_attention (flash_attention.py:62, pallas_call at :81)
//     -> flash_fwd_kernel
//
// It computes the TPU kernel's function: s = (q . k) * scale in float32
// with scale = 1/sqrt(D) applied after the dot; under causal masking a
// score with q_pos < k_pos (positions from 0) is set to -2e38, not -inf;
// over the key tiles in order, m_new = max(m, max_k s), p = exp(s - m_new),
// alpha = exp(m - m_new), l = l*alpha + sum_k p, acc = acc*alpha + p.v
// with p rounded to the inputs' type before it multiplies v and acc kept
// in float32; out = acc / max(l, 1e-30), rounded to nearest even into the
// inputs' type.  expf is the accurate one: no --use_fast_math, no --ftz.
//
// q is read in the (B, S, H, D) layout the model projects it in and k, v
// in (B, T, KVH, D), all through strides (the last dim contiguous), and
// query head h reads KV head h / (H / KVH): the model materializes
// neither a transpose nor the GQA expansion.  With KVH == H and strides
// of a (B, H, S, D) tensor it is exactly the TPU kernel's (B, H, S, D)
// function.
//
// Bounds: the TPU grid pads S and T up to whole blocks.  Here key columns
// k >= T are never read (their K and V rows are staged as zeros and their
// scores as -inf, so p = 0 and they enter neither max nor sum), and query
// rows q >= S are never written.  Under causal masking a key tile wholly
// above the diagonal is skipped: every score in it is -2e38, and since key
// tile 0 always holds a visible column for every row, m is already a real
// score there, so p = exp(-2e38 - m) = 0 and alpha = 1 -- the tile adds
// exactly nothing.
//
// What bounds it on an H100: operations.  At the main path's shape
// (qwen3-8b prefill, B=4, S=T=1024, H=32, KVH=8, D=128, bf16) the causal
// work is 2*2*B*H*S*T*D/2 = 34.4 GFLOP, ~35 us at the card's 989 TFLOP/s
// bf16 dense tensor peak, above the bytes (q, k, v read once, out written
// once: 84 MB, ~25 us at 3.35 TB/s).  This first kernel does its products
// with float32 FMAs on the CUDA cores (67 TFLOP/s peak), not wgmma, so it
// cannot come near that bound; tensor-core tiling (wgmma, TMA) is later
// work.
//
// Design (simple and right first):
//   * one block of 256 threads per (b*h, 64-query tile); the Q tile and
//     each 64-row K and V tile are staged in shared memory as float32, K
//     and Q rows padded by one float so column reads hit distinct banks;
//   * thread (ty, tx) of a 16 x 16 grid owns query rows 4*ty..4*ty+3 and
//     key columns tx + 16*j of the 64 x 64 score tile (16 scores in
//     registers), and output columns tx + 16*j of its 4 rows;
//   * the row max and row sum reduce over the 16 lanes of a half-warp with
//     __shfl_xor_sync; m and l of each row live in registers;
//   * p (rounded to the inputs' type) goes through shared memory to the
//     P.V product, so each thread accumulates its 4 rows x D/16 columns;
//   * the head dim is padded up to 32, 64 or 128 with zeros (D <= 128).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // key rows per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr float kMaskValue = -2.0e38f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((kBQ + kBK) * (DP + 1) + kBK * DP + kBQ * (kBK + 1));
}

struct Strides {
  int64_t b, s, h;
};

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 int s_len, int t_len, int heads, int group, int d,
                 Strides qs, Strides ks, Strides vs, Strides os,
                 int causal, float scale) {
  constexpr int kQLD = DP + 1;
  constexpr int kPLD = kBK + 1;
  constexpr int kCols = DP / 16;           // output columns per thread
  extern __shared__ float smem[];
  float* s_q = smem;                        // kBQ x kQLD
  float* s_k = s_q + kBQ * kQLD;            // kBK x kQLD
  float* s_v = s_k + kBK * kQLD;            // kBK x DP
  float* s_p = s_v + kBK * DP;              // kBQ x kPLD

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh % heads;
  const int kvh = h / group;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  for (int i = tid; i < kBQ * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    const int row = q0 + r;
    s_q[r * kQLD + c] = (row < s_len && c < d) ? to_float(qb[row * qs.s + c]) : 0.0f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMaskValue;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  // causal: key tiles starting past the tile's last query row add nothing
  const int k_end = causal ? min(t_len, q0 + kBQ) : t_len;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();                        // the previous tile's reads are done
    for (int i = tid; i < kBK * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      const int row = k0 + r;
      const bool in = row < t_len && c < d;
      s_k[r * kQLD + c] = in ? to_float(kb[row * ks.s + c]) : 0.0f;
      s_v[r * DP + c] = in ? to_float(vb[row * vs.s + c]) : 0.0f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 8
    for (int c = 0; c < DP; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = s_q[(ty * 4 + i) * kQLD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = s_k[(tx + 16 * j) * kQLD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = sc[i][j] * scale;
        if (col >= t_len) {
          x = -INFINITY;                    // past T: no column at all
        } else if (causal && row < col) {
          x = kMaskValue;
        }
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        sum += p;
        s_p[(ty * 4 + i) * kPLD + tx + 16 * j] = to_float(from_float<T>(p));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = s_p[(ty * 4 + i) * kPLD + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = s_v[kk * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

  T* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= s_len) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < d) ob[row * os.s + col] = from_float<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* out, int b, int s_len,
           int t_len, int heads, int kv_heads, int d, Strides qs, Strides ks,
           Strides vs, Strides os, int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<DP>();
  // more than 48 KB of shared memory needs the attribute, set once per
  // device for each instantiation (setting it twice is harmless)
  static unsigned long long configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(configured & bit)) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<T, DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured |= bit;
  }
  const dim3 grid(static_cast<unsigned>(b * heads),
                  static_cast<unsigned>((s_len + kBQ - 1) / kBQ));
  flash_fwd_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), s_len, t_len, heads, heads / kv_heads, d, qs, ks, vs, os,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int b, int s_len,
             int t_len, int heads, int kv_heads, int d, Strides qs, Strides ks,
             Strides vs, Strides os, int causal, float scale, cudaStream_t stream) {
  if (d <= 32)
    return launch<T, 32>(q, k, v, out, b, s_len, t_len, heads, kv_heads, d, qs, ks, vs,
                         os, causal, scale, stream);
  if (d <= 64)
    return launch<T, 64>(q, k, v, out, b, s_len, t_len, heads, kv_heads, d, qs, ks, vs,
                         os, causal, scale, stream);
  return launch<T, 128>(q, k, v, out, b, s_len, t_len, heads, kv_heads, d, qs, ks, vs,
                        os, causal, scale, stream);
}

}  // namespace

extern "C" {

// q (B, S, H, D), k and v (B, T, KVH, D), out (B, S, H, D), each given by
// its (batch, position, head) strides in elements with the last dim
// contiguous; H % KVH == 0, 1 <= D <= 128, S, T >= 1; bf16 != 0 for
// bfloat16 operands, else float32.
int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                           int b, int s_len, int t_len, int heads, int kv_heads, int d,
                           int64_t q_sb, int64_t q_ss, int64_t q_sh,
                           int64_t k_sb, int64_t k_ss, int64_t k_sh,
                           int64_t v_sb, int64_t v_ss, int64_t v_sh,
                           int64_t o_sb, int64_t o_ss, int64_t o_sh,
                           int causal, float scale, int bf16, void* stream) {
  if (d < 1 || d > 128 || kv_heads < 1 || heads % kv_heads != 0 || s_len < 1 || t_len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh};
  const Strides vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_d<__nv_bfloat16>(q, k, v, out, b, s_len, t_len, heads, kv_heads, d, qs,
                                   ks, vs, os, causal, scale, st);
  return launch_d<float>(q, k, v, out, b, s_len, t_len, heads, kv_heads, d, qs, ks, vs,
                         os, causal, scale, st);
}

}  // extern "C"
