// Mamba-2 SSD chunked forward for Hopper (sm_90a): the state-space scan of
// every SSM layer's prefill, one launch per layer, returning y and the
// final state.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd_chunk.py:
//   ssd_chunk_forward (ssd_chunk.py:67, pallas_call at :84, body _kernel :25)
//     -> ssd_chunk_kernel
//
// It computes the TPU kernel's function chunk by chunk.  For one (batch,
// head) and a chunk of Q positions, with cs the inclusive cumsum of dt*A
// over the chunk:
//   m[i, j]  = (C_i . B_j) * exp(cs_i - cs_j) * dt_j for i >= j, exactly 0
//              for i < j (the exp is never taken there), rounded to x's type;
//   y_i      = sum_j m[i, j] x_j + exp(cs_i) (C_i . state), in float32;
//   state    = exp(cs_last) state + sum_j (B_j dt_j exp(cs_last - cs_j)) x_j^T,
// the state (N, P) float32 carried from chunk to chunk, starting at zero (or
// at a given initial state).  C . B^T stays in float32, as the TPU kernel's
// preferred_element_type keeps it (the reference model's XLA path rounds it
// to bf16).  What differs from the TPU kernel:
//   * the final state is written out, (B, H, P, N) float32, the layout the
//     model caches (the TPU kernel returns y only);
//   * operands are read in the model's layout through strides: x (B, S, H,
//     P), dt (B, S, H) float32, A per head (or per batch row and head), B
//     and C (B, S, G, N) with head h reading group h / (H / G).  Neither a
//     transpose nor the 80x expansion of B and C to heads (168 MB a layer at
//     the serve shape) is materialized.  With H = G = 1 and A per batch row
//     it is exactly the TPU kernel's (BH, S, P) function;
//   * the TPU grid's sequential chunk axis becomes a loop inside the block;
//   * a ragged last chunk (S % Q != 0) is masked: its rows past S are staged
//     as zeros with dt = 0, so they add nothing and leave cs unchanged, and
//     are never written.  The TPU kernel asserts S % Q == 0, and the
//     reference model then falls back to one chunk of S; the function is the
//     same up to rounding;
//   * cs is accumulated and differenced in float64.  At the full-width
//     random model dt*A reaches -150 a position and |cs| 7000 in a chunk,
//     where a float32 cumsum keeps only ~5e-4 absolute and exp(cs_i - cs_j)
//     of two nearby positions loses that much relative accuracy (with dt
//     to ~190 and |cs| ~7,400 a chunk, the reference's form sits ~8e-4 of
//     the rms from the float64 recurrence and this form ~2e-6:
//     tests/test_torch_ssm.py::test_ssd_float64_cumsum_at_large_dt); in
//     float64 the difference is exact to float32 before expf.
//     So the kernel is closer to the sequential recurrence than the TPU
//     kernel and the reference model, whose cumsum is float32 (the port's
//     CPU form, repro_torch/models/ssm.py, keeps cs in float64 too).
// expf is the accurate one: no --use_fast_math, no --ftz.
//
// What bounds it on an H100: bytes, narrowly.  At the serve shape
// (mamba2-2.7b prefill, B=4, S=1024, H=80, P=64, G=1, N=128, Q=256, bf16)
// the function needs 1280 (b, h, chunk) cells x (Q(Q+1)/2 x 2N for C.B^T
// + Q(Q+1)/2 x 2P for m.x + 2QNP for C.state + 2QNP for the state update)
// = 26.9 GFLOP, ~27 us at the card's 989 TFLOP/s bf16 dense tensor peak;
// the bytes (x and y 42 MB each, B and C 1 MB each, dt 1.3 MB, the state
// 10.5 MB) take ~29 us at 3.35 TB/s.  This first kernel does its products
// with float32 FMAs on the CUDA cores (67 TFLOP/s), not wgmma, so it
// cannot come near that bound.  With G = 1, C.B^T is the same for all 80
// heads of a batch row: the reference computes it once per group
// (src/repro/models/ssm.py:110), and computing it once per (batch, group,
// chunk) would halve this kernel's work.  The bf16 calls of the main path
// go to ssd_chunk_sm90.cu's wgmma kernel instead (kernels/ssd_chunk.py::
// route); this one takes every other call.
//
// Design (simple and right first):
//   * one block of 256 threads per (b, h), looping over the chunks; the
//     state (N x P float32, at most 64 KB) lives in shared memory;
//   * a chunk is cut into 64-row tiles: for query tile I, C_I is staged in
//     shared memory, first y_I = exp(cs_I) (C_I . state), then for key tiles
//     J <= I (tiles wholly above the diagonal are all zeros and skipped) B_J
//     and x_J are staged, the 64 x 64 block of C.B^T formed, m built and
//     rounded tile by tile (a 256 x 256 float32 m would be 256 KB, over the
//     227 KB a block may hold), and y_I += m_IJ . x_J;
//   * at the diagonal tile (J == I, once per J) B_J and x_J also add their
//     part of the state update into registers, and after the chunk's last
//     query tile the state is decayed and updated in place;
//   * thread (ty, tx) of a 16 x 16 grid owns rows 4*ty..4*ty+3 and columns
//     tx + 16*j of every 64-wide tile, as in flash_attention.cu; operands
//     are staged as float32, C and B rows padded by one float so column
//     reads hit distinct banks;
//   * N and P are padded up to 64 or 128 with zeros (N, P <= 128); the
//     chunk is at most 256.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // 16 x 16
constexpr int kTile = 64;        // rows of a query or key tile
constexpr int kMaxChunk = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Strides {
  int64_t b, s, h;   // batch, position, head (or group)
};

template <int NP, int PP>
constexpr size_t smem_bytes() {
  return sizeof(double) * kMaxChunk +
         sizeof(float) * (2 * kMaxChunk + 2 * kTile * (NP + 1) + kTile * PP +
                          kTile * (kTile + 1) + NP * PP);
}

template <typename T, int NP, int PP>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a, const T* __restrict__ bmat,
                 const T* __restrict__ cmat, const float* __restrict__ init,
                 T* __restrict__ y, float* __restrict__ state_out, int s_len, int heads,
                 int group, int n_dim, int p_dim, int chunk, Strides xs, Strides ds,
                 int64_t a_sb, int64_t a_sh, Strides bs, Strides cs_str, Strides ys) {
  constexpr int kCLD = NP + 1;           // row stride of the staged C and B tiles
  constexpr int kMLD = kTile + 1;
  constexpr int kRows = NP / 16;         // state rows per thread (update)
  constexpr int kCols = PP / 16;         // output and state columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* s_cs = reinterpret_cast<double*>(smem_raw);       // kMaxChunk
  float* s_dt = reinterpret_cast<float*>(s_cs + kMaxChunk);  // kMaxChunk
  float* s_w = s_dt + kMaxChunk;                             // dt_j exp(cs_last - cs_j)
  float* s_c = s_w + kMaxChunk;                              // kTile x kCLD
  float* s_b = s_c + kTile * kCLD;                           // kTile x kCLD
  float* s_x = s_b + kTile * kCLD;                           // kTile x PP
  float* s_m = s_x + kTile * PP;                             // kTile x kMLD
  float* s_state = s_m + kTile * kMLD;                       // NP x PP, (n, p)

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh % heads;
  const int g = h / group;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const float av = a[b * a_sb + h * a_sh];
  const T* xb = x + b * xs.b + h * xs.h;
  const float* db = dt + b * ds.b + h * ds.h;
  const T* bb = bmat + b * bs.b + g * bs.h;
  const T* cb = cmat + b * cs_str.b + g * cs_str.h;
  T* yb = y + b * ys.b + h * ys.h;
  const int64_t pn = static_cast<int64_t>(p_dim) * n_dim;

  for (int i = tid; i < NP * PP; i += kThreads) {
    const int n = i / PP, p = i % PP;
    float v = 0.0f;
    if (init != nullptr && n < n_dim && p < p_dim) v = init[bh * pn + p * n_dim + n];
    s_state[i] = v;
  }

  for (int c0 = 0; c0 < s_len; c0 += chunk) {
    const int qlen = min(chunk, s_len - c0);
    __syncthreads();                 // the previous chunk is done with s_dt, s_cs, s_w
    for (int i = tid; i < kMaxChunk; i += kThreads)
      s_dt[i] = i < qlen ? db[static_cast<int64_t>(c0 + i) * ds.s] : 0.0f;
    __syncthreads();
    if (tid < 32) {
      // inclusive cumsum of dt*A (the product in float32, as the reference
      // forms it; the sum in float64): lane l sums positions 8l..8l+7, then
      // a shuffle scan adds the lanes before it
      double run = 0.0, part[kMaxChunk / 32];
#pragma unroll
      for (int k = 0; k < kMaxChunk / 32; ++k) {
        run += static_cast<double>(s_dt[tid * (kMaxChunk / 32) + k] * av);
        part[k] = run;
      }
      double incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double t = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += t;
      }
      const double before = incl - run;
#pragma unroll
      for (int k = 0; k < kMaxChunk / 32; ++k)
        s_cs[tid * (kMaxChunk / 32) + k] = before + part[k];
    }
    __syncthreads();
    const double cs_last = s_cs[qlen - 1];
    for (int i = tid; i < kMaxChunk; i += kThreads)
      s_w[i] = s_dt[i] * expf(static_cast<float>(cs_last - s_cs[i]));

    float dstate[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) dstate[r][c] = 0.0f;

    const int n_tiles = (qlen + kTile - 1) / kTile;
    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * kTile;
      __syncthreads();               // the previous tile is done with s_c (and s_w is set)
      for (int i = tid; i < kTile * NP; i += kThreads) {
        const int r = i / NP, n = i % NP;
        const int row = i0 + r;
        s_c[r * kCLD + n] = (row < qlen && n < n_dim)
                                ? to_float(cb[static_cast<int64_t>(c0 + row) * cs_str.s + n])
                                : 0.0f;
      }
      __syncthreads();

      // inter-chunk: exp(cs_i) (C_i . state)
      float acc[4][kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
#pragma unroll 4
      for (int n = 0; n < n_dim; ++n) {
        float cv[4], sv[kCols];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = s_c[(ty * 4 + i) * kCLD + n];
#pragma unroll
        for (int c = 0; c < kCols; ++c) sv[c] = s_state[n * PP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(cv[i], sv[c], acc[i][c]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = expf(static_cast<float>(s_cs[i0 + ty * 4 + i]));
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] *= e;
      }

      // intra-chunk: key tiles up to the diagonal
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kTile;
        __syncthreads();             // the previous key tile is done with s_b, s_x, s_m
        for (int i = tid; i < kTile * NP; i += kThreads) {
          const int r = i / NP, n = i % NP;
          const int row = j0 + r;
          s_b[r * kCLD + n] = (row < qlen && n < n_dim)
                                  ? to_float(bb[static_cast<int64_t>(c0 + row) * bs.s + n])
                                  : 0.0f;
        }
        for (int i = tid; i < kTile * PP; i += kThreads) {
          const int r = i / PP, p = i % PP;
          const int row = j0 + r;
          s_x[i] = (row < qlen && p < p_dim)
                       ? to_float(xb[static_cast<int64_t>(c0 + row) * xs.s + p])
                       : 0.0f;
        }
        __syncthreads();

        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
        for (int n = 0; n < n_dim; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = s_c[(ty * 4 + i) * kCLD + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = s_b[(tx + 16 * j) * kCLD + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(cv[i], bv[j], sc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = i0 + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = j0 + tx + 16 * j;
            float m = 0.0f;
            if (row >= col)
              m = (sc[i][j] * expf(static_cast<float>(s_cs[row] - s_cs[col]))) * s_dt[col];
            s_m[(ty * 4 + i) * kMLD + tx + 16 * j] = to_float(from_float<T>(m));
          }
        }
        __syncthreads();

#pragma unroll 4
        for (int k = 0; k < kTile; ++k) {
          float mv[4], xv[kCols];
#pragma unroll
          for (int i = 0; i < 4; ++i) mv[i] = s_m[(ty * 4 + i) * kMLD + k];
#pragma unroll
          for (int c = 0; c < kCols; ++c) xv[c] = s_x[k * PP + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(mv[i], xv[c], acc[i][c]);
        }

        if (jt == it) {
          // this key tile's part of the state update, once per tile:
          // dstate[n, p] += sum_k (B[k, n] w_k) x[k, p]
#pragma unroll 2
          for (int k = 0; k < kTile; ++k) {
            const float w = s_w[j0 + k];
            float bw[kRows], xv[kCols];
#pragma unroll
            for (int r = 0; r < kRows; ++r) bw[r] = s_b[k * kCLD + ty + 16 * r] * w;
#pragma unroll
            for (int c = 0; c < kCols; ++c) xv[c] = s_x[k * PP + tx + 16 * c];
#pragma unroll
            for (int r = 0; r < kRows; ++r)
#pragma unroll
              for (int c = 0; c < kCols; ++c) dstate[r][c] = fmaf(bw[r], xv[c], dstate[r][c]);
          }
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = i0 + ty * 4 + i;
        if (row >= qlen) continue;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int p = tx + 16 * c;
          if (p < p_dim) yb[static_cast<int64_t>(c0 + row) * ys.s + p] = from_float<T>(acc[i][c]);
        }
      }
    }

    __syncthreads();                 // every query tile is done reading the old state
    const float decay = expf(static_cast<float>(cs_last));
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        float* st = &s_state[(ty + 16 * r) * PP + tx + 16 * c];
        *st = decay * *st + dstate[r][c];
      }
  }

  __syncthreads();
  for (int64_t i = tid; i < pn; i += kThreads) {
    const int p = static_cast<int>(i / n_dim), n = static_cast<int>(i % n_dim);
    state_out[bh * pn + i] = s_state[n * PP + p];
  }
}

template <typename T, int NP, int PP>
int launch(const void* x, const void* dt, const void* a, const void* bmat, const void* cmat,
           const void* init, void* y, void* state_out, int batch, int s_len, int heads,
           int groups, int n_dim, int p_dim, int chunk, Strides xs, Strides ds, int64_t a_sb,
           int64_t a_sh, Strides bs, Strides cs, Strides ys, cudaStream_t stream) {
  const size_t smem = smem_bytes<NP, PP>();
  // more than 48 KB of shared memory needs the attribute, set once per
  // device for each instantiation (setting it twice is harmless)
  static unsigned long long configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(configured & bit)) {
    err = cudaFuncSetAttribute(ssd_chunk_kernel<T, NP, PP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured |= bit;
  }
  ssd_chunk_kernel<T, NP, PP><<<static_cast<unsigned>(batch * heads), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const T*>(bmat), static_cast<const T*>(cmat),
      static_cast<const float*>(init), static_cast<T*>(y), static_cast<float*>(state_out),
      s_len, heads, heads / groups, n_dim, p_dim, chunk, xs, ds, a_sb, a_sh, bs, cs, ys);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_t(const void* x, const void* dt, const void* a, const void* bmat, const void* cmat,
             const void* init, void* y, void* state_out, int batch, int s_len, int heads,
             int groups, int n_dim, int p_dim, int chunk, Strides xs, Strides ds, int64_t a_sb,
             int64_t a_sh, Strides bs, Strides cs, Strides ys, cudaStream_t stream) {
#define SSD_LAUNCH(NP, PP)                                                                 \
  return launch<T, NP, PP>(x, dt, a, bmat, cmat, init, y, state_out, batch, s_len, heads,  \
                           groups, n_dim, p_dim, chunk, xs, ds, a_sb, a_sh, bs, cs, ys,    \
                           stream)
  if (n_dim <= 64) {
    if (p_dim <= 64) SSD_LAUNCH(64, 64);
    SSD_LAUNCH(64, 128);
  }
  if (p_dim <= 64) SSD_LAUNCH(128, 64);
  SSD_LAUNCH(128, 128);
#undef SSD_LAUNCH
}

}  // namespace

extern "C" {

// x (B, S, H, P), dt (B, S, H) float32, B and C (B, S, G, N), y (B, S, H, P),
// each given by its (batch, position, head or group) strides in elements
// with the last dim contiguous; A float32 at b * a_sb + h * a_sh; init
// (optional, may be null) and state_out (B, H, P, N) float32 contiguous.
// H % G == 0, 1 <= N, P <= 128, 1 <= chunk <= 256, S >= 1; bf16 != 0 for
// bfloat16 x, B, C and y, else float32.
int ssd_chunk_launch(const void* x, const void* dt, const void* a, const void* bmat,
                     const void* cmat, const void* init, void* y, void* state_out,
                     int batch, int s_len, int heads, int groups, int n_dim, int p_dim,
                     int chunk, int64_t x_sb, int64_t x_ss, int64_t x_sh, int64_t d_sb,
                     int64_t d_ss, int64_t d_sh, int64_t a_sb, int64_t a_sh, int64_t b_sb,
                     int64_t b_ss, int64_t b_sg, int64_t c_sb, int64_t c_ss, int64_t c_sg,
                     int64_t y_sb, int64_t y_ss, int64_t y_sh, int bf16, void* stream) {
  if (batch < 1 || s_len < 1 || heads < 1 || groups < 1 || heads % groups != 0 ||
      n_dim < 1 || n_dim > 128 || p_dim < 1 || p_dim > 128 || chunk < 1 ||
      chunk > kMaxChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides xs{x_sb, x_ss, x_sh}, ds{d_sb, d_ss, d_sh};
  const Strides bs{b_sb, b_ss, b_sg}, cs{c_sb, c_ss, c_sg}, ys{y_sb, y_ss, y_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_t<__nv_bfloat16>(x, dt, a, bmat, cmat, init, y, state_out, batch, s_len,
                                   heads, groups, n_dim, p_dim, chunk, xs, ds, a_sb, a_sh,
                                   bs, cs, ys, st);
  return launch_t<float>(x, dt, a, bmat, cmat, init, y, state_out, batch, s_len, heads,
                         groups, n_dim, p_dim, chunk, xs, ds, a_sb, a_sh, bs, cs, ys, st);
}

}  // extern "C"
