// Mamba-2 SSD chunked forward on Hopper's tensor cores (sm_90a): the bf16
// state-space scan of every SSM layer's prefill, one launch per layer,
// returning y and the final state.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd_chunk.py:
//   ssd_chunk_forward (ssd_chunk.py:67, pallas_call at :84, body _kernel :25)
//     -> ssd_sm90_kernel
// for bf16 x, B and C with P and N of 64 or 128, a chunk that is a multiple
// of 64 up to 256, and views whose rows cp.async can copy 16 bytes at a time
// (kernels/ssd_chunk.py::route picks it); ssd_chunk.cu's float32-FMA kernel
// takes every other call.
//
// It computes the FMA kernel's function (see ssd_chunk.cu): for one (batch,
// head) and a chunk of Q positions, cs the inclusive cumsum of dt*A (the
// product in float32, the sum in float64),
//   m[i, j] = (C_i . B_j) * exp(cs_i - cs_j) * dt_j for i >= j, 0 above,
//             rounded to bf16;
//   y_i     = exp(cs_i) (C_i . state) + sum_j m[i, j] x_j, in float32, to bf16;
//   state   = exp(cs_last) state + sum_j (x_j w_j) B_j^T,
//             w_j = dt_j exp(cs_last - cs_j),
// the (P, N) float32 state carried from chunk to chunk from zero or a given
// initial state, operands read in the model's layout through strides (head h
// reads group h / (H/G)), a ragged last chunk masked (its rows past S are
// staged as zeros with dt = 0 and never written).  Where it rounds otherwise
// than the FMA kernel:
//   * C.B^T, m.x, C.state and the state update are bf16 products on the
//     tensor cores (wgmma, float32 accumulation).  C.B^T's operands are the
//     bf16 inputs, so its float32 result is the FMA kernel's up to the order
//     of the sums;
//   * C.state reads a bf16 copy of the state (2^-9 relative a term; y is
//     held to the bf16 bound).  The state itself stays float32 in registers;
//   * the state update's operand x_j w_j is split into two bf16 terms, hi +
//     lo (hi = bf16(x w), lo = bf16(x w - hi)), each multiplied on the tensor
//     cores: the pair keeps ~2^-17 of x w, where one bf16 rounding (2^-9)
//     would put the float32 state outside its bound (5e-4 of the rms);
//   * m's exponential is ex2.approx, as m is rounded to bf16 right after,
//     of (cs_i - cs_j) * log2(e) taken from cs * log2(e) split into float32
//     hi + lo parts (within an ulp or two of the float64 difference).  In a
//     key block below the diagonal block it factors through r, the block's
//     last position: 2^((cs_i - cs_r) log2 e) a row times dt_j 2^((cs_r -
//     cs_j) log2 e) a key, both at most 1, so neither overflows and two
//     exponentials a row replace 32 a thread.  exp(cs_i), exp(cs_last) and w
//     stay accurate expf of the float64 difference rounded to float32, as in
//     the FMA kernel.
// kernels/ssd_chunk.py::sm90_form mirrors these roundings in plain PyTorch.
//
// What bounds it on an H100: bytes, narrowly (ssd_chunk.cu: ~29 us of bytes
// against ~27 us of causal bf16 tensor work at the mamba2-2.7b serve shape,
// B=4, S=1024, H=80, P=64, G=1, N=128, Q=256).  The FMA kernel reached ~11.5
// TFLOP/s of float32 FMAs at one 133 KB block per (b, h).  This kernel:
//   * runs every product as wgmma on operands in shared memory in the
//     128-byte swizzled layout (C.B^T and C.state both K-major; x and B
//     N-major with the transpose bit for m.x and the state update), or, for
//     m and x w, A fragments in registers: m goes from the C.B^T
//     accumulators to the m.x A operand as flash attention's P does;
//   * takes one block, one warpgroup, per (batch, head, 64 columns of P)
//     with ~72 KB of shared memory and at most 168 registers a thread, so
//     three blocks share an SM: the serve shape's 320 blocks are resident at
//     once.  Each block's chain of dependent steps, not the card's rates,
//     bounds the time (PERF.md: one block alone on an SM takes most of the
//     time three take);
//   * keeps the float32 state (64 x N) in registers, a 16-row slab a warp:
//     the state update's accumulators are the state;
//   * walks each chunk by 64-row query tiles I (a warp owns 16 rows), and
//     for each the key blocks J <= I of 64 positions (B_J and x_J staged by
//     cp.async).  Key blocks are visited so that the block already staged is
//     used first: 7 stagings of B and x a chunk of 4 tiles, not 10.  The
//     chunk's first C, B and x tiles are copied in while its cumsum runs,
//     and each next C tile while the tile's last key block is multiplied;
//   * the last query tile visits every key block of the chunk, so the state
//     update (decay, then x^T w B over each key block, hi and lo) runs there,
//     from the operands already staged, after the C.state products of every
//     tile have read the old state's bf16 copy;
//   * y is stored 16 bytes a thread: a butterfly over each row's 4 lanes
//     gives each lane 8 whole columns, as flash_attention_sm90.cu does.  The
//     stores are evict-first (st.global.cs): nothing here reads y again,
//     and the x, B and C tiles that each chunk stages more than once stay in
//     L2 (6% faster on an H100; PERF.md).
// C.B^T is formed per head, not once per group: sharing it across heads
// would cut the block count below one a head or hold several heads' states.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;    // one warpgroup: 16 query rows and 16 state rows a warp
constexpr int kTile = 64;        // query rows of a tile, keys of a key block, P columns a block
constexpr int kMaxChunk = 256;
constexpr uint32_t kBox = kTile * 128;   // one 64-column box of a 64-row tile, 128-byte rows
constexpr double kLog2e = 1.4426950408889634;

struct Strides {
  int64_t b, s, h;   // batch, position, head (or group), in elements
};

// Tiles in the 128-byte swizzled layout wgmma reads (1 KB aligned): a
// 64-row tile of width W is W/64 boxes of 64 rows x 128 bytes, 8 KB apart;
// 16-byte chunk c of row r lies at r * 128 + ((c ^ (r % 8)) * 16).
template <int N>
struct Smem {
  uint8_t c[(N / 64) * kBox];              // C of the query tile
  uint8_t b[(N / 64) * kBox];              // B of the key block
  uint8_t x[kBox];                         // x of the key block, 64 columns of P
  uint8_t st[(N / 64) * kBox];             // the old state's bf16 copy, (P, N)
  float4 pos[kMaxChunk];                   // {hi, lo of cs*log2(e), dt, w}
  float erow[kMaxChunk];                   // exp(cs_i)
  float colf[kMaxChunk];                   // dt_j exp(cs_r - cs_j), r the end of j's key block
  double cs[kMaxChunk];
  float dt[kMaxChunk];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of (row, 16-byte chunk) in a swizzled tile
__device__ __forceinline__ uint32_t sw_off(int row, int chunk) {
  return (chunk >> 3) * kBox + row * 128 + (((chunk & 7) ^ (row & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// wait for every copy this thread issued; fence_async_smem then makes the
// thread's shared-memory writes visible to wgmma (the async proxy), for
// every thread once the block has synchronized
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 in bits 62-63
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\nwgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from moving reads or writes of accumulator (and A
// fragment) registers across the asynchronous wgmma
template <int K>
__device__ __forceinline__ void fence_regs(float (&r)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int K>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define SSD_D32                                                                                 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),   \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), \
      "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define SSD_D64                                                                                 \
  SSD_D32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),        \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), \
      "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define SSD_R32                                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define SSD_R64                                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "  \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "   \
  "%56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 64, float32) (+)= a (64 x 16, K-major in shared memory) . b (16 x 64:
// 64 rows of 16, K-major in shared memory); both bf16
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SSD_R32
               ", %32, %33, p, 1, 1, 0, 0;\n}\n"
               : SSD_D32
               : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64, float32) += a (64 x 16 bf16, in registers) . b (16 x 64 bf16,
// N-major in shared memory: the transpose bit is set)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SSD_R32
               ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
               : SSD_D32
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 128, float32) += a (64 x 16 bf16, in registers) . b (16 x 128 bf16,
// N-major in shared memory: the transpose bit is set)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SSD_R64
               ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
               : SSD_D64
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs_state(float (&d)[N / 2], const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  if constexpr (N == 128) {
    wgmma_rs_n128(d, a, desc_b);
  } else {
    wgmma_rs_n64(d, a, desc_b);
  }
}

// d (64 x 64) = a . b^T over K = N: both 64-row tiles K-major (swizzled,
// 64-column boxes 8 KB apart, 8-row groups 1 KB apart, the start 32 bytes
// further each 16-wide step)
template <int N>
__device__ __forceinline__ void issue_kmajor(float (&d)[32], uint32_t a_tile, uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
    wgmma_ss_n64(d, sw128_desc(a_tile + off, 16, 1024), sw128_desc(b_tile + off, 16, 1024),
                 kk > 0);
  }
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// the bf16 pair of (a, b) and the pair of what it leaves
__device__ __forceinline__ void split_hi_lo(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(a, b);
  const float2 h = unpack_bf16(hi);
  lo = pack_bf16(a - h.x, b - h.y);
}

// Stage rows [row0, row0 + 64) of a chunk's (position, width) operand into
// a swizzled tile: 16 bytes a copy, rows at or past `rows` zero-filled.
template <int W>
__device__ __forceinline__ void stage(uint32_t dst, const __nv_bfloat16* src,
                                      int64_t row_stride, int row0, int rows, int tid) {
  constexpr int kPerRow = W / 8;
#pragma unroll
  for (int i = tid; i < kTile * kPerRow; i += kThreads) {
    const int r = i / kPerRow, k = i % kPerRow;
    const bool valid = row0 + r < rows;
    const __nv_bfloat16* s = valid ? src + (row0 + r) * row_stride + 8 * k : src;
    cp_async16(dst + sw_off(r, k), s, valid);
  }
}

// One block (one warpgroup) per (batch, head, 64 columns of P); see the
// header for the plan.  Warp w owns query rows 16w..16w+15 of each query
// tile and state rows (columns of P) 16w..16w+15.  An accumulator d[i] of
// an m64nK wgmma (and of the A fragments made from it) holds row
// 16w + lane/4 + 8((i >> 1) & 1), column 8(i >> 2) + 2(lane % 4) + (i & 1).
template <int N>
__global__ void __launch_bounds__(kThreads, 3)
ssd_sm90_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const __nv_bfloat16* __restrict__ bmat,
                const __nv_bfloat16* __restrict__ cmat, const float* __restrict__ init,
                __nv_bfloat16* __restrict__ y, float* __restrict__ state_out, int s_len,
                int heads, int group, int p_dim, int chunk, Strides xs, Strides ds,
                int64_t a_sb, int64_t a_sh, Strides bs, Strides cs_str, Strides ys) {
  using S = Smem<N>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024));
  const uint32_t s_c = smem_u32(sm.c), s_b = smem_u32(sm.b), s_x = smem_u32(sm.x);
  const uint32_t s_st = smem_u32(sm.st);

  const int p_tiles = p_dim / kTile;
  const int pt = blockIdx.x % p_tiles;
  const int bh = blockIdx.x / p_tiles;
  const int b = bh / heads;
  const int h = bh % heads;
  const int g = h / group;
  const int p0 = pt * kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const float av = a[b * a_sb + h * a_sh];
  const __nv_bfloat16* xb = x + b * xs.b + h * xs.h + p0;
  const float* db = dt + b * ds.b + h * ds.h;
  const __nv_bfloat16* bb = bmat + b * bs.b + g * bs.h;
  const __nv_bfloat16* cb = cmat + b * cs_str.b + g * cs_str.h;
  __nv_bfloat16* yb = y + b * ys.b + h * ys.h + p0;
  // the state's rows (columns of P) of this thread, in this block's tile
  const int sr0 = 16 * warp + gq;
  const int64_t st_base = (static_cast<int64_t>(bh) * p_dim + p0) * N;
  // ldmatrix.x4.trans lane rows and chunks: the A fragment (rows 16w.. of
  // P, 16 keys) of x's (key, P) tile read transposed
  const int x_row = (lane & 7) + 8 * (lane >> 4);
  const int x_chunk = 2 * warp + ((lane >> 3) & 1);

  float st[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int row = sr0 + 8 * ((i >> 1) & 1), col = 8 * (i >> 2) + 2 * tq + (i & 1);
    st[i] = init != nullptr ? init[st_base + static_cast<int64_t>(row) * N + col] : 0.0f;
  }
  auto write_state_copy = [&]() {
#pragma unroll
    for (int i = 0; i < N / 2; i += 2) {
      const int row = sr0 + 8 * ((i >> 1) & 1), col = 8 * (i >> 2) + 2 * tq;
      *reinterpret_cast<uint32_t*>(sm.st + sw_off(row, col >> 3) + 2 * (col & 7)) =
          pack_bf16(st[i], st[i + 1]);
    }
    fence_async_smem();
  };
  write_state_copy();

  for (int c0 = 0; c0 < s_len; c0 += chunk) {
    const int qlen = min(chunk, s_len - c0);
    const int n_tiles = (qlen + kTile - 1) / kTile;
    __syncthreads();                 // the previous chunk is done with every tile and pos
    // the first tile's C and the first key block, in flight during the cumsum
    stage<N>(s_c, cb + c0 * cs_str.s, cs_str.s, 0, qlen, tid);
    stage<N>(s_b, bb + c0 * bs.s, bs.s, 0, qlen, tid);
    stage<kTile>(s_x, xb + c0 * xs.s, xs.s, 0, qlen, tid);
    cp_async_commit();
    for (int i = tid; i < kMaxChunk; i += kThreads)
      sm.dt[i] = i < qlen ? db[static_cast<int64_t>(c0 + i) * ds.s] : 0.0f;
    __syncthreads();
    if (tid < 32) {
      // inclusive cumsum of dt*A, as ssd_chunk.cu forms it: the product in
      // float32, the sum in float64; lane l sums 8 positions, then a scan
      double run = 0.0, part[kMaxChunk / 32];
#pragma unroll
      for (int k = 0; k < kMaxChunk / 32; ++k) {
        run += static_cast<double>(sm.dt[tid * (kMaxChunk / 32) + k] * av);
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
      for (int k = 0; k < kMaxChunk / 32; ++k) sm.cs[tid * (kMaxChunk / 32) + k] = before + part[k];
    }
    __syncthreads();
    const double cs_last = sm.cs[qlen - 1];
    for (int i = tid; i < kMaxChunk; i += kThreads) {
      const double c2 = sm.cs[i] * kLog2e;
      const float hi = __double2float_rn(c2);
      const float lo = __double2float_rn(c2 - static_cast<double>(hi));
      const float d = sm.dt[i];
      sm.pos[i] = make_float4(hi, lo, d, d * expf(static_cast<float>(cs_last - sm.cs[i])));
      sm.erow[i] = expf(static_cast<float>(sm.cs[i]));
    }
    __syncthreads();
    for (int i = tid; i < kMaxChunk; i += kThreads) {
      const float4 pj = sm.pos[i], pr = sm.pos[i | (kTile - 1)];
      sm.colf[i] = pj.z * fast_exp2((pr.x - pj.x) + (pr.y - pj.y));
    }
    const float decay = expf(static_cast<float>(cs_last));

    int staged = 0;                  // the key block in sm.b / sm.x
    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * kTile;
      cp_async_wait_all();           // this tile's C (prefetched), and pos is set
      fence_async_smem();
      __syncthreads();

      // inter-chunk: y = exp(cs_i) (C_i . state), state from its bf16 copy
      float acc[32];
      wgmma_fence();
      issue_kmajor<N>(acc, s_c, s_st);
      wgmma_commit_wait();
      fence_regs(acc);
      const int row_a = i0 + 16 * warp + gq;       // this thread's rows: row_a, row_a + 8
      const float er0 = sm.erow[row_a], er1 = sm.erow[row_a + 8];
      const float2 pr0 = make_float2(sm.pos[row_a].x, sm.pos[row_a].y);
      const float2 pr1 = make_float2(sm.pos[row_a + 8].x, sm.pos[row_a + 8].y);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= ((i >> 1) & 1) ? er1 : er0;

      const bool last = it == n_tiles - 1;
      if (last) {
#pragma unroll
        for (int i = 0; i < N / 2; ++i) st[i] *= decay;
      }

      // key blocks 0..it, the one already staged first
      const int first = (staged >= 0 && staged <= it) ? staged : 0;
      for (int step = 0; step <= it; ++step) {
        const int jt = step == 0 ? first : (step <= first ? step - 1 : step);
        const int j0 = jt * kTile;
        if (jt != staged) {
          __syncthreads();           // every warp is done with the staged block
          stage<N>(s_b, bb + c0 * bs.s, bs.s, j0, qlen, tid);
          stage<kTile>(s_x, xb + c0 * xs.s, xs.s, j0, qlen, tid);
          cp_async_wait_all();
          fence_async_smem();
          __syncthreads();
          staged = jt;
        }
        const bool diag = jt == it;
        float sc[32];
        wgmma_fence();
        issue_kmajor<N>(sc, s_c, s_b);
        wgmma_commit_wait();
        fence_regs(sc);
        if (step == it && it + 1 < n_tiles) {
          // the tile's last read of C: the next tile's C is copied in while
          // this step's m . x, state update and stores run
          __syncthreads();
          stage<N>(s_c, cb + c0 * cs_str.s, cs_str.s, i0 + kTile, qlen, tid);
          cp_async_commit();
        }
        // m = (C.B^T) * exp(cs_i - cs_j) * dt_j, 0 above the diagonal, to
        // bf16: the A fragments of m . x (16 keys kk: registers 4kk..4kk+3).
        // Below the diagonal block the exponential factors through r, the
        // block's last key: exp(cs_i - cs_r) a row times colf_j, both <= 1
        uint32_t mf[16];
        if (diag) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            float m[4];
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const int jl = 8 * nt + 2 * tq + cc;
              const float4 pc = sm.pos[j0 + jl];
#pragma unroll
              for (int rr = 0; rr < 2; ++rr) {
                const float2 pr = rr ? pr1 : pr0;
                const float e = fast_exp2((pr.x - pc.x) + (pr.y - pc.y));
                const float v = (sc[4 * nt + 2 * rr + cc] * e) * pc.z;
                m[2 * rr + cc] = 16 * warp + gq + 8 * rr >= jl ? v : 0.0f;
              }
            }
            mf[2 * nt] = pack_bf16(m[0], m[1]);
            mf[2 * nt + 1] = pack_bf16(m[2], m[3]);
          }
        } else {
          const float4 pref = sm.pos[j0 + kTile - 1];
          const float f0 = fast_exp2((pr0.x - pref.x) + (pr0.y - pref.y));
          const float f1 = fast_exp2((pr1.x - pref.x) + (pr1.y - pref.y));
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const float2 cf = *reinterpret_cast<const float2*>(&sm.colf[j0 + 8 * nt + 2 * tq]);
            mf[2 * nt] = pack_bf16((sc[4 * nt] * f0) * cf.x, (sc[4 * nt + 1] * f0) * cf.y);
            mf[2 * nt + 1] = pack_bf16((sc[4 * nt + 2] * f1) * cf.x, (sc[4 * nt + 3] * f1) * cf.y);
          }
        }
        // y += m . x over the key block: x N-major (keys x P), 16 keys a step
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          const uint32_t af[4] = {mf[4 * kk], mf[4 * kk + 1], mf[4 * kk + 2], mf[4 * kk + 3]};
          wgmma_rs_n64(acc, af, sw128_desc(s_x + kk * 2048, kBox, 1024));
        }
        wgmma_commit_wait();
        fence_regs(acc);
        fence_regs(mf);

        if (last) {
          // state (P, N) += (x o w)^T B over this key block, x o w as bf16
          // hi + lo, B N-major (keys x N)
#pragma unroll
          for (int kk = 0; kk < kTile / 16; ++kk) {
            uint32_t xf[4];
            const int xr = 16 * kk + x_row;
            ldsm_x4_t(xf, s_x + sw_off(xr, x_chunk));
            const int jb = j0 + 16 * kk + 2 * tq;
            const float w0 = sm.pos[jb].w, w1 = sm.pos[jb + 1].w;
            const float w8 = sm.pos[jb + 8].w, w9 = sm.pos[jb + 9].w;
            uint32_t ahi[4], alo[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float2 v = unpack_bf16(xf[r]);
              const bool hi_keys = r >= 2;    // a2, a3: keys 2t+8, 2t+9
              split_hi_lo(v.x * (hi_keys ? w8 : w0), v.y * (hi_keys ? w9 : w1), ahi[r], alo[r]);
            }
            const uint64_t desc = sw128_desc(s_b + kk * 2048, kBox, 1024);
            wgmma_fence();
            wgmma_rs_state<N>(st, ahi, desc);
            wgmma_rs_state<N>(st, alo, desc);
            wgmma_commit_wait();
            fence_regs(st);
          }
        }
      }

      // a thread holds 2 columns of each 8-column block of its two rows;
      // two butterfly rounds over the row's 4 lanes give each lane one
      // whole block of 4 (lane t: block 4k + t), stored as 16 bytes
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = row_a + 8 * rr;
#pragma unroll
        for (int k = 0; k < kTile / 32; ++k) {
          uint32_t v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            v[i] = pack_bf16(acc[16 * k + 4 * i + 2 * rr], acc[16 * k + 4 * i + 2 * rr + 1]);
#pragma unroll
          for (int m = 1; m <= 2; m <<= 1) {
#pragma unroll
            for (int i0 = 0; i0 < 4; ++i0) {
              if (i0 & m) continue;
              const bool hi = (tq & m) != 0;
              const uint32_t got = __shfl_xor_sync(0xffffffffu, hi ? v[i0] : v[i0 | m], m);
              if (hi) {
                v[i0] = got;
              } else {
                v[i0 | m] = got;
              }
            }
          }
          if (row < qlen)
            __stcs(reinterpret_cast<uint4*>(yb + static_cast<int64_t>(c0 + row) * ys.s +
                                            8 * (4 * k + tq)), make_uint4(v[0], v[1], v[2], v[3]));
        }
      }
    }

    __syncthreads();                 // every tile's C.state has read the old copy
    write_state_copy();
  }

#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const int row = sr0 + 8 * ((i >> 1) & 1), col = 8 * (i >> 2) + 2 * tq;
    *reinterpret_cast<float2*>(&state_out[st_base + static_cast<int64_t>(row) * N + col]) =
        make_float2(st[i], st[i + 1]);
  }
}

template <int N>
int launch(const void* x, const void* dt, const void* a, const void* bmat, const void* cmat,
           const void* init, void* y, void* state_out, int batch, int s_len, int heads,
           int groups, int p_dim, int chunk, Strides xs, Strides ds, int64_t a_sb,
           int64_t a_sh, Strides bs, Strides cs, Strides ys, cudaStream_t stream) {
  const size_t smem = sizeof(Smem<N>) + 1024;   // slack to align the base for the swizzle
  // more than 48 KB of shared memory needs the attribute, set once per
  // device for each instantiation (setting it twice is harmless)
  static unsigned long long configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(configured & bit)) {
    err = cudaFuncSetAttribute(ssd_sm90_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured |= bit;
  }
  const int64_t blocks = static_cast<int64_t>(batch) * heads * (p_dim / kTile);
  if (blocks >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  ssd_sm90_kernel<N><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const __nv_bfloat16*>(bmat),
      static_cast<const __nv_bfloat16*>(cmat), static_cast<const float*>(init),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(state_out), s_len, heads,
      heads / groups, p_dim, chunk, xs, ds, a_sb, a_sh, bs, cs, ys);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// bf16 x (B, S, H, P), B and C (B, S, G, N), y (B, S, H, P), each by its
// (batch, position, head or group) strides in elements (multiples of 8, bases
// 16-byte aligned: what 16-byte copies take), last dim contiguous; dt (B, S,
// H) float32 by its strides; A float32 at b * a_sb + h * a_sh; init
// (optional, may be null) and state_out (B, H, P, N) float32 contiguous.
// P and N of 64 or 128, H % G == 0, chunk a multiple of 64 up to 256, S >= 1.
int ssd_chunk_sm90_launch(const void* x, const void* dt, const void* a, const void* bmat,
                          const void* cmat, const void* init, void* y, void* state_out,
                          int batch, int s_len, int heads, int groups, int n_dim, int p_dim,
                          int chunk, int64_t x_sb, int64_t x_ss, int64_t x_sh, int64_t d_sb,
                          int64_t d_ss, int64_t d_sh, int64_t a_sb, int64_t a_sh,
                          int64_t b_sb, int64_t b_ss, int64_t b_sg, int64_t c_sb,
                          int64_t c_ss, int64_t c_sg, int64_t y_sb, int64_t y_ss,
                          int64_t y_sh, void* stream) {
  const int64_t vec = x_sb | x_ss | x_sh | b_sb | b_ss | b_sg | c_sb | c_ss | c_sg | y_sb |
                      y_ss | y_sh;
  if (batch < 1 || s_len < 1 || heads < 1 || groups < 1 || heads % groups != 0 ||
      (n_dim != 64 && n_dim != 128) || (p_dim != 64 && p_dim != 128) || chunk < kTile ||
      chunk > kMaxChunk || chunk % kTile != 0 || vec % 8 != 0 || !aligned16(x) ||
      !aligned16(bmat) || !aligned16(cmat) || !aligned16(y))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides xs{x_sb, x_ss, x_sh}, ds{d_sb, d_ss, d_sh};
  const Strides bs{b_sb, b_ss, b_sg}, cs{c_sb, c_ss, c_sg}, ys{y_sb, y_ss, y_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_dim == 128)
    return launch<128>(x, dt, a, bmat, cmat, init, y, state_out, batch, s_len, heads, groups,
                       p_dim, chunk, xs, ds, a_sb, a_sh, bs, cs, ys, st);
  return launch<64>(x, dt, a, bmat, cmat, init, y, state_out, batch, s_len, heads, groups,
                    p_dim, chunk, xs, ds, a_sb, a_sh, bs, cs, ys, st);
}

}  // extern "C"
