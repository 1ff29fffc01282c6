// Flash attention forward on Hopper's tensor cores (sm_90a): the bf16
// attention of every dense decoder layer's prefill, one launch per layer.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:
//   flash_attention (flash_attention.py:62, pallas_call at :81)
//     -> flash_fwd_kernel
// for bf16 operands with head dim 64 or 128 whose strides and base
// addresses TMA accepts (kernels/flash_attention.py::route picks it);
// flash_attention.cu's float32-FMA kernel takes every other call.
//
// It computes the TPU kernel's function: s = q . k in float32 from the bf16
// operands, the scale applied after the dot; under causal masking a score
// with q_pos < k_pos (positions from 0) is -2e38, not -inf, so a fully
// masked row gives mean(v); over the key tiles in order the online softmax
// m_new = max(m, max_k s), p = exp(s - m_new), alpha = exp(m - m_new),
// l = l*alpha + sum_k p, acc = acc*alpha + p.v with p rounded to bf16
// before it multiplies v and acc in float32; out = acc / max(l, 1e-30)
// rounded to nearest even into bf16.  Where it rounds otherwise:
//   * log2(e) is folded into the scale and the exponentials are
//     ex2.approx.ftz (one MUFU each): scores are s * scale * log2(e), so
//     the -2e38 mask is applied to that scaled score (exp2(-2e38 - m) is
//     0 as exp(-2e38 - m) is, and a fully masked row still gives mean(v));
//     p below 2^-126 flushes to 0;
//   * a tile with no masked or missing column takes its row max from the
//     raw scores and forms each exponent with one FFMA;
//   * the output is O times one reciprocal of max(l, 1e-30) a row.
// Key columns k >= T are not columns at all: TMA fills their K and V rows
// with zeros and their scores are set to -inf, so they enter neither max
// nor sum.  Query rows q >= S are never written.
//
// What bounds it on an H100: operations.  At the main path's shape
// (qwen3-8b prefill, B=4, S=T=1024, H=32, KVH=8, D=128, causal) the work
// is 2*2*D per kept (query, key) pair, 34.4 GFLOP, ~35 us at the card's
// 989 TFLOP/s bf16 dense tensor-core peak, above the bytes (q, k, v read
// once, out written once: 84 MB, ~25 us at 3.35 TB/s).  So both products
// run as wgmma on the tensor cores, fed by TMA, and the threads' own work
// (softmax, bookkeeping, stores) is kept short and out of the way:
//   * persistent blocks, one an SM, of three warpgroups: two consumers of
//     64 query rows each and a producer whose one thread issues every TMA
//     copy.  Each block walks the work items (b*h, 128-query tile) w =
//     blockIdx.x, + gridDim.x, ..., query tiles longest first;
//   * setmaxnreg gives the producer 24 registers and each consumer thread
//     240 for S and O (64 + 64 floats at D = 128) and P (32), enough to
//     keep every wgmma chain pipelined.  The producer/consumer branch is on
//     a warp-uniform index: ptxas applies setmaxnreg's budgets only to
//     regions it can see are entered uniformly, and with a plain threadIdx
//     test it held the consumers to the launch bound's 168 registers,
//     spilled and serialized every wgmma;
//   * Q (128 x D bf16) has one buffer, reloaded once both consumers have
//     an item's last S (mbarriers q_full / q_empty); K and V tiles of 128
//     keys go through a ring of kStages stages with an mbarrier full/empty
//     pair a stage, over the block's whole sequence of tiles across items,
//     so the next item's first tiles arrive while this one finishes;
//   * Q, K and V are read in place through 5-D tensor maps over the
//     model's (B, S, H, D) / (B, T, KVH, D) tensors: 64 columns, positions,
//     D/64 column halves 128 bytes apart, heads, batch, with byte strides
//     from the caller.  Query head h reads KV head h / (H / KVH), so
//     neither a transpose nor the GQA expansion is materialized.  One box
//     (64 x 128 x D/64) is one tile with 128-byte swizzle: its halves of
//     128 rows of 128 bytes, 16 KB apart;
//   * the two consumers take turns at issuing their products (named
//     barriers), and each turn issues tile j's S with tile j-1's P.V, so
//     one consumer's softmax runs while the other's wgmma keep the tensor
//     cores busy; the softmax is pinned ahead of the wait for P.V (a
//     register fence), since the compiler otherwise sank it below;
//   * S = Q.K^T: D/16 wgmma.m64n128k16 per consumer, both operands
//     K-major in shared memory (128-byte swizzle descriptors, 1 KB between
//     8-row groups, the start advanced 32 bytes a 16-wide step);
//   * the softmax runs on the accumulator fragment in registers: thread
//     (warp w, lane l) holds rows 16w + l/4 and 16w + l/4 + 8, its row max
//     and row sum run in four partial chains a row (two warps an SM
//     sub-partition hide little latency), the max reduces over the 4 lanes
//     of a row with two shuffles every tile, the sum stays per thread until
//     the epilogue; O is rescaled by alpha in the next turn, after its S is
//     issued and before its P.V, and only where a warp's row max moved;
//   * P.V: p goes to bf16 pairs in registers, which are exactly the A
//     fragments of wgmma.m64nDk16 (key block kk is accumulator registers
//     8kk..8kk+7), and V is the shared-memory B operand in its natural
//     (keys, D) layout with the transpose bit set (N-major, 128-byte
//     swizzle: 1 KB between 8-key groups, 16 KB between 64-column halves);
//     O (64 x D float32) stays in registers;
//   * under causal masking key tiles wholly above the diagonal are not
//     loaded, and only the diagonal tile and a ragged last tile are masked;
//   * the epilogue transposes each row's words over its 4 lanes with two
//     shuffle rounds and stores 16 bytes a thread (8 columns of a row),
//     rows >= S skipped: 4-byte stores of the fragment as it lies took
//     longer than a tile's products.
// A wait on an mbarrier that has not completed after 2^36 cycles (~35 s)
// traps, so a fault in the pipeline fails the launch instead of hanging the
// card.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;                 // query rows per block: two consumers of 64
constexpr int kBK = 128;                 // keys per K/V tile
constexpr int kStages = 3;               // K/V ring
constexpr int kThreads = 384;            // two consumer warpgroups + a producer
constexpr int kConsumerThreads = 256;
constexpr uint32_t kBoxBytes = 128 * 128;  // a tile's 64-column half: 128 rows of 128 bytes
constexpr float kMaskValue = -2.0e38f;
constexpr long long kHangCycles = 1ll << 36;

template <int D>
__host__ __device__ constexpr uint32_t tile_bytes() { return (D / 64) * kBoxBytes; }

// Q, then stage s's K and V, then the barriers (Q full and empty,
// full[kStages], empty[kStages]); 1 KB of slack to align the base for
// the swizzle
template <int D>
constexpr size_t smem_bytes() {
  return tile_bytes<D>() * (1 + 2 * kStages) + 8 * (2 + 2 * kStages) + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// wait for the phase of parity `parity` to complete; trap rather than hang
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - start > kHangCycles) __trap();
  }
}

// one tile (a box of the 5-D tensor map at position `pos` of head `head`
// of batch row `b`) into shared memory; TMA completes its bytes on the
// mbarrier
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const CUtensorMap* map,
                                              uint32_t bar, int pos, int head, int b) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(pos), "r"(0), "r"(head),
      "r"(b)
      : "memory");
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
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// wait until at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of accumulator (and A
// fragment) registers across the asynchronous wgmma: issued before, read
// and written until the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// 2^x with one MUFU.EX2; results below 2^-126 flush to 0, against a row
// sum of at least 1 (the row's max contributes 1)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// pin four values: computed before the next volatile asm, not sunk below it
__device__ __forceinline__ void fence_vals(float& a, float& b, float& c, float& d) {
  asm volatile("" : "+f"(a), "+f"(b), "+f"(c), "+f"(d)::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 128, float32) (+)= a (64 x 16, K-major in shared memory) . b (16 x 128: 128
// rows of 16, K-major in shared memory); both bf16
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 128, float32) += a (64 x 16 bf16, in registers) . b (16 x 128 bf16, N-major
// in shared memory: the transpose bit is set)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 64, float32) += a (64 x 16 bf16, in registers) . b (16 x 64 bf16, N-major
// in shared memory: the transpose bit is set)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// O += P.V for one 16-key step: N = D
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4],
                                         uint64_t desc_v) {
  if constexpr (D == 128) {
    wgmma_rs_n128(o, a, desc_v);
  } else {
    wgmma_rs_n64(o, a, desc_v);
  }
}

// S = Q.K^T over one key tile: D/16 steps of 16 along d, both operands
// K-major with 128-byte swizzle (boxes of 64 columns 16 KB apart, 8-row
// groups 1 KB apart, the start 32 bytes further each step)
template <int D>
__device__ __forceinline__ void issue_s(float (&s)[64], uint32_t q_rows, uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    wgmma_ss_n128(s, sw128_desc(q_rows + off, 16, 1024), sw128_desc(k_tile + off, 16, 1024),
                  kk > 0);
  }
}

// O += P.V over one key tile: 8 steps of 16 keys, P from registers, V
// N-major with 128-byte swizzle (8-key groups 1 KB apart, boxes of 64
// columns 16 KB apart)
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&p)[32],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    wgmma_pv<D>(o, a, sw128_desc(v_tile + kk * 2048, kBoxBytes, 1024));
  }
}

// The two consumer warpgroups take turns at issuing their products (named
// barriers 1 and 2, 256 threads each): while one runs its softmax, the
// other's wgmma keep the tensor cores busy.
__device__ __forceinline__ void turn_wait(int cw) {
  asm volatile("bar.sync %0, 256;" ::"r"(1 + cw) : "memory");
}
__device__ __forceinline__ void turn_pass(int cw) {
  asm volatile("bar.arrive %0, 256;" ::"r"(2 - cw) : "memory");
}

// P (bf16) as the A fragments: key step kk is s[8kk..8kk+7]
__device__ __forceinline__ void pack_p(uint32_t (&p)[32], const float (&s)[64]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// Persistent: one block per SM walks the work items (b*h, 128-query tile)
// w = blockIdx.x, blockIdx.x + gridDim.x, ..., query tiles longest first
// (w / BH counts them down from the last).  kTileTest: one 128 x 128 tile,
// no scale, mask or softmax: S = Q.K^T goes to test_s and bf16(S).V to
// test_o, both float32 row-major, so the two products can be held against
// plain ones.
template <int D, bool kTileTest>
__global__ void __launch_bounds__(kThreads, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                  const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ out,
                  int64_t o_sb, int64_t o_ss, int64_t o_sh, int bh_count, int s_len, int t_len,
                  int heads, int group, int causal, float scale_log2, float* __restrict__ test_s,
                  float* __restrict__ test_o) {
  constexpr uint32_t kTile = tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s_q = (smem_u32(smem_raw) + 1023u) & ~1023u;   // swizzle atoms are 1 KB
  const uint32_t bars = s_q + kTile * (1 + 2 * kStages);
  const uint32_t q_full = bars;
  const uint32_t q_empty = bars + 8;
  auto full_bar = [&](int st) { return bars + 8u * (2 + st); };
  auto empty_bar = [&](int st) { return bars + 8u * (2 + kStages + st); };
  auto k_tile = [&](int st) { return s_q + kTile * (1 + 2 * st); };
  auto v_tile = [&](int st) { return s_q + kTile * (2 + 2 * st); };

  const int n_q = (s_len + kBQ - 1) / kBQ;
  const int n_items = n_q * bh_count;
  const int n_kt = (t_len + kBK - 1) / kBK;
  struct Item {
    int b, h, q0, n_k;
  };
  auto item = [&](int w) {
    const int q_tile = n_q - 1 - w / bh_count;
    const int bh = w - (w / bh_count) * bh_count;
    Item it;
    it.b = bh / heads;
    it.h = bh - it.b * heads;
    it.q0 = q_tile * kBQ;
    // causal: key tiles starting past the tile's last query row add nothing
    it.n_k = causal ? min(n_kt, q_tile + 1) : n_kt;
    return it;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumerThreads);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_bar(st), 1);
      mbar_init(empty_bar(st), kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Warpgroup 2 is the producer: one thread issues every copy, and
  // setmaxnreg hands its registers to the consumers.  The branch is on a
  // warp-uniform index (shuffled from lane 0): ptxas applies setmaxnreg's
  // register budgets only to regions entered uniformly, and with a plain
  // threadIdx test it held the consumers to the 384-thread launch bound's
  // 168 registers, spilled and serialized every wgmma.  The K/V ring runs
  // over the block's whole sequence of tiles, across items: global tile g
  // goes to stage g % kStages once both consumers have released tile
  // g - kStages.  Q has one buffer: an item's Q is loaded once both
  // consumers have finished the previous item's last S.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (threadIdx.x == kConsumerThreads) {
      int load_g = 0;
      for (int w = blockIdx.x, n = 0; w < n_items; w += gridDim.x, ++n) {
        const Item it = item(w);
        if (n > 0) mbar_wait(q_empty, (n - 1) & 1);
        mbar_expect_tx(q_full, kTile);
        tma_load_tile(s_q, &q_map, q_full, it.q0, it.h, it.b);
        const int kvh = it.h / group;
        for (int j = 0; j < it.n_k; ++j, ++load_g) {
          const int st = load_g % kStages;
          if (load_g >= kStages) mbar_wait(empty_bar(st), (load_g / kStages - 1) & 1);
          mbar_expect_tx(full_bar(st), 2 * kTile);
          tma_load_tile(k_tile(st), &k_map, full_bar(st), j * kBK, kvh, it.b);
          tma_load_tile(v_tile(st), &v_map, full_bar(st), j * kBK, kvh, it.b);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");

  // two warpgroups of 64 query rows each
  const int cw = wg;
  const int ct = threadIdx.x & 127;
  const int warp = ct >> 5;
  const int lane = ct & 31;
  const int t4 = lane & 3;
  const int r_local = 64 * cw + 16 * warp + (lane >> 2);   // rows r_local and r_local + 8
  const uint32_t q_rows = s_q + 64 * cw * 128;   // this consumer's rows of each Q box

  float o[D / 2];
  float m0, m1, l0, l1;
  float s[64];
  uint32_t p[32];
  int row0 = 0, q0 = 0, n_k = 0;

  // s[i]: row r_local + 8*((i >> 1) & 1), column 8*(i >> 2) + 2*t4 + (i & 1).
  // Exponentiates tile j's scores in place (p = 2^(s*scale_log2 - m)),
  // updates m and l, and returns the rows' alpha.  A tile with a masked
  // or missing column scales the scores first and masks the scaled ones;
  // any other takes the row max of the raw scores (rounding is monotonic,
  // so rn(max(s) * c) is the max of the rn(s * c)) and one FFMA a score.
  auto softmax = [&](int j, float& alpha0, float& alpha1) {
    const int k0 = j * kBK;
    const bool edge = k0 + kBK > t_len || (causal && k0 + kBK - 1 > q0 + 64 * cw);
    float mx0 = -INFINITY, mx1 = -INFINITY;
    if (edge) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int col = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        const int row = row0 + 8 * ((i >> 1) & 1);
        s[i] *= scale_log2;
        if (col >= t_len) {
          s[i] = -INFINITY;            // past T: no column at all
        } else if (causal && row < col) {
          s[i] = kMaskValue;
        }
      }
    }
    // four partial maxima and sums a row (index i >> 2 & 3): chains of 8,
    // not 32, with two warps an SM sub-partition to hide their latency
    float part[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) part[r] = -INFINITY;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      float& mx = part[4 * ((i >> 1) & 1) + ((i >> 2) & 3)];
      mx = fmaxf(mx, s[i]);
    }
    mx0 = fmaxf(fmaxf(part[0], part[1]), fmaxf(part[2], part[3]));
    mx1 = fmaxf(fmaxf(part[4], part[5]), fmaxf(part[6], part[7]));
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float c = edge ? 1.0f : scale_log2;   // the edge tile's scores are scaled
    const float mn0 = fmaxf(m0, mx0 * c);
    const float mn1 = fmaxf(m1, mx1 * c);
    alpha0 = fast_exp2(m0 - mn0);
    alpha1 = fast_exp2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int r = 0; r < 8; ++r) part[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = fast_exp2(fmaf(s[i], c, r ? -mn1 : -mn0));
      part[4 * r + ((i >> 2) & 3)] += s[i];
    }
    // per thread; the 4 lanes of a row add up at the end
    l0 = l0 * alpha0 + ((part[0] + part[1]) + (part[2] + part[3]));
    l1 = l1 * alpha1 + ((part[4] + part[5]) + (part[6] + part[7]));
  };

  // Turns, in each item: tile 0's S; then for each later tile j its S with
  // tile j-1's P.V, whose softmax is done; then the last tile's P.V.
  // Consumer 0 goes first, and each hands the turn over once its products
  // are issued (consumer 1 keeps its very last turn).
  if (cw == 1) turn_pass(cw);
  int g = 0;                               // the block's tiles consumed so far
  for (int w = blockIdx.x, n = 0; w < n_items; w += gridDim.x, ++n) {
    const Item it = item(w);
    q0 = it.q0;
    n_k = it.n_k;
    row0 = q0 + r_local;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    m0 = m1 = kMaskValue;
    l0 = l1 = 0.0f;

    mbar_wait(q_full, n & 1);
    mbar_wait(full_bar(g % kStages), (g / kStages) & 1);
    turn_wait(cw);
    wgmma_fence();
    issue_s<D>(s, q_rows, k_tile(g % kStages));
    wgmma_commit();
    turn_pass(cw);
    wgmma_wait<0>();
    fence_regs(s);
    if (n_k == 1) mbar_arrive(q_empty);   // the item's last S is done: Q may go
    float alpha0 = 1.0f, alpha1 = 1.0f;  // O is still 0: nothing to rescale
    if constexpr (kTileTest) {
#pragma unroll
      for (int i = 0; i < 64; ++i)
        test_s[(r_local + 8 * ((i >> 1) & 1)) * kBK + 8 * (i >> 2) + 2 * t4 + (i & 1)] = s[i];
    } else {
      float unused0, unused1;
      softmax(0, unused0, unused1);
    }
    pack_p(p, s);
    // O is rescaled by the last softmax's alpha in the next turn, once P.V
    // before it is done and before the P.V that needs it is issued, while
    // the turn's S runs: off the path between turns
    auto rescale_o = [&]() {
      if (__any_sync(0xffffffffu, alpha0 != 1.0f || alpha1 != 1.0f)) {   // a max moved
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= ((i >> 1) & 1) ? alpha1 : alpha0;
      }
    };

    for (int j = 1; j < n_k; ++j) {
      const int st = (g + j) % kStages;
      const int prev = (g + j - 1) % kStages;
      mbar_wait(full_bar(st), ((g + j) / kStages) & 1);
      turn_wait(cw);
      wgmma_fence();
      issue_s<D>(s, q_rows, k_tile(st));
      wgmma_commit();
      rescale_o();
      fence_regs(o);
      wgmma_fence();
      issue_pv<D>(o, p, v_tile(prev));
      wgmma_commit();
      turn_pass(cw);
      wgmma_wait<1>();                 // S done; P.V may still run
      fence_regs(s);
      if (j == n_k - 1) mbar_arrive(q_empty);
      softmax(j, alpha0, alpha1);
      // keep the softmax ahead of the wait, so it runs under this P.V and
      // the other consumer's products
      fence_regs(s);
      fence_vals(alpha0, alpha1, l0, l1);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      mbar_arrive(empty_bar(prev));    // K and V of tile j-1 are read
      pack_p(p, s);
    }

    const int last = (g + n_k - 1) % kStages;
    turn_wait(cw);
    rescale_o();
    fence_regs(o);
    wgmma_fence();
    issue_pv<D>(o, p, v_tile(last));
    wgmma_commit();
    if (cw == 0 || w + static_cast<int>(gridDim.x) < n_items) turn_pass(cw);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p);
    mbar_arrive(empty_bar(last));
    g += n_k;

    // o[i]: row r_local + 8*((i >> 1) & 1), column 8*(i >> 2) + 2*t4 + (i & 1)
    if constexpr (kTileTest) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i)
        test_o[(r_local + 8 * ((i >> 1) & 1)) * D + 8 * (i >> 2) + 2 * t4 + (i & 1)] = o[i];
    } else {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      // one division a row, then products: within an ulp of o / max(l, 1e-30)
      const float d0 = 1.0f / fmaxf(l0, 1e-30f);
      const float d1 = 1.0f / fmaxf(l1, 1e-30f);
      __nv_bfloat16* ob = out + it.b * o_sb + it.h * o_sh;
      // a thread holds 2 columns of each 8-column block of its two rows;
      // two butterfly rounds over the row's 4 lanes give each lane one
      // whole block of 4 (lane t4: block 4k + t4), stored as 16 bytes
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half;
        const float d = half ? d1 : d0;
#pragma unroll
        for (int k = 0; k < D / 32; ++k) {
          uint32_t x[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            x[i] = pack_bf16(o[16 * k + 4 * i + 2 * half] * d,
                             o[16 * k + 4 * i + 2 * half + 1] * d);
#pragma unroll
          for (int m = 1; m <= 2; m <<= 1) {
#pragma unroll
            for (int i0 = 0; i0 < 4; ++i0) {
              if (i0 & m) continue;
              const bool hi = (t4 & m) != 0;
              const uint32_t got = __shfl_xor_sync(0xffffffffu, hi ? x[i0] : x[i0 | m], m);
              if (hi) {
                x[i0] = got;
              } else {
                x[i0 | m] = got;
              }
            }
          }
          if (row < s_len)
            *reinterpret_cast<uint4*>(ob + row * o_ss + 8 * (4 * k + t4)) =
                make_uint4(x[0], x[1], x[2], x[3]);
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

#if CUDART_VERSION < 12050
#error "flash_attention_sm90.cu needs CUDA 12.5 or later (cudaGetDriverEntryPointByVersion)"
#endif

// cuTensorMapEncodeTiled is a driver-API function; the library links only
// the runtime, so it is fetched from the driver once, at its CUDA 12.0 ABI
cudaError_t encode_fn(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
    if (err == cudaSuccess && found != cudaDriverEntryPointSuccess)
      err = cudaErrorSymbolNotFound;
    if (err != cudaSuccess) return err;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// A 5-D map over a bf16 tensor of (batch, positions, heads, D) with the
// byte strides of its position, head and batch dims: dims innermost first
// (64 columns, positions, D/64 column halves 128 bytes apart, heads,
// batch), boxes of 64 x 128 x D/64 x 1 x 1 with 128-byte swizzle, zeros
// outside the tensor.  One box is one tile as the wgmma descriptors read
// it: its 64-column halves, each 128 rows of 128 bytes, 16 KB apart.
CUresult make_map(EncodeTiled fn, CUtensorMap* map, const void* ptr, int d, int len, int heads,
                  int batch, const int64_t* strides_bytes) {
  const cuuint64_t dims[5] = {64, static_cast<cuuint64_t>(len), static_cast<cuuint64_t>(d / 64),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[4] = {static_cast<cuuint64_t>(strides_bytes[0]), 128,
                                 static_cast<cuuint64_t>(strides_bytes[1]),
                                 static_cast<cuuint64_t>(strides_bytes[2])};
  const cuuint32_t box[5] = {64, kBK, static_cast<cuuint32_t>(d / 64), 1, 1};
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// q: (B, S, H, D), k and v: (B, T, KVH, D), each as the byte strides of
// its (position, head, batch) dims
struct Operands {
  const void* q;
  const void* k;
  const void* v;
  int b, s_len, t_len, heads, kv_heads, d;
  const int64_t* q_strides;
  const int64_t* k_strides;
  const int64_t* v_strides;
};

template <int D, bool kTileTest>
int launch(const Operands& x, void* out, int64_t o_sb, int64_t o_ss, int64_t o_sh, int causal,
           float scale, float* test_s, float* test_o, cudaStream_t stream) {
  EncodeTiled fn;
  cudaError_t err = encode_fn(&fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap maps[3];
  const CUresult res[3] = {
      make_map(fn, &maps[0], x.q, D, x.s_len, x.heads, x.b, x.q_strides),
      make_map(fn, &maps[1], x.k, D, x.t_len, x.kv_heads, x.b, x.k_strides),
      make_map(fn, &maps[2], x.v, D, x.t_len, x.kv_heads, x.b, x.v_strides)};
  for (CUresult r : res)
    if (r != CUDA_SUCCESS) return -static_cast<int>(r);   // the wrapper names it
  const size_t smem = smem_bytes<D>();
  // more than 48 KB of shared memory needs the attribute, set once per
  // device for each instantiation (setting it twice is harmless)
  static unsigned long long configured = 0;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(configured & bit)) {
    err = cudaFuncSetAttribute(flash_sm90_kernel<D, kTileTest>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured |= bit;
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t items = static_cast<int64_t>(x.b) * x.heads * ((x.s_len + kBQ - 1) / kBQ);
  if (items >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);
  flash_sm90_kernel<D, kTileTest><<<static_cast<int>(items < sms ? items : sms), kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(out), o_sb, o_ss, o_sh,
      x.b * x.heads, x.s_len, x.t_len, x.heads, x.heads / x.kv_heads, causal, scale_log2,
      test_s, test_o);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// bf16 q (B, S, H, D), k and v (B, T, KVH, D) with D of 64 or 128, each
// given by the byte strides of its (batch, position, head) dims (multiples
// of 16, bases 16-byte aligned: what TMA takes); out (B, S, H, D) bf16 by
// its (batch, position, head) strides in elements (multiples of 8, base
// 16-byte aligned); H % KVH == 0, S, T >= 1.
// Returns a cudaError_t, or minus a CUresult when a tensor map is refused.
int flash_attention_sm90_launch(const void* q, const void* k, const void* v, void* out, int b,
                                int s_len, int t_len, int heads, int kv_heads, int d,
                                int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                                int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                                int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
                                int causal, float scale, void* stream) {
  if ((d != 64 && d != 128) || kv_heads < 1 || heads % kv_heads != 0 || s_len < 1 ||
      t_len < 1 || b < 1 || (o_sb | o_ss | o_sh) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);   // out is stored 16 bytes at a time
  const int64_t qs[3] = {q_ss, q_sh, q_sb}, ks[3] = {k_ss, k_sh, k_sb};
  const int64_t vs[3] = {v_ss, v_sh, v_sb};
  const Operands x{q, k, v, b, s_len, t_len, heads, kv_heads, d, qs, ks, vs};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 128)
    return launch<128, false>(x, out, o_sb, o_ss, o_sh, causal, scale, nullptr, nullptr, st);
  return launch<64, false>(x, out, o_sb, o_ss, o_sh, causal, scale, nullptr, nullptr, st);
}

// The two tensor-core products of one tile, for tests: bf16 q, k, v of 128
// rows of D (64 or 128), each by its row stride in bytes (a multiple of 16);
// s_out (128, 128) = q.k^T and o_out (128, D) = bf16(s).v, float32 row-major.
int flash_attention_sm90_tile_launch(const void* q, const void* k, const void* v, float* s_out,
                                     float* o_out, int d, int64_t q_rs, int64_t k_rs,
                                     int64_t v_rs, void* stream) {
  if (d != 64 && d != 128) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t qs[3] = {q_rs, q_rs * kBK, q_rs * kBK}, ks[3] = {k_rs, k_rs * kBK, k_rs * kBK};
  const int64_t vs[3] = {v_rs, v_rs * kBK, v_rs * kBK};
  const Operands x{q, k, v, 1, kBQ, kBK, 1, 1, d, qs, ks, vs};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 128) return launch<128, true>(x, nullptr, 0, 0, 0, 0, 1.0f, s_out, o_out, st);
  return launch<64, true>(x, nullptr, 0, 0, 0, 0, 1.0f, s_out, o_out, st);
}

}  // extern "C"
