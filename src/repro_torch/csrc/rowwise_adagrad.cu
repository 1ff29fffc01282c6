// Row-wise AdaGrad table update for Hopper (sm_90a): the sparse DLRM
// step's update of its embedding tables and their accumulator, in place,
// as one sorted, deduplicated pass (kernels/rowwise_adagrad.py launches
// it; models/dlrm.py's sparse_table_update_ and
// sparse_table_update_sharded_ reach it through kernels/ops.py).
//
// Replaces no TPU kernel.  The reference updates its tables with XLA
// scatter-adds (src/repro/models/dlrm.py, sparse_table_update and
// sparse_table_update_sharded).  Their plain PyTorch form
// (kernels/ref.py, rowwise_adagrad_) expands d(pooled) into a per-slot
// (N, E) gradient and scatters it with index_add_.  At dlrm-paper's batch
// of 4096 (N = 5,505,024 slots: 42 tables, 32 slots a bag) that is three
// 2.8 GB temporaries and ~20 GB of traffic a step, and 83% of the slots
// are pads of weight 0 added into row 0 of each table by contended
// atomics.  On an H100 it took 15.8 ms of a ~43 ms step, all of it on the
// step's critical path, which is why this kernel was added.
//
// What it computes, for each occurrence o (slot (m, l) of the (M, L) keys:
// bag m, weight w_o) whose key r is a row of the table:
//   acc[r] += sum_o mean_e((w_o * g[m, e])^2)       every occurrence counted
//   table[r] -= lr / sqrt(acc[r] + eps) * w_o * g[m]   for each o in turn
// with acc[r] already holding all of the call's occurrences.  That is the
// plain form's maths and its rounding of each row: float32 throughout,
// each product and sum rounded on its own (__fmul_rn, __fadd_rn: nvcc
// would contract a*b+c into one FMA), IEEE division and square root, and
// each occurrence's -lr/sqrt(acc+eps) * (w_o * g) added to the row in
// turn, in slot order, as the plain form's scatter-add adds it.  Only the
// order of the accumulator's sum differs.  Adding a row's summed gradient
// once would round less, but in warmup a row's change is ~1e-3 of its
// value, so the plain form's adds each round off ~1e-5 of the change, and
// a Zipf-hot row (thousands of occurrences, in most of the batch's
// samples) moved otherwise drifts from it enough to show after 3 steps of
// dlrm-paper.train.b4096: summed adds put the worst table's change 1.1e-3
// to 2.6e-3 from the benchmark's plain reference, ~3x the plain form's gap
// there; added in turn, the gap equalled the plain form's to three digits
// on five of six seeds.
//
// What bounds it on an H100: bytes.  The least traffic is the keys,
// weights and d(pooled) read once and each distinct row and its
// accumulator entry read and written once: ~0.28 GB at the main path
// (~142k rows a batch of 4096), ~84 us at 3.35 TB/s.  The sort of the N
// keys between the two launches (torch.sort, a radix sort of 4-byte keys
// and 8-byte slot indices) is the largest part of the work, and the
// longest run (a row named ~16k times a batch) the longest chain of adds.
//
// Design:
//  * Keys (rowwise_adagrad_keys_kernel, one warp a bag).  A slot whose key
//    is not a row of the table (negative: another rank's row) gets kSkip,
//    which sorts after every row.  So does a slot of weight exactly 0
//    whose bag's gradient row is finite: it adds 0 to its row and to its
//    accumulator.  A bag whose gradient holds a NaN or an inf keeps its
//    zero-weight slots, so 0 * NaN reaches exactly the rows and
//    accumulator entries the plain form reaches.
//  * Sort (the wrapper, stable): the keys with their slot indices, so the
//    occurrences of a row lie together, in slot order.
//  * Rows (rowwise_adagrad_rows_kernel).  The sorted occurrences are cut
//    into chunks of 32, one warp a chunk, so the squares are summed by
//    occurrences, not by rows: a Zipf-hot row named thousands of times is
//    summed by many warps.  Lane j holds occurrence j's key, gradient row
//    offset and weight, handed out by shuffles (and writes the offset and
//    weight out in sorted order for the carries); lane j holds columns
//    [4j, 4j+4) of each 128-column stripe as a float4, and a group of G
//    occurrences' gradient rows is loaded before the group's squares are
//    summed.  A run of equal keys that begins and ends in the chunk is
//    applied by that warp: its accumulator entry once, then its row, read
//    once, gets each occurrence in turn (their gradient rows read again,
//    from cache), written once.  A run that crosses a chunk edge leaves
//    the sum of its squares there in part_sq: the chunk's first run, begun
//    in an earlier chunk, in slot 2c, and its last run, going on into the
//    next chunk, in slot 2c + 1.
//  * Carries (rowwise_adagrad_carry_kernel, one block a chunk).  The chunk
//    where a crossing run begins finds the chunk where it ends (a
//    warp-wide probe of 32 chunk edges at a time) and the run's first and
//    last positions, adds the later chunks' squares to its own, writes
//    the accumulator entry, and walks the run's occurrences in turn, 64
//    staged in shared memory at a time, each thread adding them to its
//    own columns of the row with up to 64 gradient loads in flight: a run
//    of 16k occurrences is a chain of 16k adds a column.
//  * No float atomics: each row and accumulator entry is written by one
//    warp or block, and every sum runs in a fixed order, so two runs give
//    the same bits.
//  * No host synchronisation: lr is read through its pointer; every grid
//    is sized from N; the warps past the live keys see kSkip and stop.
//  * Tally: the live occurrences and the distinct rows updated are added
//    into two device counters (one atomic a block), for the host to read
//    after a run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kSkip = 0x7fffffff;   // sorts after every row key
constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 32;              // occurrences a warp: one a lane
constexpr int kWarps = 4;               // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kStripe = 128;            // columns: 32 lanes x float4
constexpr int kBatch = 64;              // sorted occurrences a carry block stages at a time

// the same sum in every lane: each butterfly step adds a + b in one lane
// and b + a in its partner
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// this lane's columns' share of one occurrence's sum_e (w * g)^2
template <int S>
__device__ __forceinline__ float squares(const float4 (&g)[S], float w, int e, int lane) {
  float sq = 0.0f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (s * kStripe + lane * 4 < e) {
      const float x0 = __fmul_rn(g[s].x, w), x1 = __fmul_rn(g[s].y, w);
      const float x2 = __fmul_rn(g[s].z, w), x3 = __fmul_rn(g[s].w, w);
      sq = __fadd_rn(sq, __fmul_rn(x0, x0));
      sq = __fadd_rn(sq, __fmul_rn(x1, x1));
      sq = __fadd_rn(sq, __fmul_rn(x2, x2));
      sq = __fadd_rn(sq, __fmul_rn(x3, x3));
    }
  }
  return sq;
}

// one occurrence added to a row's column: t + (-lr/sqrt(acc+eps)) * (w * g),
// each product and sum rounded, as the plain form's scatter-add adds it
__device__ __forceinline__ float add_scaled(float t, float neg, float g, float w) {
  return __fadd_rn(t, __fmul_rn(neg, __fmul_rn(g, w)));
}

__device__ __forceinline__ float adagrad_acc(float acc, float sq, int e) {
  return __fadd_rn(acc, __fdiv_rn(sq, static_cast<float>(e)));
}

__device__ __forceinline__ float adagrad_neg(float lr, float a, float eps) {
  return -__fdiv_rn(lr, __fsqrt_rn(__fadd_rn(a, eps)));
}

// Occurrences [first, last] of a warp's chunk (lane q holds occurrence
// q's gradient row offset and weight) added to the row's columns t in
// turn.  G occurrences' gradient rows are loaded before their adds.
template <int S, int G>
__device__ __forceinline__ void walk_add(float4 (&t)[S], int first, int last, int64_t g_off,
                                         float wv, const float* __restrict__ grad, float neg,
                                         int e, int lane) {
  for (int q0 = first; q0 <= last; q0 += G) {
    float4 d[G][S];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int q = q0 + j;
      const int64_t off = __shfl_sync(kFull, g_off, q & 31);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int col = s * kStripe + lane * 4;
        d[j][s] = (q <= last && col < e)
                      ? *reinterpret_cast<const float4*>(grad + off + col)
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int q = q0 + j;
      const float w = __shfl_sync(kFull, wv, q & 31);
      if (q <= last) {                 // the same in every lane
#pragma unroll
        for (int s = 0; s < S; ++s) {
          if (s * kStripe + lane * 4 < e) {
            t[s].x = add_scaled(t[s].x, neg, d[j][s].x, w);
            t[s].y = add_scaled(t[s].y, neg, d[j][s].y, w);
            t[s].z = add_scaled(t[s].z, neg, d[j][s].z, w);
            t[s].w = add_scaled(t[s].w, neg, d[j][s].w, w);
          }
        }
      }
    }
  }
}

// One warp a bag: the bag's gradient row checked for NaN and inf, then
// each slot's key kept, or marked kSkip (module note).
template <int S>
__global__ void __launch_bounds__(kThreads)
rowwise_adagrad_keys_kernel(const int32_t* __restrict__ keys, const float* __restrict__ w,
                            const float* __restrict__ grad, int32_t* __restrict__ marked,
                            int64_t m, int l, int e, int64_t rows) {
  const int lane = threadIdx.x & 31;
  const int64_t bag = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (bag >= m) return;                // the whole warp
  const float* g = grad + bag * e;
  bool finite = true;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int col = s * kStripe + lane * 4;
    if (col < e) {
      const float4 v = *reinterpret_cast<const float4*>(g + col);
      finite = finite && isfinite(v.x) && isfinite(v.y) && isfinite(v.z) && isfinite(v.w);
    }
  }
  finite = __all_sync(kFull, finite);
  for (int j = lane; j < l; j += 32) {
    const int64_t i = bag * l + j;
    const int32_t k = keys[i];
    const bool skip = k < 0 || k >= rows || (w[i] == 0.0f && finite);
    marked[i] = skip ? kSkip : k;
  }
}

// One warp a chunk of 32 sorted occurrences (module note, "Rows").  G
// occurrences' gradient rows (G * S float4s, at most 8) are loaded before
// their squares are summed.
template <int S, int G>
__global__ void __launch_bounds__(kThreads)
rowwise_adagrad_rows_kernel(const int32_t* __restrict__ skeys, const int64_t* __restrict__ slots,
                            const float* __restrict__ w, const float* __restrict__ grad,
                            float* __restrict__ table, float* __restrict__ acc,
                            const float* __restrict__ lr_ptr, float eps,
                            int32_t* __restrict__ sbag, float* __restrict__ sw,
                            float* __restrict__ part_sq, unsigned long long* __restrict__ tally,
                            int64_t n, int l, int e) {
  __shared__ unsigned s_starts[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t chunk = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  const int64_t base = chunk * kChunk;
  const int64_t i = base + lane;
  const int32_t key = i < n ? skeys[i] : kSkip;
  // the keys are sorted, so the live ones are a prefix of the chunk
  const int n_live = __popc(__ballot_sync(kFull, key != kSkip));
  unsigned starts = 0;                 // lanes whose occurrence begins a run
  if (n_live > 0) {
    const int32_t prev = base > 0 ? skeys[base - 1] : -1;
    const int32_t next = base + kChunk < n ? skeys[base + kChunk] : kSkip;
    int32_t before = __shfl_up_sync(kFull, key, 1);
    if (lane == 0) before = prev;
    starts = __ballot_sync(kFull, key != kSkip && key != before);
    const int64_t slot = key != kSkip ? slots[i] : 0;
    const int64_t g_off = (slot / l) * e;
    const float wv = key != kSkip ? w[slot] : 0.0f;
    if (key != kSkip) {                // for the carry kernel's walks
      sbag[i] = static_cast<int32_t>(slot / l);
      sw[i] = wv;
    }
    bool head = !(starts & 1u);        // the first run began in an earlier chunk
    unsigned ends = 0;                 // where a run that began here ends here
    float run_sq = 0.0f;               // lane o: the squares of the run ending at o
    float sq = 0.0f;                   // this lane's share of the current run's
    for (int g0 = 0; g0 < n_live; g0 += G) {
      float4 d[G][S];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int o = g0 + j;
        const int64_t off = __shfl_sync(kFull, g_off, o & 31);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int col = s * kStripe + lane * 4;
          d[j][s] = (o < n_live && col < e)
                        ? *reinterpret_cast<const float4*>(grad + off + col)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int o = g0 + j;
        if (o < n_live) {              // the same in every lane
          sq = __fadd_rn(sq, squares<S>(d[j], __shfl_sync(kFull, wv, o), e, lane));
          const int32_t k = __shfl_sync(kFull, key, o);
          if (o == n_live - 1 || ((starts >> (o + 1)) & 1u)) {   // the run ends here
            const bool cont = o == kChunk - 1 && next == k;       // ... or goes on
            const float run = warp_sum(sq);
            if (head || cont) {
              if (lane == 0) part_sq[2 * chunk + (head ? 0 : 1)] = run;
            } else {
              ends |= 1u << o;
              if (lane == o) run_sq = run;
            }
            sq = 0.0f;
            head = false;
          }
        }
      }
    }
    // each run that began and ended here: its accumulator entry once,
    // then its row, read once, gets each occurrence in turn (their
    // gradient rows read again, from cache), written once
    const float lr = *lr_ptr;
    while (ends) {
      const int o = __ffs(ends) - 1;
      ends &= ends - 1;
      const int first = 31 - __clz(starts & (0xffffffffu >> (31 - o)));
      const int32_t k = __shfl_sync(kFull, key, o);
      const float a = adagrad_acc(acc[k], __shfl_sync(kFull, run_sq, o), e);
      __syncwarp();                    // every lane has read acc[k] before lane 0 writes it
      if (lane == 0) acc[k] = a;
      float* row = table + static_cast<int64_t>(k) * e;
      float4 t[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int col = s * kStripe + lane * 4;
        if (col < e) t[s] = *reinterpret_cast<const float4*>(row + col);
      }
      walk_add<S, G>(t, first, o, g_off, wv, grad, adagrad_neg(lr, a, eps), e, lane);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int col = s * kStripe + lane * 4;
        if (col < e) *reinterpret_cast<float4*>(row + col) = t[s];
      }
    }
    // the chunk where the live keys end: their count
    if (lane == 0 && (n_live < kChunk || next == kSkip)) {
      atomicAdd(&tally[0], static_cast<unsigned long long>(base + n_live));
    }
  }
  if (lane == 0) s_starts[warp] = __popc(starts);
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned runs = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) runs += s_starts[k];
    if (runs) atomicAdd(&tally[1], static_cast<unsigned long long>(runs));
  }
}

// One block a chunk: where a run begins in the chunk and goes on into the
// next, the block applies it.  Its squares are its own part and the parts
// the later chunks left (their first runs), added in a fixed order; the
// accumulator entry is written once; then the run's sorted occurrences
// are walked in turn, kBatch staged at a time, thread c adding each to
// columns c, c + 128, ... (C of them) of the row, G occurrences'
// gradients loaded before their adds.
template <int C, int G>
__global__ void __launch_bounds__(kThreads)
rowwise_adagrad_carry_kernel(const int32_t* __restrict__ skeys, const int32_t* __restrict__ sbag,
                             const float* __restrict__ sw, const float* __restrict__ grad,
                             float* __restrict__ table, float* __restrict__ acc,
                             const float* __restrict__ lr_ptr, float eps,
                             const float* __restrict__ part_sq, int64_t n, int e) {
  __shared__ int32_t s_bag[kBatch];
  __shared__ float s_w[kBatch];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int64_t chunk = blockIdx.x;
  const int64_t base = chunk * kChunk;
  const int64_t last = base + kChunk - 1;
  if (last + 1 >= n) return;           // the whole block
  const int32_t k = skeys[last];
  if (k == kSkip || skeys[last + 1] != k) return;       // no run goes on
  if (chunk > 0 && skeys[base - 1] == k) return;        // begun earlier: not ours
  // the chunk where the run ends: the first c > chunk whose successor
  // does not start with k, probed 32 chunk edges at a time (each warp
  // alike)
  int64_t end = chunk + 1;
  for (;;) {
    const int64_t after = (end + lane + 1) * kChunk;
    const bool cont = after < n && skeys[after] == k;
    const unsigned stop = __ballot_sync(kFull, !cont);
    if (stop) {
      end += __ffs(stop) - 1;
      break;
    }
    end += 32;
  }
  // the run's first and last sorted positions: a suffix of this chunk, a
  // prefix of the last
  const unsigned mine = __ballot_sync(kFull, skeys[base + lane] == k);
  const int64_t p0 = base + __ffs(mine) - 1;
  const int64_t at_end = end * kChunk + lane;
  const unsigned tail = __ballot_sync(kFull, at_end < n && skeys[at_end] == k);
  const int64_t p1 = end * kChunk + 31 - __clz(tail);
  // squares: lane j adds the parts of chunks chunk + 1 + j, + 33, ... in
  // turn, then the lanes' sums are added in a fixed tree
  float later = 0.0f;
  for (int64_t c = chunk + 1 + lane; c <= end; c += 32) later = __fadd_rn(later, part_sq[2 * c]);
  const float a = adagrad_acc(acc[k], __fadd_rn(part_sq[2 * chunk + 1], warp_sum(later)), e);
  __syncthreads();                     // every thread has read acc[k] before it is written
  if (tid == 0) acc[k] = a;
  const float neg = adagrad_neg(*lr_ptr, a, eps);
  float* row = table + static_cast<int64_t>(k) * e;
  float t[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = tid + c * kThreads;
    t[c] = col < e ? row[col] : 0.0f;
  }
  for (int64_t b0 = p0; b0 <= p1; b0 += kBatch) {
    const int cnt = static_cast<int>(p1 - b0 < kBatch - 1 ? p1 - b0 + 1 : kBatch);
    if (tid < cnt) {
      s_bag[tid] = sbag[b0 + tid];
      s_w[tid] = sw[b0 + tid];
    }
    __syncthreads();
    for (int q0 = 0; q0 < cnt; q0 += G) {
      float d[G][C];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int q = q0 + j;
        const int64_t off = q < cnt ? static_cast<int64_t>(s_bag[q]) * e : 0;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int col = tid + c * kThreads;
          d[j][c] = (q < cnt && col < e) ? grad[off + col] : 0.0f;
        }
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int q = q0 + j;
        if (q < cnt) {
          const float wq = s_w[q];
#pragma unroll
          for (int c = 0; c < C; ++c) t[c] = add_scaled(t[c], neg, d[j][c], wq);
        }
      }
    }
    __syncthreads();                   // before the next batch is staged
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = tid + c * kThreads;
    if (col < e) row[col] = t[c];
  }
}

template <int S>
void launch_keys(const int32_t* keys, const float* w, const float* grad, int32_t* marked,
                 int64_t m, int l, int e, int64_t rows, cudaStream_t stream) {
  const int64_t blocks = (m + kWarps - 1) / kWarps;
  rowwise_adagrad_keys_kernel<S><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      keys, w, grad, marked, m, l, e, rows);
}

template <int S, int G>
int launch_rows(const int32_t* skeys, const int64_t* slots, const float* w, const float* grad,
                float* table, float* acc, const float* lr, float eps, int32_t* sbag, float* sw,
                float* part_sq, unsigned long long* tally, int64_t n, int l, int e,
                cudaStream_t stream) {
  const int64_t chunks = (n + kChunk - 1) / kChunk;
  const unsigned blocks = static_cast<unsigned>((chunks + kWarps - 1) / kWarps);
  rowwise_adagrad_rows_kernel<S, G><<<blocks, kThreads, 0, stream>>>(
      skeys, slots, w, grad, table, acc, lr, eps, sbag, sw, part_sq, tally, n, l, e);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // C columns a thread, 64 / C gradients in flight
  constexpr int C = S;
  constexpr int GC = C == 1 ? 64 : (C == 2 ? 32 : 16);
  rowwise_adagrad_carry_kernel<C, GC><<<static_cast<unsigned>(chunks), kThreads, 0, stream>>>(
      skeys, sbag, sw, grad, table, acc, lr, eps, part_sq, n, e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// keys, w: (m, l) int32 and float32; grad: (m, e) float32; marked: (m * l)
// int32 out.  e a multiple of 4 up to 512, grad 16-byte aligned.
extern "C" int rowwise_adagrad_keys_launch(const void* keys, const void* w, const void* grad,
                                           void* marked, int64_t m, int l, int e, int64_t rows,
                                           void* stream) {
  if (m <= 0 || l <= 0) return 0;
  const auto* k = static_cast<const int32_t*>(keys);
  const auto* wp = static_cast<const float*>(w);
  const auto* g = static_cast<const float*>(grad);
  auto* out = static_cast<int32_t*>(marked);
  auto st = static_cast<cudaStream_t>(stream);
  switch ((e + kStripe - 1) / kStripe) {
    case 1: launch_keys<1>(k, wp, g, out, m, l, e, rows, st); break;
    case 2: launch_keys<2>(k, wp, g, out, m, l, e, rows, st); break;
    case 3: launch_keys<3>(k, wp, g, out, m, l, e, rows, st); break;
    case 4: launch_keys<4>(k, wp, g, out, m, l, e, rows, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// skeys, slots: the n sorted keys and their slot indices; w (n,) and grad
// (n / l, e) as above; table (rows, e) and acc (rows,) updated in place;
// lr a float32 on the device; sbag (n,) int32, sw (n,) float32 and
// part_sq (2 * ceil(n / 32),) float32 scratch; tally two uint64 counters
// added to.
extern "C" int rowwise_adagrad_rows_launch(const void* skeys, const void* slots, const void* w,
                                           const void* grad, void* table, void* acc,
                                           const void* lr, float eps, void* sbag, void* sw,
                                           void* part_sq, void* tally, int64_t n, int l, int e,
                                           void* stream) {
  if (n <= 0) return 0;
  const auto* sk = static_cast<const int32_t*>(skeys);
  const auto* sl = static_cast<const int64_t*>(slots);
  const auto* wp = static_cast<const float*>(w);
  const auto* g = static_cast<const float*>(grad);
  auto* t = static_cast<float*>(table);
  auto* a = static_cast<float*>(acc);
  const auto* lp = static_cast<const float*>(lr);
  auto* sb = static_cast<int32_t*>(sbag);
  auto* sv = static_cast<float*>(sw);
  auto* ps = static_cast<float*>(part_sq);
  auto* ty = static_cast<unsigned long long*>(tally);
  auto st = static_cast<cudaStream_t>(stream);
  switch ((e + kStripe - 1) / kStripe) {
    case 1: return launch_rows<1, 8>(sk, sl, wp, g, t, a, lp, eps, sb, sv, ps, ty, n, l, e, st);
    case 2: return launch_rows<2, 4>(sk, sl, wp, g, t, a, lp, eps, sb, sv, ps, ty, n, l, e, st);
    case 3: return launch_rows<3, 2>(sk, sl, wp, g, t, a, lp, eps, sb, sv, ps, ty, n, l, e, st);
    case 4: return launch_rows<4, 2>(sk, sl, wp, g, t, a, lp, eps, sb, sv, ps, ty, n, l, e, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
