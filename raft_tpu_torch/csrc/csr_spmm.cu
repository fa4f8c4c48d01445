// Deterministic CSR x dense product: out[r][c] = sum over the slots s of
// row r, in slot order, of data[s] * x[indices[s]][c].
//
// Replaces no TPU kernel.  raft_tpu sums these rows with XLA's segment_sum
// (raft_tpu/sparse/linalg.py:31,134, op.py:47, distance.py:94-96), whose
// CPU and TPU lowerings add each segment in slot order.  On the card the
// port needs the same sums run after run: index_add_ / scatter_add_ add by
// atomics in an order that changes between runs (two Lanczos runs with one
// seed would differ), and ops.matrix.segment_sum's one-hot product per
// block of rows does not scale to a million segments.
//
// Arithmetic: each term rounds once as a product (__fmul_rn) and is then
// added to the running sum (__fadd_rn), never fused into an fmaf: raft_tpu
// forms contrib = data * x and then sums it.  The sum starts at +0.0, so a
// row with no slots writes +0.0.  kernels/csr_spmm.py's plain version adds
// the same terms in the same order over a [rows, max degree] view, so the
// two agree bitwise.
//
// What bounds it on the H100: the bytes.  Each slot reads its index, its
// value and one gathered x row segment (8 + 4 cols bytes a slot), against
// one multiply and one add a column, so a 30M-slot SpMV needs ~0.1 ms at
// 3.35 TB/s; the x gathers are random, and each 4-byte read moves a 32-byte
// L2 sector.  The order of each row's sum is fixed, but a dependent add
// takes ~4 cycles, so even R-MAT's 64,526-slot hub sums in ~0.15 ms: what
// must not happen is a memory latency paid on every few slots of a row (one
// warp a row, 32 slots a round, nothing of the next round in flight: the
// hub's 2,017 rounds cost 1.98 ms).  The design follows CSR-Adaptive
// (Greathouse and Daga, SC'14) and keeps the order:
//  - One column (SpMV, csr_spmm_kernel<0>, blocks of 128 threads: with 256,
//    or with windows of 2,048 slots, the kNN SpMV took 1-8 % longer).  The
//    slots are cut into windows of kChunk; block b takes the rows whose
//    first slot lies in window b, so each block has about kChunk slots
//    however the degrees fall (csr_plan_kernel writes each window's rows
//    from indptr on the card, one thread a row: no host read; windows of a
//    fixed count of rows put R-MAT's low-numbered hubs into one block, summed
//    one after another).  The rows' slots stream through in rounds of
//    kChunk: every thread forms kPer products of a round in parallel into
//    shared memory (coalesced loads of indices and values, then the x
//    gathers, two rounds ahead in registers), then each thread adds, in slot
//    order, its own row's products of the round to its running sum.  A row
//    of more than kChunk slots (a hub; always its window's last row) gets a
//    block of its own: csr_plan_kernel lists such rows, and blocks 0, 1, ...
//    each take one before their window, so hubs start in the first wave.
//    The hub's thread adds kChunk products a round at the add's latency
//    while its block streams the next rounds.
//  - More columns, rows of at most kLongCols slots (csr_spmm_kernel<1>):
//    one warp a (row, 32 columns), one lane a column: each batch of 32 slots
//    loads its indices and values once (one a lane, the next batch's in
//    flight), gathers the 32 x rows' 128-byte segments coalesced, and each
//    lane folds its column in slot order.  A row is read once for every 32
//    columns, not once a column.
//  - More columns, longer rows (csr_ring_kernel; k-means' centroid sums:
//    ~1,000 rows a key, 128 columns): one block a (row, 128 columns)
//    streams the x rows through a ring of kStages stages of kRing slots by
//    cp.async (16-byte copies where rows allow), the copies kStages - 1
//    rounds ahead of the fold, and one thread a column folds each stage in
//    slot order.  These blocks run first, in a launch of their own.
// The order in which blocks take rows changes nothing in any row's sum, so
// csr_plan_kernel's atomic appends leave the result deterministic.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_gemm.cuh"

namespace {

constexpr int kThreads = 256;                 // a block of more columns, or of the plan
constexpr int kWinThreads = 128;              // a block of one column: rows a group
constexpr int kChunk = 1024;                  // slots a window and a round (one column)
constexpr int kPer = kChunk / kWinThreads;    // products a thread forms a round
constexpr int kLongCols = 256;                // longest row of the warp kernel (cols > 1)
constexpr int kRing = 32;                     // slots a ring stage (cols > 1)
constexpr int kStages = 4;                    // ring stages
constexpr int kColTile = 128;                 // columns a ring block
constexpr unsigned kFull = 0xffffffffu;

// Bytes of a ring block's dynamic shared memory: x rows, then indices and
// values, a stage each.
constexpr size_t kRingSmem =
    (size_t)kStages * kRing * (kColTile * sizeof(float) + sizeof(int) + sizeof(float));

// The plan of a launch, built on the card by csr_plan_kernel: with windows
// (one column) each window's rows, span[w] = (first row, end of its rows
// but a long last row); the long rows, those of more than 16 kChunk slots
// (`huge`, taken first) and the others; and their counts (count[0] huge,
// count[1] long; zeroed before the plan).
struct Plan {
  int2* span;    // [n_windows + 1]
  int* huge;     // [n_windows]
  int* longs;    // [n_windows | n_rows]
  int* count;    // [2]
};

constexpr int kHugeSlots = 16 * kChunk;

// One thread a row r of [0, n_rows], plus the sentinel r = n_rows.  With
// windows (n_windows > 0) row r is the first row of windows w_lo .. w_hi
// (those whose first slot w kChunk lies in (indptr[r - 1], indptr[r]]; the
// sentinel: every later window), so it writes their span's first row and
// the previous window's end: r, or r - 1 when row r - 1 is long (it is
// then its window's last row).  Rows of more than `long_slots` slots are
// appended to the long lists (in no set order: the order in which blocks
// take rows changes no sum).
__global__ void __launch_bounds__(kThreads)
csr_plan_kernel(const int* __restrict__ indptr, int n_rows, int n_windows, int long_slots,
                Plan plan) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r > n_rows) return;
  const int first = indptr[r];
  if (n_windows > 0) {
    const int prev = r == 0 ? 0 : indptr[r - 1];
    const int w_lo = r == 0 ? 0 : prev / kChunk + 1;
    const int w_hi = r == n_rows || first / kChunk > n_windows ? n_windows : first / kChunk;
    for (int w = w_lo; w <= w_hi; ++w) {
      plan.span[w].x = r;
      if (w > 0) plan.span[w - 1].y = w == w_lo && r > 0 && first - prev > kChunk ? r - 1 : r;
    }
  }
  if (r < n_rows) {
    const int len = indptr[r + 1] - first;
    if (n_windows > 0 && len > kHugeSlots) plan.huge[atomicAdd(plan.count, 1)] = r;
    else if (len > long_slots) plan.longs[atomicAdd(plan.count + 1, 1)] = r;
  }
}

// A round's indices and values, kPer a thread (index -1 past the rows).
struct Slots {
  int ix[kPer];
  float dv[kPer];
};

// One column: rows [g0, g1) (at most kWinThreads of them), thread t summing
// row g0 + t, their slots streamed in rounds of kChunk through buf.
__device__ __forceinline__ void spmv_rows(const int* __restrict__ indptr,
                                          const int* __restrict__ indices,
                                          const float* __restrict__ data,
                                          const float* __restrict__ x, int g0, int g1,
                                          float (*buf)[kChunk], float* __restrict__ out) {
  const int tid = threadIdx.x;
  const int r = g0 + tid;
  const int ws = indptr[g0];
  const int we = indptr[g1];
  int rs = 0, re = 0;
  if (r < g1) {
    rs = indptr[r];
    re = indptr[r + 1];
  }
  const int rounds = (we - ws + kChunk - 1) / kChunk;
  auto load = [&](int t, Slots& sl) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int s = ws + t * kChunk + j * kWinThreads + tid;
      const bool ok = s < we;
      sl.ix[j] = ok ? __ldg(indices + s) : -1;
      sl.dv[j] = ok ? __ldg(data + s) : 0.0f;
    }
  };
  auto gather = [&](const Slots& sl, float (&gx)[kPer]) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) gx[j] = sl.ix[j] >= 0 ? __ldg(x + sl.ix[j]) : 0.0f;
  };
  auto store = [&](int t, const Slots& sl, const float (&gx)[kPer]) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) buf[t & 1][j * kWinThreads + tid] = __fmul_rn(sl.dv[j], gx[j]);
  };
  float acc = 0.0f;
  auto add4 = [&](const float4& v) {
    acc = __fadd_rn(acc, v.x);
    acc = __fadd_rn(acc, v.y);
    acc = __fadd_rn(acc, v.z);
    acc = __fadd_rn(acc, v.w);
  };
  // this row's products of round t, in slot order; a long run is read four
  // at a time, sixteen ahead of the adds, so that a hub's sum runs at the
  // add's latency
  auto fold = [&](int t) {
    const int c0 = ws + t * kChunk;
    const float* b = buf[t & 1];
    int s = max(rs, c0) - c0;
    const int hi = min(re, c0 + kChunk) - c0;
    if (hi - s >= 48) {
      for (; s & 3; ++s) acc = __fadd_rn(acc, b[s]);   // to a 16-byte boundary
      const float4* b4 = reinterpret_cast<const float4*>(b);
      float4 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = b4[s / 4 + j];
      for (s += 16; s + 16 <= hi; s += 16) {
        float4 nv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) nv[j] = b4[s / 4 + j];
#pragma unroll
        for (int j = 0; j < 4; ++j) add4(v[j]);
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = nv[j];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) add4(v[j]);
    }
    for (; s < hi; ++s) acc = __fadd_rn(acc, b[s]);
  };
  // round t: round t is in buf[t & 1] and round t + 1's slots in `next`;
  // gather round t + 1, load round t + 2's slots into `free`, sum round t,
  // then store round t + 1's products
  Slots sa, sb;
  float gx[kPer];
  auto step = [&](int t, Slots& next, Slots& free) {
    if (t + 1 < rounds) gather(next, gx);
    if (t + 2 < rounds) load(t + 2, free);
    fold(t);
    if (t + 1 < rounds) store(t + 1, next, gx);
    __syncthreads();
  };
  if (rounds > 0) {
    load(0, sa);
    if (rounds > 1) load(1, sb);
    gather(sa, gx);
    store(0, sa, gx);
    __syncthreads();
  }
  for (int t = 0; t < rounds; t += 2) {
    step(t, sb, sa);
    if (t + 1 < rounds) step(t + 1, sa, sb);
  }
  if (r < g1) out[r] = acc;
}

// kMode 0, one column (kWinThreads threads): block b sums a long row first
// (the huge ones, then the others, one a block while they last), then the
// rows of window b but a long last row, kWinThreads at a time.
// kMode 1, more columns: a warp a (row, 32 columns) of the rows of at most
// kLongCols slots (the longer ones: csr_ring_kernel).
template <int kMode>
__global__ void __launch_bounds__(kMode == 0 ? kWinThreads : kThreads, kMode == 0 ? 4 : 1)
csr_spmm_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                const float* __restrict__ data, const float* __restrict__ x, int n_rows,
                int n_cols, Plan plan, float* __restrict__ out) {
  if constexpr (kMode == 0) {
    __shared__ __align__(16) float buf[2][kChunk];
    const int b = blockIdx.x;
    const int n_huge = plan.count[0];
    const int lr = b < n_huge ? plan.huge[b]
                   : b - n_huge < plan.count[1] ? plan.longs[b - n_huge] : -1;
    if (lr >= 0) spmv_rows(indptr, indices, data, x, lr, lr + 1, buf, out);
    const int2 span = plan.span[b];
    for (int g0 = span.x; g0 < span.y; g0 += kWinThreads)
      spmv_rows(indptr, indices, data, x, g0, min(g0 + kWinThreads, span.y), buf, out);
  } else {
    const int lane = threadIdx.x & 31;
    const int groups = (n_cols + 31) / 32;
    const long task = (long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
    if (task >= (long)n_rows * groups) return;   // uniform across the warp
    const int r = (int)(task / groups);
    const int c = (int)(task % groups) * 32 + lane;
    const bool col = c < n_cols;
    const int begin = indptr[r];
    const int end = indptr[r + 1];
    if (end - begin > kLongCols) return;
    int ix = -1;
    float dv = 0.0f;
    if (begin + lane < end) {
      ix = __ldg(indices + begin + lane);
      dv = __ldg(data + begin + lane);
    }
    float acc = 0.0f;
    for (int s0 = begin; s0 < end; s0 += 32) {
      const int n = min(32, end - s0);   // uniform across the warp
      int nix = -1;
      float ndv = 0.0f;
      if (s0 + 32 + lane < end) {
        nix = __ldg(indices + s0 + 32 + lane);
        ndv = __ldg(data + s0 + 32 + lane);
      }
      float xv[32];
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const int j = __shfl_sync(kFull, ix, t);
        xv[t] = (t < n && col) ? __ldg(x + (size_t)j * n_cols + c) : 0.0f;
      }
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const float d = __shfl_sync(kFull, dv, t);
        if (t < n) acc = __fadd_rn(acc, __fmul_rn(d, xv[t]));
      }
      ix = nix;
      dv = ndv;
    }
    if (col) out[(size_t)r * n_cols + c] = acc;
  }
}

// More columns, long rows: block (i, tile) sums columns [128 tile, + 128)
// of long row i of the plan.  Round t: stage t % kStages holds the x
// rows of slots kRing t .. + kRing - 1 (sx) and their values (sd); warp 0
// posts the indices and values of round t + kStages - 1 (loaded a round
// ahead in its registers), every thread issues that round's copies, and
// thread c < the tile's columns folds round t.
__global__ void __launch_bounds__(kThreads)
csr_ring_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                const float* __restrict__ data, const float* __restrict__ x, int n_cols,
                Plan plan, float* __restrict__ out) {
  extern __shared__ float4 ring16[];
  const int tiles = (n_cols + kColTile - 1) / kColTile;
  const int i = blockIdx.x / tiles;
  if (i >= plan.count[1]) return;
  float* sx = reinterpret_cast<float*>(ring16);                        // [kStages][kRing][kColTile]
  int* si = reinterpret_cast<int*>(sx + kStages * kRing * kColTile);   // [kStages][kRing]
  float* sd = reinterpret_cast<float*>(si + kStages * kRing);          // [kStages][kRing]
  const int tid = threadIdx.x;
  const int c0 = (blockIdx.x - i * tiles) * kColTile;
  const int tc = min(kColTile, n_cols - c0);
  const int r = plan.longs[i];
  const int begin = indptr[r];
  const int end = indptr[r + 1];
  const int rounds = (end - begin + kRing - 1) / kRing;
  const int rb = n_cols * (int)sizeof(float);
  const int vec = rt::stage_vec(x, (size_t)rb);
  const int segs = (tc + 3) / 4;   // 16-byte copies a row
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);

  int pix = -1;   // warp 0: slot kRing t + lane's index and value, a round ahead
  float pdv = 0.0f;
  auto prefetch = [&](int t) {
    const int s = begin + t * kRing + tid;
    const bool ok = t < rounds && s < end;
    pix = ok ? __ldg(indices + s) : -1;
    pdv = ok ? __ldg(data + s) : 0.0f;
  };
  auto post = [&](int t) {   // warp 0: round t's indices and values into its stage
    si[(t % kStages) * kRing + tid] = pix;
    sd[(t % kStages) * kRing + tid] = pdv;
  };
  auto issue = [&](int t) {   // round t's x rows into its stage, one commit group
    if (t < rounds) {
      float* st = sx + (t % kStages) * kRing * kColTile;
      const int* ix = si + (t % kStages) * kRing;
      for (int e = tid; e < kRing * segs; e += kThreads) {
        const int s = e / segs;
        const int g = e - s * segs;
        const int j = ix[s];
        rt::stage16(reinterpret_cast<unsigned char*>(st + s * kColTile + 4 * g),
                    j >= 0 ? xb + (size_t)j * rb : nullptr, (c0 + 4 * g) * (int)sizeof(float),
                    rb, vec, x);
      }
    }
    rt::cp_async_commit();
  };
  for (int t = 0; t < kStages - 1; ++t) {
    if (tid < kRing) {
      prefetch(t);
      post(t);
    }
  }
  __syncthreads();
  for (int t = 0; t < kStages - 1; ++t) issue(t);
  if (tid < kRing) prefetch(kStages - 1);
  float acc = 0.0f;
  for (int t = 0; t < rounds; ++t) {
    rt::cp_async_wait<kStages - 2>();
    __syncthreads();   // round t landed; round t - 1's stage is free
    if (tid < kRing) {
      post(t + kStages - 1);
      prefetch(t + kStages);
    }
    __syncthreads();
    issue(t + kStages - 1);
    if (tid < tc) {
      const float* st = sx + (t % kStages) * kRing * kColTile + tid;
      const float* d = sd + (t % kStages) * kRing;
      const int n = min(kRing, end - begin - t * kRing);
#pragma unroll 8
      for (int s = 0; s < n; ++s) acc = __fadd_rn(acc, __fmul_rn(d[s], st[s * kColTile]));
    }
  }
  rt::cp_async_wait<0>();
  if (tid < tc) out[(size_t)r * n_cols + c0 + tid] = acc;
}

}  // namespace

// indptr [n_rows + 1], indices / data [cap >= indptr[n_rows]], x [*, n_cols]
// row-major, out [n_rows, n_cols]; every index must lie within x's rows.
// plan: scratch of 4 (cap / 1024 + 1) + 4 ints (one column) or n_rows + 2
// ints (more columns), 8-byte aligned.
extern "C" int rt_csr_spmm(const int* indptr, const int* indices, const float* data,
                           const float* x, int n_rows, int n_cols, int cap, int* scratch,
                           float* out, cudaStream_t stream) {
  if (n_rows < 0 || n_cols < 1 || cap < 0) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  const int plan_blocks = n_rows / kThreads + 1;   // rows 0 .. n_rows
  const int n_windows = n_cols == 1 ? cap / kChunk + 1 : 0;
  Plan plan;
  if (n_cols == 1) {
    plan.span = reinterpret_cast<int2*>(scratch);
    plan.huge = scratch + 2 * (n_windows + 1);
    plan.longs = plan.huge + n_windows;
    plan.count = plan.longs + n_windows;
  } else {
    plan.span = nullptr;
    plan.huge = nullptr;
    plan.longs = scratch;
    plan.count = scratch + n_rows;
  }
  cudaError_t err = cudaMemsetAsync(plan.count, 0, 2 * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  csr_plan_kernel<<<plan_blocks, kThreads, 0, stream>>>(indptr, n_rows, n_windows,
                                                        n_cols == 1 ? kChunk : kLongCols, plan);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n_cols == 1) {
    csr_spmm_kernel<0><<<n_windows, kWinThreads, 0, stream>>>(indptr, indices, data, x, n_rows,
                                                               1, plan, out);
    return (int)cudaGetLastError();
  }
  const long fits = (long)cap / (kLongCols + 1);   // rows of more than kLongCols slots
  const long most_long = fits < n_rows ? fits : (long)n_rows;
  const long tiles = (n_cols + kColTile - 1) / kColTile;
  if (most_long > 0) {
    if (most_long * tiles > 0x7fffffffL) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(csr_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kRingSmem);
    if (err != cudaSuccess) return (int)err;
    csr_ring_kernel<<<(unsigned)(most_long * tiles), kThreads, kRingSmem, stream>>>(
        indptr, indices, data, x, n_cols, plan, out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long tasks = (long)n_rows * ((n_cols + 31) / 32);
  const long blocks = (tasks + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  csr_spmm_kernel<1><<<(unsigned)blocks, kThreads, 0, stream>>>(indptr, indices, data, x, n_rows,
                                                                n_cols, plan, out);
  return (int)cudaGetLastError();
}
