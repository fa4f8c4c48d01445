// Brute-force kNN: the k smallest partial scores of each query; the
// [n_q, n] score matrix never reaches device memory.
//
// Replaces raft_tpu/kernels/fused_knn.py fused_l2_topk / _fused_knn_kernel.
// Scores: l2 mode  |x|^2 - 2 q.x   (the caller adds |q|^2 and clamps at 0)
//         ip mode  -q.x
// Each query keeps the k smallest (score, dataset column); the lowest
// column wins a tie, as fold_topk gives on the TPU.
//
// What bounds it on the H100: 2 d flops per (query, row) pair against one
// read of the dataset, so at 10^4 queries it is bound by f32 FMA rate (no
// tensor cores: the slice scores at full f32), and past k = 128 it was
// bound by the selection: topk.cuh's lists, in shared memory at 8 k bytes
// each, shifted up to k / 32 chunks for each candidate that beat a list's
// k-th value and left 11 query rows of the 64-row tile at k = 2048 (957 ms
// at k = 2048 on 1,000 queries, 37 times topk(cdist)).
//
// The design: a 64 x 64 register-tiled product per step (16 FMAs per
// thread per dimension, each pair's dot product one fmaf chain in dimension
// order, its operands read four dimensions at a time), one block per 64
// queries and one contiguous part of the dataset, the query and dataset
// chunks staged by cp.async two stages deep, so that the next chunk (also
// the next tile's first, across the selection) loads while this one is
// multiplied.  Every query row of the tile stays at every k: the lists
// leave shared memory.  Each (query, part) appends the scores below its
// threshold, in column order, to an array of `cap` >= k + 256 slots in
// device memory; when arrays near full, the block's warps share them out,
// each finding an array's k-th key by a radix select, keeping the k
// smallest in place (stable, so the array stays in column order and a tie
// goes to the lower column) and making that key the threshold.  A survivor
// costs O(1) amortised, not O(k).  A final kernel per query selects the k
// smallest of its parts' arrays the same way and sorts them (bitonic,
// shared memory).  The wrapper cuts the dataset into as many parts as fill
// whole waves of the card (two blocks an SM).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "block_select.cuh"
#include "tile_gemm.cuh"
#include "topk.cuh"

namespace {

constexpr int kWarps = rt::kGemmThreads / 32;

using Stage = rt::Stage<rt::kBM>;

// Candidate arrays: row m of the block, part blockIdx.y, at
// cand + ((q0 + m) * gridDim.y + blockIdx.y) * cap; counts [n_q][gridDim.y]
// receive each array's final length (<= k).
template <bool kVec>
__global__ void __launch_bounds__(rt::kGemmThreads, 2)
fused_knn_kernel(const float* __restrict__ q, const float* __restrict__ x,
                 const float* __restrict__ xx, int n_q, int n, int d, int k, int ip_mode,
                 int c_chunk, int cap, float* __restrict__ cand_v, int* __restrict__ cand_i,
                 int* __restrict__ counts) {
  __shared__ Stage st[2];
  __shared__ float sthr[rt::kBM];
  __shared__ int scount[rt::kBM];
  __shared__ int shist[kWarps][258];
  __shared__ int slist[rt::kBM];   // the rows to compact, and how many
  __shared__ int snum;
  __shared__ int sflag;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int q0 = blockIdx.x * rt::kBM;
  const int q_rows = min(rt::kBM, n_q - q0);
  const float* qa = q + (size_t)q0 * d;
  const int splits = gridDim.y;
  const int part = blockIdx.y;
  const int c_begin = part * c_chunk;
  const int c_end = min(n, c_begin + c_chunk);
  auto row_base = [&](int m) { return ((size_t)(q0 + m) * splits + part) * cap; };
  auto row_slots = [&](int m) {
    float* cv = cand_v + row_base(m);
    int* ci = cand_i + row_base(m);
    return [=](int e) { return rt::Slot{cv + e, ci + e}; };
  };

  if (tid < rt::kBM) {
    sthr[tid] = CUDART_INF_F;
    scount[tid] = 0;
  }
  if (tid == 0) sflag = 0;

  const int nchunks = (d + rt::kBK - 1) / rt::kBK;
  const int tiles = (c_end - c_begin + rt::kBN - 1) / rt::kBN;
  const int total = tiles * nchunks;
  rt::issue_chunk<kVec>(st[0], qa, q_rows, x + (size_t)c_begin * d, min(rt::kBN, c_end - c_begin),
                    d, 0, tid);
  int g = 0;
  for (int t = 0; t < tiles; ++t) {
    const int c0 = c_begin + t * rt::kBN;
    const int c_rows = min(rt::kBN, c_end - c0);
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int ch = 0; ch < nchunks; ++ch, ++g) {
      if (g + 1 < total) {   // the next chunk, the next tile's first after the last
        const int t1 = (g + 1) / nchunks;
        const int c1 = c_begin + t1 * rt::kBN;
        rt::issue_chunk<kVec>(st[(g + 1) & 1], qa, q_rows, x + (size_t)c1 * d,
                          min(rt::kBN, c_end - c1), d, ((g + 1) % nchunks) * rt::kBK, tid);
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::);
      }
      __syncthreads();
      const Stage& sm = st[g & 1];
      const int kn = min(rt::kBK, d - ch * rt::kBK);
      int kk = 0;
      for (; kk + 4 <= kn; kk += 4) {   // four dimensions, in order, per pair
        float4 av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          av[i] = *reinterpret_cast<const float4*>(&sm.a[ty + 16 * i][kk]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bv[j] = *reinterpret_cast<const float4*>(&sm.b[tx + 16 * j][kk]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
            acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
            acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
            acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
          }
      }
      for (; kk < kn; ++kk) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = sm.a[ty + 16 * i][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = sm.b[tx + 16 * j][kk];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
    // scores below their row's threshold join its array, in column order
    // (j, then tx): the half-warp (tid / 16) that owns row ty + 16 i appends
    float norm[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      norm[j] = (c < c_rows && !ip_mode) ? xx[c0 + c] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      const float thr = sthr[row];
      int base = scount[row];
      float* rv = cand_v + row_base(row);
      int* ri = cand_i + row_base(row);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float v = ip_mode ? -acc[i][j] : norm[j] - 2.0f * acc[i][j];
        const bool keep = row < q_rows && c < c_rows && v < thr;
        const unsigned half = (__ballot_sync(0xffffffffu, keep) >> (lane & 16)) & 0xffffu;
        if (keep) {
          const int pos = base + __popc(half & ((1u << tx) - 1u));
          rv[pos] = v;
          ri[pos] = c0 + c;
        }
        base += __popc(half);
      }
      if (tx == 0 && row < q_rows) {
        scount[row] = base;
        if (base > cap - rt::kBN) sflag = 1;
      }
    }
    __syncthreads();
    const int flagged = sflag;
    if (flagged) {   // arrays that may not hold the next tile: listed, then compacted
      if (warp == 0) {
        const bool n0 = lane < q_rows && scount[lane] > cap - rt::kBN;
        const bool n1 = lane + 32 < q_rows && scount[lane + 32] > cap - rt::kBN;
        const unsigned b0 = __ballot_sync(0xffffffffu, n0);
        const unsigned b1 = __ballot_sync(0xffffffffu, n1);
        if (n0) slist[__popc(b0 & rt::lanemask_lt(lane))] = lane;
        if (n1) slist[__popc(b0) + __popc(b1 & rt::lanemask_lt(lane))] = lane + 32;
        if (lane == 0) snum = __popc(b0) + __popc(b1);
      }
      __syncthreads();   // every thread has read sflag: it may be cleared
      if (tid == 0) sflag = 0;
      for (int t2 = warp; t2 < snum; t2 += kWarps) {
        const int m = slist[t2];
        const float thr = rt::warp_compact(row_slots(m), scount[m], k, shist[warp], lane);
        if (lane == 0) {
          sthr[m] = thr;
          scount[m] = k;
        }
      }
      __syncthreads();
    }
  }
  for (int m = warp; m < q_rows; m += kWarps) {
    int cnt = scount[m];
    if (cnt > k) {
      rt::warp_compact(row_slots(m), cnt, k, shist[warp], lane);
      cnt = k;
    }
    if (lane == 0) counts[(size_t)(q0 + m) * splits + part] = cnt;
  }
}

// The sort key of a candidate: okey(value), then column, then the sign of
// a zero (which okey drops and the output keeps).
__device__ __forceinline__ unsigned long long cand_key(float v, int col) {
  return (unsigned long long)rt::okey(v) << 32 |
         ((unsigned)col << 1 | (__float_as_uint(v) >> 31));
}

constexpr int kFinalThreads = 256;

// Exclusive prefix of `flag` over the block (thread order) and the block's
// total; `sw` holds kFinalThreads / 32 ints.
__device__ __forceinline__ int block_prefix(bool flag, int* sw, int* total) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const unsigned m = __ballot_sync(0xffffffffu, flag);
  __syncthreads();
  if (lane == 0) sw[warp] = __popc(m);
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < kFinalThreads / 32; ++w) {
    before += w < warp ? sw[w] : 0;
    all += sw[w];
  }
  *total = all;
  return before + __popc(m & rt::lanemask_lt(lane));
}

// One block per query: the k smallest by (score, column) of its parts'
// candidate arrays (each in column order, parts in column order), sorted.
__global__ void __launch_bounds__(kFinalThreads)
fused_knn_final_kernel(const float* __restrict__ cand_v, const int* __restrict__ cand_i,
                       const int* __restrict__ counts, int splits, int cap, int k, int k_pow2,
                       float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ unsigned long long skey[];   // [k_pow2]
  __shared__ int hist[258];
  __shared__ int sw[kFinalThreads / 32];
  const int qi = blockIdx.x;
  const float* cv = cand_v + (size_t)qi * splits * cap;
  const int* ci = cand_i + (size_t)qi * splits * cap;
  const int* cnt = counts + (size_t)qi * splits;
  // index e = p k + i: entry i of part p's array (present while i < cnt[p])
  auto at = [&](int e, float& v, int& col) {
    const int p = e / k;
    const int i = e - p * k;
    if (i >= cnt[p]) return false;
    v = cv[(size_t)p * cap + i];
    col = ci[(size_t)p * cap + i];
    return true;
  };
  const int n_idx = splits * k;
  int below;
  const unsigned kth = rt::radix_select<true>(
      [&](int e, unsigned& key) {
        float v;
        int col;
        if (!at(e, v, col)) return false;
        key = rt::okey(v);
        return true;
      },
      n_idx, k, hist, &below);
  const int need_eq = k - below;
  int w = 0, eq = 0;
  for (int e0 = 0; e0 < n_idx; e0 += kFinalThreads) {
    const int e = e0 + threadIdx.x;
    float v = 0.0f;
    int col = 0;
    const bool present = e < n_idx && at(e, v, col);
    const unsigned key = present ? rt::okey(v) : ~0u;
    const bool is_eq = present && key == kth;
    int eq_total, keep_total;
    const int eq_rank = eq + block_prefix(is_eq, sw, &eq_total);
    const bool keep = (present && key < kth) || (is_eq && eq_rank < need_eq);
    const int pos = w + block_prefix(keep, sw, &keep_total);
    if (keep) skey[pos] = cand_key(v, col);
    w += keep_total;
    eq += eq_total;
  }
  for (int p = k + threadIdx.x; p < k_pow2; p += kFinalThreads) skey[p] = rt::kPadKey;
  rt::block_sort<false>(skey, nullptr, k_pow2);
  for (int t = threadIdx.x; t < k; t += kFinalThreads) {
    const unsigned long long key = skey[t];
    const unsigned low = (unsigned)key;
    float v = rt::okey_value((unsigned)(key >> 32));
    if (v == 0.0f && (low & 1u)) v = -0.0f;
    out_v[(size_t)qi * k + t] = v;
    out_i[(size_t)qi * k + t] = (int)(low >> 1);
  }
}

}  // namespace

// splits cuts the dataset into that many contiguous parts, one grid column
// each (so small query batches still fill the card); part_v / part_i are
// the candidate arrays [n_q, splits, cap] and counts [n_q, splits] their
// lengths, folded by the final kernel.
extern "C" int rt_fused_knn(const float* q, const float* x, const float* xx,
                            int n_q, int n, int d, int k, int ip_mode, int splits, int cap,
                            float* part_v, int* part_i, int* counts, float* out_v,
                            int* out_i, void* stream) {
  if (k < 1 || k > rt::kMaxK || k > n || d < 1 || splits < 1 || cap < k + 4 * rt::kBN)
    return (int)cudaErrorInvalidValue;
  if (n_q == 0) return (int)cudaSuccess;
  auto s = (cudaStream_t)stream;
  const int c_chunk = ((n + splits - 1) / splits + rt::kBN - 1) / rt::kBN * rt::kBN;
  splits = (n + c_chunk - 1) / c_chunk;
  dim3 grid((n_q + rt::kBM - 1) / rt::kBM, splits);
  // rows 16-byte aligned: four dimensions a copy
  const bool vec = d % 4 == 0 && (uintptr_t)q % 16 == 0 && (uintptr_t)x % 16 == 0;
  auto kernel = vec ? fused_knn_kernel<true> : fused_knn_kernel<false>;
  kernel<<<grid, rt::kGemmThreads, 0, s>>>(q, x, xx, n_q, n, d, k, ip_mode, c_chunk, cap, part_v,
                                           part_i, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int k_pow2 = 1;
  while (k_pow2 < k) k_pow2 *= 2;
  const size_t smem = (size_t)k_pow2 * sizeof(unsigned long long);
  err = cudaFuncSetAttribute(fused_knn_final_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_knn_final_kernel<<<n_q, kFinalThreads, smem, s>>>(part_v, part_i, counts, splits, cap, k,
                                                           k_pow2, out_v, out_i);
  return (int)cudaGetLastError();
}
