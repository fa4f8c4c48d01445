// Device-side running top-k shared by the port's kernels (counterpart of
// raft_tpu/kernels/toolkit.py fold_topk).
//
// Semantics, identical to fold_topk: keep the k smallest candidates by the
// lexicographic key (value, position).  Residents were offered earlier than
// any new candidate, so they hold the lower positions; candidates are
// offered in increasing position.  A candidate therefore enters the list
// only when its value is strictly below the current k-th value, and lands
// after every resident whose value is <= its own.
//
// The list lives in shared memory, sorted ascending, initialised to
// (+inf, -1).  One warp owns one list at a time: a warp ballots 32
// candidates against the k-th value, then inserts the survivors one by one
// in position order.  After the first few tiles almost every candidate
// fails the threshold test, so the fold costs one compare per candidate.
//
// k runs up to kMaxK = 2048.  A list of at most kRegK = 128 entries
// shifts through 4 registers a lane in one step, as it always has.  A
// longer list (kWide, a template flag of every list function and of every
// kernel that folds lists, set by the launcher when k > kRegK, through
// pick_wide) shifts 32 entries at a time, from its tail down to the
// insertion point, through one register a lane; its length is a runtime
// value, so one wide instantiation serves every k in (128, 2048], sized at
// launch.  A list lives in dynamic shared memory (8 k bytes).  The k <= 128
// kernels are separate instantiations, so they keep their register counts
// (one kernel holding both paths spilled).  The wide lists serve the single
// CAGRA hop past itopk = 128; the probe-major scans past k = 128, the
// query-major scans at every k and merge_parts past k = 128 fold with
// block_select.cuh's candidate arrays instead, and select_k / fused_knn
// keep none.  raft_tpu's Pallas scans
// bound kk only by one (G, kk) f32 + int32 VMEM block; kMaxK is this port's
// own bound, and a launch past it is refused.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

#include "block_select.cuh"

namespace rt {

constexpr int kMaxK = 2048;     // deepest k any list-folding kernel serves
constexpr int kRegK = 128;      // deepest k shifted through registers at once
constexpr unsigned kFull = 0xffffffffu;

// The instantiation of a list-folding kernel for lists of k entries:
// `pick(w)` returns the kernel for kWide = decltype(w)::value, and
// pick_wide calls it with kWide = k > kRegK.
template <typename Pick>
static inline auto pick_wide(int k, Pick pick) {
  return k > kRegK ? pick(std::true_type{}) : pick(std::false_type{});
}

__device__ __forceinline__ void list_init(float* lv, int* li, int kk, int lane) {
  for (int p = lane; p < kk; p += 32) {
    lv[p] = CUDART_INF_F;
    li[p] = -1;
  }
  __syncwarp();
}

// Insert (v, id) into the warp's sorted list.  Every lane of the warp calls
// it with the same (v, id).  The caller has checked v < lv[kk - 1].
template <bool kWide>
__device__ __forceinline__ void list_insert(float v, int id, float* lv, int* li,
                                            int kk, int lane) {
  if constexpr (kWide) {
    int cnt = 0;
    for (int p = lane; p < kk; p += 32) cnt += (lv[p] <= v) ? 1 : 0;
    const int pos = __reduce_add_sync(kFull, cnt);
    // chunks [32 c, 32 c + 32), last first: chunk c reads slots 32 c - 1 ..
    // 32 c + 30 before it writes 32 c .. 32 c + 31, and no lower chunk
    // reads what a higher one wrote
    for (int c = (kk - 1) / 32; c >= pos / 32; --c) {
      const int p = 32 * c + lane;
      const bool shift = p > pos && p < kk;
      float tv = 0.0f;
      int ti = 0;
      if (shift) {
        tv = lv[p - 1];
        ti = li[p - 1];
      }
      __syncwarp();
      if (shift) {
        lv[p] = tv;
        li[p] = ti;
      } else if (p == pos) {
        lv[p] = v;
        li[p] = id;
      }
      __syncwarp();
    }
    return;
  }
  int cnt = 0;
#pragma unroll
  for (int s = 0; s < kRegK / 32; ++s) {
    int p = lane + 32 * s;
    if (p < kk) cnt += (lv[p] <= v) ? 1 : 0;
  }
  const int pos = __reduce_add_sync(kFull, cnt);
  float tv[kRegK / 32];
  int ti[kRegK / 32];
#pragma unroll
  for (int s = 0; s < kRegK / 32; ++s) {
    int p = lane + 32 * s;
    if (p > pos && p < kk) {
      tv[s] = lv[p - 1];
      ti[s] = li[p - 1];
    }
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < kRegK / 32; ++s) {
    int p = lane + 32 * s;
    if (p > pos && p < kk) {
      lv[p] = tv[s];
      li[p] = ti[s];
    } else if (p == pos) {
      lv[p] = v;
      li[p] = id;
    }
  }
  __syncwarp();
}

// Offer 32 candidates, one per lane, in lane order (lane = position order).
template <bool kWide>
__device__ __forceinline__ void list_offer32(float v, int id, float* lv, int* li,
                                             int kk, int lane) {
  unsigned mask = __ballot_sync(kFull, v < lv[kk - 1]);
  while (mask) {
    const int src = __ffs(mask) - 1;
    mask &= mask - 1;
    const float cv = __shfl_sync(kFull, v, src);
    const int ci = __shfl_sync(kFull, id, src);
    if (cv < lv[kk - 1]) list_insert<kWide>(cv, ci, lv, li, kk, lane);
  }
}

// Offer a row of n candidates held in shared memory, in index order.
// Slots whose value is +inf never enter (they could not beat the list).
template <bool kWide>
__device__ __forceinline__ void list_offer_row(const float* cv, const int* cid,
                                               int n, float* lv, int* li,
                                               int kk, int lane) {
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int c = c0 + lane;
    const float v = c < n ? cv[c] : CUDART_INF_F;
    const int id = c < n ? cid[c] : -1;
    list_offer32<kWide>(v, id, lv, li, kk, lane);
  }
}

// Dynamic shared memory a launch may ask for: the 227 KB a block can hold,
// less room for the kernels' static tiles.
constexpr size_t kMaxDynamicSmem = 179 * 1024;

// Second pass of a kernel that split one row's candidate pool over several
// blocks: each block left a sorted top-k list of its contiguous part of
// the pool, parts in pool order, so offering the lists' entries in part
// order is offering candidates in (value, position) order within a part
// and part order across parts — the merge keeps exactly the k smallest by
// (value, position).  Up to k = 128 one warp a row folds them into a list;
// past it an insert costs O(k), so one block a row radix-selects and sorts
// them (block_select.cuh merge_select_kernel, the same order).  Rows of
// n_cand candidates.
constexpr int kMergeWarps = 4;

static __global__ void __launch_bounds__(32 * kMergeWarps)
merge_parts_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
                   int rows, int n_cand, int k, float* __restrict__ out_v,
                   int* __restrict__ out_i) {
  extern __shared__ unsigned char smem_raw[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* lv = reinterpret_cast<float*>(smem_raw) + warp * k;
  int* li = reinterpret_cast<int*>(reinterpret_cast<float*>(smem_raw) + kMergeWarps * k) + warp * k;
  const int row = blockIdx.x * kMergeWarps + warp;
  if (row >= rows) return;
  list_init(lv, li, k, lane);
  list_offer_row<false>(part_v + (size_t)row * n_cand, part_i + (size_t)row * n_cand, n_cand,
                        lv, li, k, lane);
  for (int p = lane; p < k; p += 32) {
    out_v[(size_t)row * k + p] = lv[p];
    out_i[(size_t)row * k + p] = li[p];
  }
}

static inline cudaError_t merge_parts(const float* part_v, const int* part_i, int rows,
                                      int n_cand, int k, float* out_v, int* out_i,
                                      cudaStream_t stream) {
  if (rows == 0) return cudaSuccess;
  if (k > kRegK) {
    const size_t smem = merge_select_smem(k);
    const cudaError_t err = cudaFuncSetAttribute(
        merge_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    merge_select_kernel<<<rows, kMergeThreads, smem, stream>>>(part_v, part_i, n_cand, k, out_v,
                                                                out_i);
    return cudaGetLastError();
  }
  const int blocks = (rows + kMergeWarps - 1) / kMergeWarps;
  const size_t smem = (size_t)kMergeWarps * k * (sizeof(float) + sizeof(int));
  merge_parts_kernel<<<blocks, 32 * kMergeWarps, smem, stream>>>(
      part_v, part_i, rows, n_cand, k, out_v, out_i);
  return cudaGetLastError();
}

}  // namespace rt
