// Per-row k-selection for rows of up to 8192 floats, k <= 2048.
//
// Replaces raft_tpu/kernels/select_k.py select_k_pallas / _select_kernel
// (k rounds of masked min-extraction with a removal mask).
//
// What bounds it on the H100: one read of each row and a k-wide write, so
// bytes bound it; the TPU kernel's k extraction rounds would make it bound
// by latency instead (k block-wide reductions, each with barriers: 1.8 ms
// for [10000, 258] at k = 129, 4.6 times torch.topk).  The design sorts
// instead of extracting, so its work does not grow with k rounds:
//
// - k <= 256: one warp per row, four rows a block.  The warp keeps the K
//   smallest keys seen so far (K = k rounded up to a power of two, at
//   least 32) sorted in registers, K / 32 a lane, and reads the row K
//   values at a time: each chunk is sorted by a bitonic network (shuffles
//   across lanes, exchanges within a lane) and merged into the queue by the
//   bitonic min-merge (RAFT's warp-sort).  A chunk none of whose keys beats
//   the queue's k-th is skipped.
// - k > 256: one block per row sorts the whole row (padded to a power of
//   two) in shared memory with a bitonic network and writes its head.
//
// Key: (value, tie, position), smallest first, as one 64-bit unsigned key
// where it can be: positional mode (okey(value) << 32 | position; payload
// ids[pos] or pos), stable mode (okey(value) << 32 | tie, position beside
// it; tie = id with negatives as INT_MAX, payload = id with negatives as
// -1).  select_min = 0 negates the values.  -0.0 ties +0.0 (okey) unless
// the caller passes `signed_zeros` (positional selection past k = 128,
// where raft_tpu takes lax.top_k and -0.0 ranks first: okey_signed).  A
// full order of the keys needs no removal mask: +inf and NaN are keys like
// any other, and pad slots (kPadKey) come after all of them.  Values are
// re-read from the row at the winner's position, so each comes out with
// its own bits.
#include <climits>
#include <cuda_runtime.h>

#include "block_select.cuh"

namespace {

constexpr int kMaxN = 8192;
constexpr int kMaxK = 2048;
constexpr int kMaxWarpK = 256;    // deepest k of the warp-per-row path
constexpr int kRowsPerBlock = 4;  // warps (rows) of a warp-path block
constexpr int kSortThreads = 1024;

struct Row {
  const float* scores;
  const int* ids;
  long ids_row_stride;
  int n;
  int select_min;
  int signed_zeros;
};

__device__ __forceinline__ unsigned value_key(const Row& r, float x) {
  const float v = r.select_min ? x : -x;
  return r.signed_zeros ? rt::okey_signed(v) : rt::okey(v);
}

__device__ __forceinline__ int tie_of(const int* irow, int p) {
  const int base = irow ? irow[p] : p;
  return base < 0 ? INT_MAX : base;
}

// The sort item of position p of a row (pads past n).
template <bool kStable>
__device__ __forceinline__ rt::Item<kStable> item_at(const Row& r, const float* srow,
                                                      const int* irow, int p) {
  rt::Item<kStable> it;
  it.p = kStable ? (p < r.n ? p : INT_MAX) : 0;
  if (p >= r.n) {
    it.k = rt::kPadKey;
    return it;
  }
  const unsigned long long hi = (unsigned long long)value_key(r, srow[p]) << 32;
  it.k = hi | (unsigned)(kStable ? tie_of(irow, p) : p);
  return it;
}

template <bool kStable>
__device__ __forceinline__ int position_of(const rt::Item<kStable>& it) {
  return kStable ? it.p : (int)(unsigned)(it.k & 0xffffffffu);
}

__device__ __forceinline__ void write_out(const Row& r, const float* srow, const int* irow,
                                          int pos, bool stable, float* out_v, int* out_i) {
  *out_v = srow[pos];
  const int base = irow ? irow[pos] : pos;
  *out_i = stable && base < 0 ? -1 : base;
}

template <int R, bool kStable>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
select_k_warp_kernel(Row r, int rows, int k, float* __restrict__ out_v,
                     int* __restrict__ out_i) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;
  const float* srow = r.scores + (size_t)row * r.n;
  const int* irow = r.ids ? r.ids + (size_t)row * r.ids_row_stride : nullptr;
  constexpr int K = 32 * R;
  rt::Item<kStable> q[R], c[R];
  for (int c0 = 0; c0 < r.n; c0 += K) {
#pragma unroll
    for (int j = 0; j < R; ++j) c[j] = item_at<kStable>(r, srow, irow, c0 + lane * R + j);
    if (c0 == 0) {
      rt::warp_sort<R, kStable>(c, lane);
#pragma unroll
      for (int j = 0; j < R; ++j) q[j] = c[j];
      continue;
    }
    // the queue's k-th item: register (k - 1) % R of lane (k - 1) / R
    rt::Item<kStable> kth = q[0];
#pragma unroll
    for (int j = 1; j < R; ++j)
      if (j == (k - 1) % R) kth = q[j];
    kth.k = __shfl_sync(0xffffffffu, kth.k, (k - 1) / R);
    kth.p = __shfl_sync(0xffffffffu, kth.p, (k - 1) / R);
    bool any = false;
#pragma unroll
    for (int j = 0; j < R; ++j) any |= rt::item_less(c[j], kth);
    if (!__any_sync(0xffffffffu, any)) continue;
    rt::warp_sort<R, kStable>(c, lane);
    rt::warp_merge<R, kStable>(q, c, lane);
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int e = lane * R + j;
    if (e < k)
      write_out(r, srow, irow, position_of(q[j]), kStable, out_v + (size_t)row * k + e,
                out_i + (size_t)row * k + e);
  }
}

template <bool kStable>
__global__ void __launch_bounds__(kSortThreads)
select_k_sort_kernel(Row r, int n_pow2, int k, float* __restrict__ out_v,
                     int* __restrict__ out_i) {
  extern __shared__ unsigned long long skey[];           // [n_pow2]
  int* spos = reinterpret_cast<int*>(skey + n_pow2);     // [n_pow2] (kStable)
  const int row = blockIdx.x;
  const float* srow = r.scores + (size_t)row * r.n;
  const int* irow = r.ids ? r.ids + (size_t)row * r.ids_row_stride : nullptr;
  for (int p = threadIdx.x; p < n_pow2; p += blockDim.x) {
    const rt::Item<kStable> it = item_at<kStable>(r, srow, irow, p);
    skey[p] = it.k;
    if constexpr (kStable) spos[p] = it.p;
  }
  rt::block_sort<kStable>(skey, spos, n_pow2);
  for (int e = threadIdx.x; e < k; e += blockDim.x) {
    const int pos = kStable ? spos[e] : (int)(unsigned)(skey[e] & 0xffffffffu);
    write_out(r, srow, irow, pos, kStable, out_v + (size_t)row * k + e,
              out_i + (size_t)row * k + e);
  }
}

template <int R>
cudaError_t launch_warp(const Row& r, int rows, int k, int stable, float* out_v, int* out_i,
                        cudaStream_t s) {
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (stable)
    select_k_warp_kernel<R, true><<<blocks, 32 * kRowsPerBlock, 0, s>>>(r, rows, k, out_v,
                                                                         out_i);
  else
    select_k_warp_kernel<R, false><<<blocks, 32 * kRowsPerBlock, 0, s>>>(r, rows, k, out_v,
                                                                          out_i);
  return cudaGetLastError();
}

template <bool kStable>
cudaError_t launch_sort(const Row& r, int rows, int k, float* out_v, int* out_i, cudaStream_t s) {
  int n_pow2 = 1;
  while (n_pow2 < r.n) n_pow2 *= 2;
  const size_t smem =
      (size_t)n_pow2 * (sizeof(unsigned long long) + (kStable ? sizeof(int) : 0));
  auto kernel = select_k_sort_kernel<kStable>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<rows, kSortThreads, smem, s>>>(r, n_pow2, k, out_v, out_i);
  return cudaGetLastError();
}

}  // namespace

// signed_zeros: rank -0.0 below +0.0 (the wrapper's rule: positional
// selection past raft_tpu's Pallas k).
extern "C" int rt_select_k(const float* scores, const int* ids, long ids_row_stride,
                           int rows, int n, int k, int select_min, int stable, int signed_zeros,
                           float* out_v, int* out_i, void* stream) {
  if (n > kMaxN || k > kMaxK || k > n || n < 1 || k < 1) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const Row r{scores, ids, ids_row_stride, n, select_min, signed_zeros};
  auto s = (cudaStream_t)stream;
  cudaError_t err;
  if (k <= 32) err = launch_warp<1>(r, rows, k, stable, out_v, out_i, s);
  else if (k <= 64) err = launch_warp<2>(r, rows, k, stable, out_v, out_i, s);
  else if (k <= 128) err = launch_warp<4>(r, rows, k, stable, out_v, out_i, s);
  else if (k <= kMaxWarpK) err = launch_warp<8>(r, rows, k, stable, out_v, out_i, s);
  else if (stable) err = launch_sort<true>(r, rows, k, out_v, out_i, s);
  else err = launch_sort<false>(r, rows, k, out_v, out_i, s);
  return (int)err;
}
