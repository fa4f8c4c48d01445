// Per-row k-selection for rows of up to 8192 floats, k <= 2048.
//
// Replaces raft_tpu/kernels/select_k.py select_k_pallas / _select_kernel
// (k rounds of masked min-extraction with a removal mask).
//
// What bounds it on the H100: one read of each row and a k-wide write are
// tiny next to the k block-wide reductions, so it is bound by latency
// (shuffles and barriers), not by bytes or flops, and its time grows with
// k: k = 129 over 258-wide rows (CAGRA's refine) is 129 rounds.  The design keeps
// the whole row in shared memory and each thread's best remaining entry in
// registers: a round is one block-wide argmin of 256 cached keys, and only
// the thread that owned the winner rescans its (at most 32) entries.  The
// removal mask is a 32-bit register per thread, so +inf entries stay
// selectable exactly once, as in the TPU kernel.
//
// Key: (value, tie, position), smallest first.  Positional mode: tie =
// position, payload = ids[pos] (or pos).  Stable mode: tie = id with
// negative ids remapped to INT_MAX, payload = id with negatives as -1.
// select_min = 0 negates values on load and on store.
#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxN = 8192;
constexpr int kMaxK = 2048;
constexpr int kThreads = 256;

struct Key {
  float v;
  int tie;
  int pos;
};

__device__ __forceinline__ bool better(const Key& a, const Key& b) {
  if (a.v != b.v) return a.v < b.v;
  if (a.tie != b.tie) return a.tie < b.tie;
  return a.pos < b.pos;
}

__device__ __forceinline__ Key shfl_key(const Key& k, int src_lane_delta) {
  Key o;
  o.v = __shfl_down_sync(0xffffffffu, k.v, src_lane_delta);
  o.tie = __shfl_down_sync(0xffffffffu, k.tie, src_lane_delta);
  o.pos = __shfl_down_sync(0xffffffffu, k.pos, src_lane_delta);
  return o;
}

__device__ __forceinline__ Key warp_best(Key k) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Key o = shfl_key(k, off);
    if (better(o, k)) k = o;
  }
  return k;
}

__global__ void select_k_kernel(const float* __restrict__ scores,
                                const int* __restrict__ ids, long ids_row_stride,
                                int n, int k, int select_min, int stable,
                                float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ unsigned char smem_raw[];
  float* sv = reinterpret_cast<float*>(smem_raw);
  int* stie = reinterpret_cast<int*>(sv + n);
  __shared__ Key red[kThreads / 32];
  __shared__ Key win;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const float* srow = scores + (size_t)row * n;
  const int* irow = ids ? ids + (size_t)row * ids_row_stride : nullptr;

  for (int p = tid; p < n; p += nthreads) {
    const float x = srow[p];
    sv[p] = select_min ? x : -x;
    if (stable) {
      const int base = irow ? irow[p] : p;
      stie[p] = base < 0 ? INT_MAX : base;
    } else {
      stie[p] = p;
    }
  }
  __syncthreads();

  // entries owned by this thread: p = tid + j * nthreads, j < 32
  unsigned removed = 0u;
  auto rescan = [&]() {
    Key best{CUDART_INF_F, INT_MAX, INT_MAX};
    for (int j = 0; j < 32; ++j) {
      const int p = tid + j * nthreads;
      if (p >= n) break;
      if (removed & (1u << j)) continue;
      Key c{sv[p], stie[p], p};
      if (better(c, best)) best = c;
    }
    return best;
  };
  Key mine = rescan();

  for (int t = 0; t < k; ++t) {
    Key b = warp_best(mine);
    if (lane == 0) red[warp] = b;
    __syncthreads();
    if (warp == 0) {
      Key c = lane < nthreads / 32 ? red[lane]
                                   : Key{CUDART_INF_F, INT_MAX, INT_MAX};
      c = warp_best(c);
      if (lane == 0) win = c;
    }
    __syncthreads();
    const Key w = win;
    if (tid == 0) {
      out_v[(size_t)row * k + t] = select_min ? w.v : -w.v;
      int pay;
      if (stable) {
        const int base = irow ? irow[w.pos] : w.pos;
        pay = base < 0 ? -1 : base;
      } else {
        pay = irow ? irow[w.pos] : w.pos;
      }
      out_i[(size_t)row * k + t] = pay;
    }
    if (w.pos % nthreads == tid) {
      removed |= 1u << (w.pos / nthreads);
      mine = rescan();
    }
  }
}

}  // namespace

extern "C" int rt_select_k(const float* scores, const int* ids, long ids_row_stride,
                           int rows, int n, int k, int select_min, int stable,
                           float* out_v, int* out_i, void* stream) {
  if (n > kMaxN || k > kMaxK || k > n || n < 1 || k < 1) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  int threads = ((n + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > kThreads ? kThreads : threads);
  const size_t smem = (size_t)n * (sizeof(float) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      select_k_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(kMaxN * (sizeof(float) + sizeof(int))));
  if (err != cudaSuccess) return (int)err;
  select_k_kernel<<<rows, threads, smem, (cudaStream_t)stream>>>(
      scores, ids, ids_row_stride, n, k, select_min, stable, out_v, out_i);
  return (int)cudaGetLastError();
}
