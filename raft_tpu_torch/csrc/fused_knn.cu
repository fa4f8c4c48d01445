// Brute-force kNN partial scores folded into a running top-k; the
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
// tensor cores: the slice scores at full f32).  The design is a 64 x 64
// register-tiled product per step (tile_gemm.cuh, 16 FMAs per thread per
// dimension) whose scores go to shared memory, where each warp folds eight
// queries' 64 candidates into their lists with one compare per candidate
// (topk.cuh).  One block owns 64 queries (fewer past k = 349, where 64
// lists outgrow shared memory) and streams one contiguous part of the
// dataset; a batch too small to fill the card cuts the dataset into
// more parts and merges their lists (topk.cuh merge_parts).
#include <cuda_runtime.h>
#include <math_constants.h>

#include "tile_gemm.cuh"
#include "topk.cuh"

namespace {

template <bool kWide>
__global__ void __launch_bounds__(rt::kGemmThreads)
fused_knn_kernel(const float* __restrict__ q, const float* __restrict__ x,
                 const float* __restrict__ xx, int n_q, int n, int d, int k,
                 int ip_mode, int c_chunk, int qpb, float* __restrict__ out_v,
                 int* __restrict__ out_i) {
  extern __shared__ unsigned char smem_raw[];
  float* lv = reinterpret_cast<float*>(smem_raw);          // [qpb][k]
  int* li = reinterpret_cast<int*>(lv + qpb * k);          // [qpb][k]
  __shared__ rt::GemmSmem gsm;
  __shared__ float s[rt::kBM][rt::kBN + 1];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int q0 = blockIdx.x * qpb;
  const int q_rows = min(qpb, n_q - q0);
  const float* qa = q + (size_t)q0 * d;
  // this block's part of the dataset, and where its lists go: row
  // (q0 + m) of [n_q, gridDim.y * k], part blockIdx.y
  const int c_begin = blockIdx.y * c_chunk;
  const int c_end = min(n, c_begin + c_chunk);
  const size_t out_stride = (size_t)gridDim.y * k;
  const size_t out_off = (size_t)blockIdx.y * k;

  for (int m = warp; m < q_rows; m += rt::kGemmThreads / 32)
    rt::list_init(lv + m * k, li + m * k, k, lane);

  float acc[4][4];
  for (int c0 = c_begin; c0 < c_end; c0 += rt::kBN) {
    const int c_rows = min(rt::kBN, c_end - c0);
    rt::tile_gemm(qa, q_rows, d, x + (size_t)c0 * d, c_rows, d, d, gsm, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const float norm = (c < c_rows && !ip_mode) ? xx[c0 + c] : 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float v;
        if (c >= c_rows) {
          v = CUDART_INF_F;
        } else if (ip_mode) {
          v = -acc[i][j];
        } else {
          v = norm - 2.0f * acc[i][j];
        }
        s[ty + 16 * i][c] = v;
      }
    }
    __syncthreads();
    for (int m = warp; m < q_rows; m += rt::kGemmThreads / 32) {
      float* mv = lv + m * k;
      int* mi = li + m * k;
      for (int cc = 0; cc < rt::kBN; cc += 32) {
        const int c = cc + lane;
        rt::list_offer32<kWide>(s[m][c], c0 + c, mv, mi, k, lane);
      }
    }
  }
  __syncwarp();
  for (int m = warp; m < q_rows; m += rt::kGemmThreads / 32) {
    for (int p = lane; p < k; p += 32) {
      out_v[(size_t)(q0 + m) * out_stride + out_off + p] = lv[m * k + p];
      out_i[(size_t)(q0 + m) * out_stride + out_off + p] = li[m * k + p];
    }
  }
}

}  // namespace

// splits > 1 cuts the dataset into that many contiguous parts, one grid
// column each (so small query batches still fill the card); their lists
// land in part_v / part_i [n_q, splits * k] and merge_parts folds them.
extern "C" int rt_fused_knn(const float* q, const float* x, const float* xx,
                            int n_q, int n, int d, int k, int ip_mode, int splits,
                            float* part_v, int* part_i, float* out_v, int* out_i,
                            void* stream) {
  if (k < 1 || k > rt::kMaxK || k > n || d < 1 || splits < 1)
    return (int)cudaErrorInvalidValue;
  if (n_q == 0) return (int)cudaSuccess;
  const int qpb = rt::lists_per_block(k, rt::kBM);
  const size_t smem = (size_t)qpb * k * (sizeof(float) + sizeof(int));
  auto kernel = rt::pick_wide(k, [](auto w) { return fused_knn_kernel<decltype(w)::value>; });
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int c_chunk = ((n + splits - 1) / splits + rt::kBN - 1) / rt::kBN * rt::kBN;
  splits = (n + c_chunk - 1) / c_chunk;
  dim3 grid((n_q + qpb - 1) / qpb, splits);
  const bool merge = splits > 1;
  kernel<<<grid, rt::kGemmThreads, smem, (cudaStream_t)stream>>>(
      q, x, xx, n_q, n, d, k, ip_mode, c_chunk, qpb, merge ? part_v : out_v,
      merge ? part_i : out_i);
  err = cudaGetLastError();
  if (err != cudaSuccess || !merge) return (int)err;
  return (int)rt::merge_parts(part_v, part_i, n_q, splits * k, k, out_v, out_i,
                              (cudaStream_t)stream);
}
