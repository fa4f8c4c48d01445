// Fused L2 1-NN assignment: for each row of x the smallest partial score
// cc[j] - 2 x.c_j over the centers, and its argmin; the [n, n_centers]
// score matrix never reaches device memory.
//
// Replaces raft_tpu/kernels/fused_argmin.py fused_l2_argmin /
// _fused_argmin_kernel.  No |x|^2 term and no clamp: the same function as
// the TPU kernel (add |x|^2 for the true squared distance; the ranking is
// the same).  Ties go to the first center: within a 64-center tile the
// lowest column, across tiles the earlier tile unless the later one is
// strictly smaller, so overall the lowest index among the minima, as the
// TPU kernel's (row tile 512, center tile 128) grid gives.  A row whose
// every score is +inf keeps (+inf, 0), as the TPU kernel's initial block.
//
// What bounds it on the H100: 2 d flops per (row, center) pair against one
// read of x and of the centers, so at n_centers ~ 10^3 it is bound by f32
// FMA rate (no tensor cores: raft_tpu scores at Precision.HIGHEST, and the
// kernel must stay bitwise to its plain version).  The design is a
// 64 x 64 register-tiled product per step (tile_gemm.cuh:
// each dot product one f32 accumulator, fmaf in dimension order, as
// toolkit.sequential_dot), then an epilogue that rounds where the plain
// version's tensor ops round (__fsub_rn(cc, 2 dot)), a per-thread min over
// its four columns of a row, and a min over the row's 16 threads by
// shuffle.  One block owns 64 rows and walks every center tile; the
// running (min, argmin) of each row lives in registers.
#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "tile_gemm.cuh"

namespace {

// (v, i) beats (w, j) when smaller, or equal with the lower index
__device__ __forceinline__ bool before(float v, int i, float w, int j) {
  return v < w || (v == w && i < j);
}

// two blocks an SM: room for 128 registers a thread (ptxas otherwise
// settled at 64 and spilled the running pairs)
__global__ void __launch_bounds__(rt::kGemmThreads, 2)
fused_argmin_kernel(const float* __restrict__ x, const float* __restrict__ c,
                    const float* __restrict__ cc, int n, int n_centers, int d,
                    float* __restrict__ out_v, int* __restrict__ out_i) {
  __shared__ rt::GemmSmem gsm;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int r0 = blockIdx.x * rt::kBM;
  const int rows = min(rt::kBM, n - r0);
  const float* xa = x + (size_t)r0 * d;

  float run_v[4];
  int run_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    run_v[i] = CUDART_INF_F;
    run_i[i] = 0;
  }
  float acc[4][4];
  for (int c0 = 0; c0 < n_centers; c0 += rt::kBN) {
    const int c_rows = min(rt::kBN, n_centers - c0);
    rt::tile_gemm(xa, rows, d, c + (size_t)c0 * d, c_rows, d, d, gsm, acc);
    float norm[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      norm[j] = col < c_rows ? cc[c0 + col] : CUDART_INF_F;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // this thread's columns tx, tx + 16, ... in order: the first minimum
      float best = CUDART_INF_F;
      int arg = -1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        if (col < c_rows) {
          const float s = __fsub_rn(norm[j], __fmul_rn(2.0f, acc[i][j]));
          if (arg < 0 || s < best) {
            best = s;
            arg = c0 + col;
          }
        }
      }
      if (arg < 0) arg = INT_MAX;   // no column of this thread in the tile
      // the row's 16 threads (one half-warp): min by (value, index)
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best, o);
        const int oi = __shfl_xor_sync(0xffffffffu, arg, o);
        if (before(ov, oi, best, arg)) {
          best = ov;
          arg = oi;
        }
      }
      // a later tile replaces the running pair only when strictly smaller
      if (best < run_v[i]) {
        run_v[i] = best;
        run_i[i] = arg;
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      if (r < rows) {
        out_v[r0 + r] = run_v[i];
        out_i[r0 + r] = run_i[i];
      }
    }
  }
}

}  // namespace

// x [n, d], centers [n_centers, d], cc [n_centers] f32 (cc: |c|^2, or +inf
// for a center that must never win); outputs [n] f32 and int32.
extern "C" int rt_fused_argmin(const float* x, const float* centers, const float* cc, int n,
                               int n_centers, int d, float* out_v, int* out_i, void* stream) {
  if (n_centers < 1 || d < 1 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int blocks = (n + rt::kBM - 1) / rt::kBM;
  fused_argmin_kernel<<<blocks, rt::kGemmThreads, 0, (cudaStream_t)stream>>>(
      x, centers, cc, n, n_centers, d, out_v, out_i);
  return (int)cudaGetLastError();
}
