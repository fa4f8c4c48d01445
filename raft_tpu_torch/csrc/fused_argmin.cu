// Fused L2 1-NN assignment: for each row of x the smallest partial score
// cc[j] - 2 x.c_j over the centers, and its argmin; the [n, n_centers]
// score matrix never reaches device memory.
//
// Replaces raft_tpu/kernels/fused_argmin.py fused_l2_argmin /
// _fused_argmin_kernel.  No |x|^2 term and no clamp: the same function as
// the TPU kernel (add |x|^2 for the true squared distance; the ranking is
// the same).  Ties go to the lowest index among the minima, as the TPU
// kernel's running argmin over its (row tile 512, center tile 128) grid
// gives.  A row whose every score is +inf keeps (+inf, 0), as the TPU
// kernel's initial block.
//
// What bounds it on the H100: 2 d flops per (row, center) pair against one
// read of x and of the centers, so at n_centers ~ 10^3 it is bound by the
// f32 FMA rate (no tensor cores: raft_tpu scores at Precision.HIGHEST, and
// the kernel must stay bitwise to its plain version).  The design keeps
// the FMA pipes fed: a 128 x 128 block tile, an 8 x 8 register tile a
// thread (rows ty + 16 i, centers tx + 16 j), operands read from
// row-major stages as float4 (16 loads of 16 B per 256 FMAs: four
// dimensions of eight rows and of eight centers), the x and center chunks
// staged by cp.async two stages deep (tile_gemm.cuh's Stage /
// issue_chunk, as fused_knn.cu), so that the next chunk loads while this
// one is multiplied.  Each dot product is one fmaf chain in dimension
// order (toolkit.sequential_dot's order), the score rounds where the plain
// version's tensor ops round (__fsub_rn(cc, 2 dot)), and each thread keeps
// a running (min, argmin) per row over its own centers, taken in
// ascending order; the 16 threads of a row then take the min by (value,
// index), a total order, so the tile shape does not change the result.
// The running pairs live in shared memory, one slot per (row, thread):
// in registers, beside the 64 accumulators and 8 float4 operands, they
// pushed the kernel past 128 registers into spills and cost 17 % at 1M
// rows (7.83 against 6.71 ms on an H100, kernel_ab.py; PERF.md, Findings).
//
// Whole waves: a batch of few row tiles (8,192 rows: 64 of them, on a card
// that holds 264 blocks) cuts the centers into contiguous parts, one grid
// column each (kernels/fused_argmin.py picks them as fused_knn's parts);
// each part writes its (min, argmin) per row, and a second pass takes the
// min over the parts by (value, index).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "tile_gemm.cuh"

namespace {

constexpr int kTile = 128;   // rows and centers of a block tile
constexpr int kT = kTile / 16;   // rows (and centers) of a thread
using Stage = rt::Stage<kTile>;
constexpr size_t kSmem = 2 * sizeof(Stage);   // two stages: past 48 KB, opted in

// (v, i) beats (w, j) when smaller, or equal with the lower index
__device__ __forceinline__ bool before(float v, int i, float w, int j) {
  return v < w || (v == w && i < j);
}

// Block (blockIdx.x, part blockIdx.y): rows r0 .. r0 + 127 against the
// centers [part c_chunk, (part + 1) c_chunk); writes each row's pair to
// out_v / out_i [n][gridDim.y].
template <bool kVec>
__global__ void __launch_bounds__(rt::kGemmThreads, 2)
fused_argmin_kernel(const float* __restrict__ x, const float* __restrict__ c,
                    const float* __restrict__ cc, int n, int n_centers, int d, int c_chunk,
                    float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ float4 smem4[];
  Stage* st = reinterpret_cast<Stage*>(smem4);
  __shared__ float srun_v[kT][rt::kGemmThreads];
  __shared__ int srun_i[kT][rt::kGemmThreads];
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int r0 = blockIdx.x * kTile;
  const int rows = min(kTile, n - r0);
  const float* xa = x + (size_t)r0 * d;
  const int c_begin = blockIdx.y * c_chunk;
  const int c_end = min(n_centers, c_begin + c_chunk);

#pragma unroll
  for (int i = 0; i < kT; ++i) {
    srun_v[i][tid] = CUDART_INF_F;
    srun_i[i][tid] = 0;
  }
  const int nchunks = (d + rt::kBK - 1) / rt::kBK;
  const int tiles = (c_end - c_begin + kTile - 1) / kTile;
  const int total = tiles * nchunks;
  rt::issue_chunk<kVec>(st[0], xa, rows, c + (size_t)c_begin * d, min(kTile, c_end - c_begin),
                        d, 0, tid);
  int g = 0;
  for (int t = 0; t < tiles; ++t) {
    const int c0 = c_begin + t * kTile;
    const int c_rows = min(kTile, c_end - c0);
    float acc[kT][kT];
#pragma unroll
    for (int i = 0; i < kT; ++i)
#pragma unroll
      for (int j = 0; j < kT; ++j) acc[i][j] = 0.0f;
    for (int ch = 0; ch < nchunks; ++ch, ++g) {
      if (g + 1 < total) {   // the next chunk, the next tile's first after the last
        const int c1 = c_begin + (g + 1) / nchunks * kTile;
        rt::issue_chunk<kVec>(st[(g + 1) & 1], xa, rows, c + (size_t)c1 * d,
                              min(kTile, c_end - c1), d, ((g + 1) % nchunks) * rt::kBK, tid);
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::);
      }
      __syncthreads();
      const Stage& sm = st[g & 1];
      const int kn = min(rt::kBK, d - ch * rt::kBK);
      int kk = 0;
      for (; kk + 4 <= kn; kk += 4) {   // four dimensions, in order, per pair
        float4 av[kT];
#pragma unroll
        for (int i = 0; i < kT; ++i)
          av[i] = *reinterpret_cast<const float4*>(&sm.a[ty + 16 * i][kk]);
#pragma unroll
        for (int j = 0; j < kT; ++j) {
          const float4 bv = *reinterpret_cast<const float4*>(&sm.b[tx + 16 * j][kk]);
#pragma unroll
          for (int i = 0; i < kT; ++i) {
            acc[i][j] = fmaf(av[i].x, bv.x, acc[i][j]);
            acc[i][j] = fmaf(av[i].y, bv.y, acc[i][j]);
            acc[i][j] = fmaf(av[i].z, bv.z, acc[i][j]);
            acc[i][j] = fmaf(av[i].w, bv.w, acc[i][j]);
          }
        }
      }
      for (; kk < kn; ++kk) {
        float av[kT];
#pragma unroll
        for (int i = 0; i < kT; ++i) av[i] = sm.a[ty + 16 * i][kk];
#pragma unroll
        for (int j = 0; j < kT; ++j) {
          const float bv = sm.b[tx + 16 * j][kk];
#pragma unroll
          for (int i = 0; i < kT; ++i) acc[i][j] = fmaf(av[i], bv, acc[i][j]);
        }
      }
      __syncthreads();
    }
    // this thread's centers tx + 16 j in ascending order: a later one
    // replaces the running pair only when strictly smaller (a center past
    // the part scores +inf and never does)
    float norm[kT];
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      const int col = tx + 16 * j;
      norm[j] = col < c_rows ? cc[c0 + col] : CUDART_INF_F;
    }
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      float rv = srun_v[i][tid];
      int ri = srun_i[i][tid];
#pragma unroll
      for (int j = 0; j < kT; ++j) {
        const float s = __fsub_rn(norm[j], __fmul_rn(2.0f, acc[i][j]));
        if (s < rv) {
          rv = s;
          ri = c0 + tx + 16 * j;
        }
      }
      srun_v[i][tid] = rv;
      srun_i[i][tid] = ri;
    }
  }
  const int parts = gridDim.y;
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    // the row's 16 threads (one half-warp): min by (value, index)
    float best = srun_v[i][tid];
    int arg = srun_i[i][tid];
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, arg, o);
      if (before(ov, oi, best, arg)) {
        best = ov;
        arg = oi;
      }
    }
    const int r = ty + 16 * i;
    if (tx == 0 && r < rows) {
      out_v[(size_t)(r0 + r) * parts + blockIdx.y] = best;
      out_i[(size_t)(r0 + r) * parts + blockIdx.y] = arg;
    }
  }
}

// The min by (value, index) of each row's part pairs [n][parts].
__global__ void argmin_parts_kernel(const float* __restrict__ part_v,
                                    const int* __restrict__ part_i, int n, int parts,
                                    float* __restrict__ out_v, int* __restrict__ out_i) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float best = part_v[(size_t)r * parts];
  int arg = part_i[(size_t)r * parts];
  for (int p = 1; p < parts; ++p) {
    const float v = part_v[(size_t)r * parts + p];
    const int i = part_i[(size_t)r * parts + p];
    if (before(v, i, best, arg)) {
      best = v;
      arg = i;
    }
  }
  out_v[r] = best;
  out_i[r] = arg;
}

}  // namespace

// x [n, d], centers [n_centers, d], cc [n_centers] f32 (cc: |c|^2, or +inf
// for a center that must never win); outputs [n] f32 and int32.  The
// centers are cut into parts of c_chunk (a multiple of 128) centers, one
// grid column each; with more than one part, part_v / part_i [n][parts]
// hold each part's pairs, folded by a second pass.
extern "C" int rt_fused_argmin(const float* x, const float* centers, const float* cc, int n,
                               int n_centers, int d, int c_chunk, float* part_v, int* part_i,
                               float* out_v, int* out_i, void* stream) {
  if (n_centers < 1 || d < 1 || n < 0 || c_chunk < 1 || c_chunk % kTile != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  auto s = (cudaStream_t)stream;
  const int parts = (n_centers + c_chunk - 1) / c_chunk;
  if (parts > 1 && (part_v == nullptr || part_i == nullptr)) return (int)cudaErrorInvalidValue;
  // rows 16-byte aligned: four dimensions a copy
  const bool vec = d % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)centers % 16 == 0;
  auto kernel = vec ? fused_argmin_kernel<true> : fused_argmin_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kTile - 1) / kTile, parts);
  kernel<<<grid, rt::kGemmThreads, kSmem, s>>>(x, centers, cc, n, n_centers, d, c_chunk,
                                               parts > 1 ? part_v : out_v,
                                               parts > 1 ? part_i : out_i);
  err = cudaGetLastError();
  if (err != cudaSuccess || parts == 1) return (int)err;
  argmin_parts_kernel<<<(n + 255) / 256, 256, 0, s>>>(part_v, part_i, n, parts, out_v, out_i);
  return (int)cudaGetLastError();
}
