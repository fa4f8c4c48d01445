// A 64 x 64 f32 score tile, A rows against B rows, for 256 threads: the
// matrix product inside the fused brute-force kernel and the probe-major
// IVF scan.
//
// Every dot product is ONE f32 accumulator updated by fmaf in dimension
// order 0, 1, ..., d-1.  The plain PyTorch versions accumulate in the same
// order (toolkit.sequential_dot), which keeps the kernels within a few ulps
// of them: distances here are differences of terms near |x|^2, so a change
// of summation order alone would move them by more than the stated
// tolerance.  No TF32, no tensor cores: the slice scores at full f32, as
// raft_tpu does with Precision.HIGHEST.
//
// Thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16 i and columns
// tx + 16 j, i, j < 4.  Operands stage through shared memory in chunks of
// kBK dimensions, transposed and padded by one word so that neither the
// stores nor the reads conflict on banks.
#pragma once

#include <cuda_runtime.h>

namespace rt {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kGemmThreads = 256;

struct GemmSmem {
  float a[kBK][kBM + 1];
  float b[kBK][kBN + 1];
};

// Load a [rows x kBK] chunk starting at dimension k0 into dst[kk][r]
// (zeros past `rows` and past `d`).
__device__ __forceinline__ void load_chunk(float (*dst)[kBM + 1], const float* src,
                                           int rows, int ld, int d, int k0,
                                           int tid) {
#pragma unroll
  for (int s = 0; s < (kBM * kBK) / kGemmThreads; ++s) {
    const int idx = tid + s * kGemmThreads;
    const int r = idx / kBK;
    const int kk = idx % kBK;
    const int k = k0 + kk;
    dst[kk][r] = (r < rows && k < d) ? src[(size_t)r * ld + k] : 0.0f;
  }
}

// acc[i][j] = dot(A[ty + 16 i], B[tx + 16 j]) over d dimensions.
__device__ __forceinline__ void tile_gemm(const float* A, int a_rows, int lda,
                                          const float* B, int b_rows, int ldb,
                                          int d, GemmSmem& sm, float acc[4][4]) {
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < d; k0 += kBK) {
    __syncthreads();
    load_chunk(sm.a, A, a_rows, lda, d, k0, tid);
    load_chunk(sm.b, B, b_rows, ldb, d, k0, tid);
    __syncthreads();
    const int kn = min(kBK, d - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sm.a[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sm.b[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

}  // namespace rt
