// A 64 x 64 f32 score tile, A rows against B rows, for 256 threads: the
// matrix product inside the probe-major IVF scan.  At the end, the
// row-major stages that fused_knn.cu and fused_argmin.cu load by cp.async
// and read as float4.
//
// Every dot product is ONE f32 accumulator updated by fmaf in dimension
// order 0, 1, ..., d-1.  The plain PyTorch versions accumulate in the same
// order (toolkit.sequential_dot), which keeps the kernels within a few ulps
// of them: distances here are differences of terms near |x|^2, so a change
// of summation order alone would move them by more than the stated
// tolerance.  No TF32, no tensor cores: the slice scores at full f32, as
// raft_tpu does with Precision.HIGHEST.
//
// B may be stored as f32, bf16, int8 or uint8 (upcast exactly on load), at a stride
// (tile_gemm) or one address per row (tile_gemm_rows: the rows of a paged
// list, scattered over pages).  With kBf16 both
// operands are rounded to bf16 (round to nearest even, as astype(bfloat16))
// before the product: raft_tpu's lut_dtype="bfloat16" leg.  A product of two
// bf16 values is exact in f32, so fmaf then adds exactly what the plain
// version's mul-then-add adds.
//
// Thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16 i and columns
// tx + 16 j, i, j < 4.  Operands stage through shared memory in chunks of
// kBK dimensions, transposed and padded by one word so that neither the
// stores nor the reads conflict on banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kGemmThreads = 256;

struct GemmSmem {
  float a[kBK][kBM + 1];
  float b[kBK][kBN + 1];
};

__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
// 8-bit rows of raw values (IVF-Flat over an 8-bit dataset): exact in f32
__device__ __forceinline__ float as_f32(int8_t v) { return (float)v; }
__device__ __forceinline__ float as_f32(uint8_t v) { return (float)v; }

// f32 -> bf16 -> f32, round to nearest even
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Load a [rows x kBK] chunk starting at dimension k0 into dst[kk][r]
// (zeros past `rows` and past `d`), rounded to bf16 when kRound.
template <typename T, bool kRound>
__device__ __forceinline__ void load_chunk(float (*dst)[kBM + 1], const T* src,
                                           int rows, int ld, int d, int k0,
                                           int tid) {
#pragma unroll
  for (int s = 0; s < (kBM * kBK) / kGemmThreads; ++s) {
    const int idx = tid + s * kGemmThreads;
    const int r = idx / kBK;
    const int kk = idx % kBK;
    const int k = k0 + kk;
    const float v = (r < rows && k < d) ? as_f32(src[(size_t)r * ld + k]) : 0.0f;
    dst[kk][r] = kRound ? round_bf16(v) : v;
  }
}

// The value lane j of the warp holds in `mine`: a tile's translated row
// indices are passed across the warp by shuffle, one a lane.  Indices, not
// pointers, so that the loads stay reads of the kernel's read-only rows
// (__ldg).
__device__ __forceinline__ size_t lane_value(size_t mine, int j) {
  return __shfl_sync(0xffffffffu, (unsigned long long)mine, j);
}

// load_chunk for B rows held one index per row: row r starts at base + r'
// d, where lane j < 8 of warp w holds in `mine` the index r' of the tile's
// row 8 w + j; warp w loads rows 8 w .. 8 w + 7, one a step, kBK
// dimensions across its lanes.
template <typename T, bool kRound>
__device__ __forceinline__ void load_chunk_rows(float (*dst)[kBM + 1], const T* __restrict__ base,
                                                size_t mine, int rows, int d, int k0, int tid) {
  static_assert(kBN == 8 * (kGemmThreads / 32) && kBK == 32, "eight rows a warp, a lane a dim");
  const int lane = tid % 32;
  const int r0 = 8 * (tid / 32);
  const int k = k0 + lane;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const size_t row = lane_value(mine, j);
    const float v = (r0 + j < rows && k < d) ? as_f32(__ldg(base + row * d + k)) : 0.0f;
    dst[lane][r0 + j] = kRound ? round_bf16(v) : v;
  }
}

// acc[i][j] = dot(A[ty + 16 i], B[tx + 16 j]) over d dimensions, each chunk
// staged by load(k0).
template <typename Load>
__device__ __forceinline__ void tile_gemm_with(Load&& load, int d, GemmSmem& sm,
                                               float acc[4][4]) {
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < d; k0 += kBK) {
    __syncthreads();
    load(k0);
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

// The product with B rows at stride ldb.
template <typename TB, bool kBf16 = false>
__device__ __forceinline__ void tile_gemm(const float* A, int a_rows, int lda,
                                          const TB* B, int b_rows, int ldb,
                                          int d, GemmSmem& sm, float acc[4][4]) {
  tile_gemm_with([&](int k0) {
    load_chunk<float, kBf16>(sm.a, A, a_rows, lda, d, k0, threadIdx.x);
    load_chunk<TB, kBf16>(sm.b, B, b_rows, ldb, d, k0, threadIdx.x);
  }, d, sm, acc);
}

// The product with B rows one index per row (load_chunk_rows's `base`
// and `mine`).
template <typename TB, bool kBf16 = false>
__device__ __forceinline__ void tile_gemm_rows(const float* A, int a_rows, int lda,
                                               const TB* __restrict__ base, size_t mine,
                                               int b_rows, int d, GemmSmem& sm,
                                               float acc[4][4]) {
  tile_gemm_with([&](int k0) {
    load_chunk<float, kBf16>(sm.a, A, a_rows, lda, d, k0, threadIdx.x);
    load_chunk_rows<TB, kBf16>(sm.b, base, mine, b_rows, d, k0, threadIdx.x);
  }, d, sm, acc);
}

// -- row-major stages, loaded by cp.async ------------------------------------
// A stage: dimensions k0 .. k0 + 31 of kRows A rows and of kRows B rows,
// row-major, each row padded to kRow floats: 16-byte aligned for float4
// reads along the dimensions, and the rows tx + 16 j a warp reads at once
// fall on distinct bank groups.  (The transposed, one-float-a-read layout
// above made shared-memory reads, 8 per 16 FMAs, the bound of fused_knn.)
constexpr int kRow = kBK + 4;

template <int kRows>
struct Stage {
  float a[kRows][kRow];
  float b[kRows][kRow];
};

// cp.async of `bytes` (4: 0 or 4; 16: 0 .. 16) of src; the rest of the
// slot is filled with zero.
template <int kSize>
__device__ __forceinline__ void cp_async(float* dst, const float* src, int bytes) {
  const unsigned saddr = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (kSize == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr), "l"(src),
                 "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(saddr), "l"(src),
                 "r"(bytes));
}

// The widest copy a row array admits: 16 bytes when every row starts
// 16-byte aligned (row bytes a multiple of 16 and the array aligned), 4
// when 4-byte aligned, else 1.
__host__ __device__ inline int stage_vec(const void* base, size_t row_bytes) {
  const size_t a = (size_t)base;
  if (row_bytes % 16 == 0 && a % 16 == 0) return 16;
  if (row_bytes % 4 == 0 && a % 4 == 0) return 4;
  return 1;
}

// Bytes off .. off + 15 of a row of rb bytes (nullptr: zeros) by byte loads,
// stored at once: rows of no 4-byte alignment, kept out of line so that the
// loaders' common paths stay small.
static __device__ __noinline__ void stage16_bytes(unsigned char* dst, const unsigned char* row,
                                                  int off, int rb) {
  union {
    uint4 w;
    unsigned char b[16];
  } u;
#pragma unroll
  for (int j = 0; j < 16; ++j) u.b[j] = (row != nullptr && off + j < rb) ? row[off + j] : 0;
  *reinterpret_cast<uint4*>(dst) = u.w;
}

// Stage bytes off .. off + 15 of a row of rb bytes at `row` (nullptr: a row
// not read) into 16-byte aligned shared memory, zeros past the row: one
// cp.async at vec 16, four at vec 4 (both complete at the caller's
// cp.async wait), or byte loads at vec 1, stored at once.  `any`: a valid
// global address of the array, read by no copy.
__device__ __forceinline__ void stage16(unsigned char* dst, const unsigned char* row, int off,
                                        int rb, int vec, const void* any) {
  if (vec == 16) {
    const bool ok = row != nullptr && off < rb;
    cp_async<16>(reinterpret_cast<float*>(dst),
                 static_cast<const float*>(ok ? static_cast<const void*>(row + off) : any),
                 ok ? 16 : 0);
  } else if (vec == 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = off + 4 * j;
      const bool ok = row != nullptr && o < rb;
      cp_async<4>(reinterpret_cast<float*>(dst + 4 * j),
                  static_cast<const float*>(ok ? static_cast<const void*>(row + o) : any),
                  ok ? 4 : 0);
    }
  } else {
    stage16_bytes(dst, row, off, rb);
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Stage dimensions k0 .. k0 + 31 of the A rows at qa (a_rows of them) and
// of the B rows at xb (b_rows), zeros past the rows and past d, and commit
// them as one group: four dimensions a copy where rows are 16-byte aligned
// (kVec), else one.  Every thread of the kGemmThreads calls it.
template <bool kVec, int kRows>
__device__ __forceinline__ void issue_chunk(Stage<kRows>& st, const float* qa, int a_rows,
                                            const float* xb, int b_rows, int d, int k0,
                                            int tid) {
  constexpr int kPer = kVec ? 4 : 1;   // dimensions a copy
  constexpr int kCopies = kBK / kPer;
#pragma unroll
  for (int s = 0; s < (kRows * kCopies) / kGemmThreads; ++s) {
    const int idx = tid + s * kGemmThreads;
    const int r = idx / kCopies;
    const int kk = kPer * (idx % kCopies);
    const int k = k0 + kk;
    const int bytes = k < d ? 4 * min(kPer, d - k) : 0;
    const int ba = r < a_rows ? bytes : 0;
    const int bb = r < b_rows ? bytes : 0;
    cp_async<4 * kPer>(&st.a[r][kk], ba ? qa + (size_t)r * d + k : qa, ba);
    cp_async<4 * kPer>(&st.b[r][kk], bb ? xb + (size_t)r * d + k : xb, bb);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

}  // namespace rt
