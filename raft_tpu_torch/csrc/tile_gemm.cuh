// Tiled f32 products of the port's kernels: the shapes the score tiles
// share, exact operand conversion, and the row-major stages that
// fused_knn.cu, fused_argmin.cu and the probe-major scan's float legs
// (ivf_scan.cuh) load by cp.async and read as float4.
//
// Every dot product is ONE f32 accumulator updated by fmaf in dimension
// order 0, 1, ..., d-1.  The plain PyTorch versions accumulate in the same
// order (toolkit.sequential_dot), which keeps the kernels bitwise (or within
// a few ulps) of them: distances here are differences of terms near |x|^2,
// so a change of summation order alone would move them by more than the
// stated tolerance.  No TF32, no tensor cores: the slice scores at full
// f32, as raft_tpu does with Precision.HIGHEST.
//
// Rows may be stored as f32, bf16, int8 or uint8 (upcast exactly where they
// are staged).  Under kBf16 both operands are rounded to bf16 (round to
// nearest even, as astype(bfloat16)) before the product: raft_tpu's
// lut_dtype="bfloat16" leg.  A product of two bf16 values is exact in f32,
// so fmaf then adds exactly what the plain version's mul-then-add adds.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kGemmThreads = 256;

__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
// 8-bit rows of raw values (IVF-Flat over an 8-bit dataset): exact in f32
__device__ __forceinline__ float as_f32(int8_t v) { return (float)v; }
__device__ __forceinline__ float as_f32(uint8_t v) { return (float)v; }

// f32 -> bf16 -> f32, round to nearest even
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The value lane j of the warp holds in `mine`: a tile's translated row
// indices are passed across the warp by shuffle, one a lane.  Indices, not
// pointers, so that the loads stay reads of the kernel's read-only rows
// (__ldg).
__device__ __forceinline__ size_t lane_value(size_t mine, int j) {
  return __shfl_sync(0xffffffffu, (unsigned long long)mine, j);
}

// -- row-major stages, loaded by cp.async ------------------------------------
// A stage: dimensions k0 .. k0 + 31 of kRows A rows and of kRows B rows,
// row-major, each row padded to kRow floats: 16-byte aligned for float4
// reads along the dimensions, and the rows tx + 16 j a warp reads at once
// fall on distinct bank groups.  (A transposed, one-float-a-read layout made
// shared-memory reads, 8 per 16 FMAs, the bound of the first products of
// fused_knn and of the probe-major scan.)
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
