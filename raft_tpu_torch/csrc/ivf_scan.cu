// IVF list scans, unfiltered: score stored rows against queries and keep
// each query's top-kk by (score, position).
//
// ivf_scan_probe_major replaces raft_tpu/kernels/ivf_scan.py
// ivf_scan_probe_major / _scan_kernel (unfiltered legs).  One bucket is one
// list and up to G queries that probe it; position = slot in the list.
// ivf_scan_query_major replaces ivf_scan_query_major / _scan_qm_kernel
// (unfiltered legs).  One query streams its P probed lists; position =
// p * cap + slot, so the lists are walked in probe order.
//
// Each schedule has one C entry per storage type (_score_against_list's
// legs), each with its own launch count in the wrapper:
//  - f32 rows (IVF-Flat, IVF-PQ decoded_dtype="float32");
//  - bf16 rows (IVF-PQ's default scan cache), upcast exactly on load;
//  - int8 rows (IVF-PQ's memory-lean cache).  Each query is quantised in the
//    kernel, sq = max(max|q| / 127, 1e-12), q_i8 = clip(rint(q / sq), -127,
//    127), as toolkit.quantize_queries_i8; int8 x int8 products sum in int32
//    by __dp4a (exact in any order) and ip = (float)sum * (sq * scan_scale).
// The float legs take bf16_compute (lut_dtype="bfloat16"): both operands
// are rounded to bf16 and their exact products summed in f32.  Otherwise
// each dot product is one f32 accumulator, fmaf in dimension order.
//
// Scores (as _score_against_list): l2 (y2 - 2 ip) + q2; ip -ip; cosine
// 1 - ip * rsqrt(max(q2, 1e-24)) * rsqrt(max(y2, 1e-24)).  q2 is |q|^2 of
// the unquantised query.  A slot whose id is negative, or a query whose q2
// is +inf (padding), scores +inf; a +inf score never enters the list, so
// its output id is -1.
//
// What bounds them on the H100.  Probe-major reuses each streamed list
// across the bucket's queries (G ~ 256 at 10^4 queries), so it is bound by
// arithmetic: f32 FMA for f32 compute, the bf16 or int8 tensor-core rate
// for the other legs, which these simple kernels do not use (CUDA-core
// fmaf / __dp4a on a 64 x 64 register tile, tile_gemm.cuh); tiles whose
// slots are all padding are skipped, and blocks whose queries are all
// padding exit at once.  Query-major reads P * cap rows for each query with
// no reuse, so it is bound by device memory bytes: rows stage through
// shared memory at their stored width (f32, bf16, or int8 packed four to a
// word) with coalesced loads, one thread scores one row with a single
// accumulator, and warp 0 folds the 256 scores of a tile into the list
// (topk.cuh).  A small batch splits each query's probes over several blocks
// and merges their lists.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "tile_gemm.cuh"
#include "topk.cuh"

namespace {

enum Metric { kL2 = 0, kIp = 1, kCosine = 2 };

__device__ __forceinline__ float score(int metric, float ip, float q2, float y2) {
  // explicit _rn operations: no contraction into an fma, so each step
  // rounds where the plain version's separate tensor operations do
  if (metric == kIp) return -ip;
  if (metric == kCosine)
    return __fsub_rn(1.0f, __fmul_rn(__fmul_rn(ip, rsqrtf(fmaxf(q2, 1e-24f))),
                                     rsqrtf(fmaxf(y2, 1e-24f))));
  return __fadd_rn(__fsub_rn(y2, __fmul_rn(2.0f, ip)), q2);
}

// -- int8 helpers ---------------------------------------------------------

// The scale of one query: max(max|q| / 127, 1e-12) (IEEE division: the
// library builds without --use_fast_math).
__device__ __forceinline__ float query_scale(float amax) {
  return fmaxf(__fdiv_rn(amax, 127.0f), 1e-12f);
}

// Dimensions 4w .. 4w+3 of a query, quantised and packed into one word
// (zeros past d).
__device__ __forceinline__ int quantize_word(const float* qrow, int d, int w, float sq) {
  unsigned word = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = 4 * w + j;
    if (k < d) {
      const float v = fminf(fmaxf(rintf(__fdiv_rn(qrow[k], sq)), -127.0f), 127.0f);
      word |= ((unsigned)(int)v & 0xffu) << (8 * j);
    }
  }
  return (int)word;
}

// Dimensions 4w .. 4w+3 of a stored int8 row packed into one word (zeros
// past d, or everywhere when !valid).  A word load when rows are 4-byte
// aligned (d % 4 == 0), bytes otherwise.
__device__ __forceinline__ int load_word(const int8_t* row, bool valid, int d, int w) {
  const int k = 4 * w;
  if (!valid || k >= d) return 0;
  if ((d & 3) == 0) return *reinterpret_cast<const int*>(row + k);
  unsigned word = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (k + j < d) word |= (unsigned)(uint8_t)row[k + j] << (8 * j);
  return (int)word;
}

// Warp `lane`s quantise query row `qrow` (nullptr: a padding row) into
// word column `col` of a [d4][stride] word array; returns sq on every lane.
__device__ __forceinline__ float quantize_row(const float* qrow, int d, int* words,
                                              int stride, int col, int lane) {
  float amax = 0.0f;
  if (qrow != nullptr)
    for (int k = lane; k < d; k += 32) amax = fmaxf(amax, fabsf(qrow[k]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(rt::kFull, amax, o));
  const float sq = query_scale(amax);
  const int d4 = (d + 3) / 4;
  for (int w = lane; w < d4; w += 32)
    words[w * stride + col] = qrow != nullptr ? quantize_word(qrow, d, w, sq) : 0;
  return sq;
}

// -- probe-major ----------------------------------------------------------

// Walk bucket blockIdx.x's list in kBN-slot tiles for the block's kBM
// queries (blockIdx.y): score, mask and fold each tile into the queries'
// lists lv / li ([kBM][kk], shared), then write the lists out.  A block
// whose queries are all padding skips the walk, and a tile whose slots are
// all padding is skipped.  The leg's own parts: `prologue()` runs once
// before the walk of a live block; `tile_ip(l, c0, c_rows, ip)` sets
// ip[i][j] to the dot product of the block's query ty + 16 i with slot
// c0 + tx + 16 j of list l.  Every thread calls both.
template <typename Prologue, typename TileIp>
__device__ __forceinline__ void pm_walk(const int* __restrict__ bucket_list,
                                        const float* __restrict__ q2g,
                                        const float* __restrict__ y2,
                                        const int* __restrict__ ids, int G, int cap, int kk,
                                        int metric, float* lv, int* li,
                                        float* __restrict__ out_v, int* __restrict__ out_i,
                                        Prologue&& prologue, TileIp&& tile_ip) {
  __shared__ float s[rt::kBM][rt::kBN + 1];
  __shared__ float sq2[rt::kBM];
  __shared__ float sy2[rt::kBN];
  __shared__ int sid[rt::kBN];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int b = blockIdx.x;
  const int g0 = blockIdx.y * rt::kBM;
  const int q_rows = min(rt::kBM, G - g0);
  const size_t out_base = ((size_t)b * G + g0) * kk;

  bool live = false;
  if (tid < rt::kBM) {
    const float v = tid < q_rows ? q2g[(size_t)b * G + g0 + tid] : CUDART_INF_F;
    sq2[tid] = v;
    live = !isinf(v);
  }
  for (int m = warp; m < rt::kBM; m += rt::kGemmThreads / 32)
    rt::list_init(lv + m * kk, li + m * kk, kk, lane);
  if (__syncthreads_or(live)) {
    prologue();
    const int l = bucket_list[b];
    float ip[4][4];
    for (int c0 = 0; c0 < cap; c0 += rt::kBN) {
      const int c_rows = min(rt::kBN, cap - c0);
      bool valid = false;
      if (tid < rt::kBN) {
        const int id = tid < c_rows ? ids[(size_t)l * cap + c0 + tid] : -1;
        sid[tid] = id;
        sy2[tid] = tid < c_rows ? y2[(size_t)l * cap + c0 + tid] : 0.0f;
        valid = id >= 0;
      }
      if (!__syncthreads_or(valid)) continue;
      tile_ip(l, c0, c_rows, ip);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = ty + 16 * i;
          const float q2 = sq2[m];
          const bool bad = sid[c] < 0 || isinf(q2);
          s[m][c] = bad ? CUDART_INF_F : score(metric, ip[i][j], q2, sy2[c]);
        }
      }
      __syncthreads();
      for (int m = warp; m < q_rows; m += rt::kGemmThreads / 32) {
        for (int cc = 0; cc < rt::kBN; cc += 32) {
          const int c = cc + lane;
          rt::list_offer32(s[m][c], sid[c], lv + m * kk, li + m * kk, kk, lane);
        }
      }
      __syncthreads();
    }
  }
  for (int m = warp; m < q_rows; m += rt::kGemmThreads / 32) {
    for (int p = lane; p < kk; p += 32) {
      out_v[out_base + (size_t)m * kk + p] = lv[m * kk + p];
      out_i[out_base + (size_t)m * kk + p] = li[m * kk + p];
    }
  }
}

// Float legs: T = float or __nv_bfloat16 rows; kBf16 = lut_dtype bfloat16.
template <typename T, bool kBf16>
__global__ void __launch_bounds__(rt::kGemmThreads)
probe_major_kernel(const int* __restrict__ bucket_list, const float* __restrict__ qg,
                   const float* __restrict__ q2g, const T* __restrict__ data,
                   const float* __restrict__ y2, const int* __restrict__ ids,
                   int G, int cap, int d, int kk, int metric,
                   float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ unsigned char smem_raw[];
  float* lv = reinterpret_cast<float*>(smem_raw);          // [kBM][kk]
  int* li = reinterpret_cast<int*>(lv + rt::kBM * kk);     // [kBM][kk]
  __shared__ rt::GemmSmem gsm;

  const int g0 = blockIdx.y * rt::kBM;
  const int q_rows = min(rt::kBM, G - g0);
  const float* qa = qg + ((size_t)blockIdx.x * G + g0) * d;
  pm_walk(bucket_list, q2g, y2, ids, G, cap, kk, metric, lv, li, out_v, out_i, [] {},
          [&](int l, int c0, int c_rows, float (&ip)[4][4]) {
            const T* rows = data + ((size_t)l * cap + c0) * d;
            rt::tile_gemm<T, kBf16>(qa, q_rows, d, rows, c_rows, d, d, gsm, ip);
          });
}

constexpr int kWords = rt::kBK / 4;   // int8 words (4 dimensions) per chunk

// int8 leg: the block's queries are quantised once into shared memory as a
// transposed [d4][kBM + 1] word array; rows stage kWords words at a time.
__global__ void __launch_bounds__(rt::kGemmThreads)
probe_major_i8_kernel(const int* __restrict__ bucket_list, const float* __restrict__ qg,
                      const float* __restrict__ q2g, const int8_t* __restrict__ data,
                      const float* __restrict__ y2, const int* __restrict__ ids,
                      int G, int cap, int d, int kk, int metric, float scan_scale,
                      float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ unsigned char smem_raw[];
  float* lv = reinterpret_cast<float*>(smem_raw);          // [kBM][kk]
  int* li = reinterpret_cast<int*>(lv + rt::kBM * kk);     // [kBM][kk]
  int* qw = li + rt::kBM * kk;                              // [d4][kBM + 1]
  __shared__ int sb[kWords][rt::kBN + 1];
  __shared__ float srescale[rt::kBM];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int g0 = blockIdx.y * rt::kBM;
  const int q_rows = min(rt::kBM, G - g0);
  const int d4 = (d + 3) / 4;
  constexpr int kStride = rt::kBM + 1;

  pm_walk(bucket_list, q2g, y2, ids, G, cap, kk, metric, lv, li, out_v, out_i,
          [&] {
            for (int m = warp; m < rt::kBM; m += rt::kGemmThreads / 32) {
              const float* qrow =
                  m < q_rows ? qg + ((size_t)blockIdx.x * G + g0 + m) * d : nullptr;
              const float sq = quantize_row(qrow, d, qw, kStride, m, lane);
              if (lane == 0) srescale[m] = __fmul_rn(sq, scan_scale);
            }
          },
          [&](int l, int c0, int c_rows, float (&ip)[4][4]) {
            const int8_t* rows = data + ((size_t)l * cap + c0) * d;
            int acc[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][j] = 0;
            for (int w0 = 0; w0 < d4; w0 += kWords) {
              __syncthreads();
#pragma unroll
              for (int t = 0; t < (rt::kBN * kWords) / rt::kGemmThreads; ++t) {
                const int idx = tid + t * rt::kGemmThreads;
                const int r = idx / kWords;
                const int w = idx % kWords;
                sb[w][r] = load_word(rows + (size_t)r * d, r < c_rows, d, w0 + w);
              }
              __syncthreads();
              const int wn = min(kWords, d4 - w0);
              for (int w = 0; w < wn; ++w) {
                int av[4], bv[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) av[i] = qw[(w0 + w) * kStride + ty + 16 * i];
#pragma unroll
                for (int j = 0; j < 4; ++j) bv[j] = sb[w][tx + 16 * j];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                  for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
              }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                ip[i][j] = __fmul_rn((float)acc[i][j], srescale[ty + 16 * i]);
          });
}

// -- query-major ----------------------------------------------------------

constexpr int kQmRows = 256;   // rows scored per tile, one per thread
constexpr int kQmBK = 32;      // dimensions staged per chunk
constexpr int kQmWords = kQmBK / 4;

// Staged row tile of one storage type, row stride padded to an odd number
// of words so that thread t reading row t hits its own bank.
template <typename T> struct QmTile;
template <> struct QmTile<float> { float x[kQmRows][kQmBK + 1]; };
template <> struct QmTile<__nv_bfloat16> { __nv_bfloat16 x[kQmRows][kQmBK + 2]; };

// Walk the block's part of the query's pool, probes [p_begin, p_end), in
// 256-row tiles: score, mask and fold each tile.  `tile_ip(l, c0, c_rows)`
// is the leg's own part: it stages the tile's rows of list l and returns
// this thread's dot product with row c0 + tid.  Every thread calls it.
template <typename ScoreTile>
__device__ __forceinline__ void qm_walk(const int* __restrict__ probes, const float* __restrict__ y2,
                                        const int* __restrict__ ids, int qi, int P, int cap,
                                        int p_begin, int p_end, float q2, int metric, int kk,
                                        float* lv, int* li, float* sv, int* sid,
                                        ScoreTile&& tile_ip) {
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  for (int p = p_begin; p < p_end; ++p) {
    const int l = probes[(size_t)qi * P + p];
    for (int c0 = 0; c0 < cap; c0 += kQmRows) {
      const int c_rows = min(kQmRows, cap - c0);
      const int id = tid < c_rows ? ids[(size_t)l * cap + c0 + tid] : -1;
      if (!__syncthreads_or(id >= 0)) continue;
      const float ip = tile_ip(l, c0, c_rows);
      const float y = tid < c_rows ? y2[(size_t)l * cap + c0 + tid] : 0.0f;
      sv[tid] = id < 0 ? CUDART_INF_F : score(metric, ip, q2, y);
      sid[tid] = id;
      __syncthreads();
      if (tid < 32) rt::list_offer_row(sv, sid, c_rows, lv, li, kk, lane);
    }
  }
}

__device__ __forceinline__ void qm_write(const float* lv, const int* li, int qi, int kk,
                                         float* __restrict__ out_v, int* __restrict__ out_i) {
  __syncthreads();
  const size_t out_base = (size_t)qi * gridDim.y * kk + (size_t)blockIdx.y * kk;
  for (int p = threadIdx.x; p < kk; p += kQmRows) {
    out_v[out_base + p] = lv[p];
    out_i[out_base + p] = li[p];
  }
}

// Float legs: T = float or __nv_bfloat16 rows; kBf16 = lut_dtype bfloat16.
template <typename T, bool kBf16>
__global__ void __launch_bounds__(kQmRows)
query_major_kernel(const int* __restrict__ probes, const float* __restrict__ q,
                   const float* __restrict__ q2v, const T* __restrict__ data,
                   const float* __restrict__ y2, const int* __restrict__ ids,
                   int P, int cap, int d, int kk, int metric, int p_chunk,
                   float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ unsigned char smem_raw[];
  float* lv = reinterpret_cast<float*>(smem_raw);   // [kk]
  int* li = reinterpret_cast<int*>(lv + kk);        // [kk]
  float* sq = reinterpret_cast<float*>(li + kk);    // [d]
  __shared__ QmTile<T> xs;
  __shared__ float sv[kQmRows];
  __shared__ int sid[kQmRows];

  const int tid = threadIdx.x;
  const int qi = blockIdx.x;
  const float q2 = q2v[qi];

  if (tid < 32) rt::list_init(lv, li, kk, tid);
  for (int k = tid; k < d; k += kQmRows) {
    const float v = q[(size_t)qi * d + k];
    sq[k] = kBf16 ? rt::round_bf16(v) : v;
  }
  __syncthreads();

  const int p_begin = blockIdx.y * p_chunk;
  const int p_end = min(P, p_begin + p_chunk);
  if (!isinf(q2)) {
    qm_walk(probes, y2, ids, qi, P, cap, p_begin, p_end, q2, metric, kk, lv, li, sv, sid,
            [&](int l, int c0, int c_rows) {
              const T* rows = data + ((size_t)l * cap + c0) * d;
              float acc = 0.0f;
              for (int k0 = 0; k0 < d; k0 += kQmBK) {
                __syncthreads();
#pragma unroll 4
                for (int s = 0; s < kQmBK; ++s) {
                  const int idx = tid + s * kQmRows;
                  const int r = idx / kQmBK;
                  const int k2 = idx % kQmBK;
                  const int k = k0 + k2;
                  xs.x[r][k2] = (r < c_rows && k < d) ? rows[(size_t)r * d + k] : T(0.0f);
                }
                __syncthreads();
                const int kn = min(kQmBK, d - k0);
                for (int k2 = 0; k2 < kn; ++k2) {
                  const float y = rt::as_f32(xs.x[tid][k2]);
                  acc = fmaf(sq[k0 + k2], kBf16 ? rt::round_bf16(y) : y, acc);
                }
              }
              return acc;
            });
  }
  qm_write(lv, li, qi, kk, out_v, out_i);
}

// int8 leg: the query is quantised once into shared memory words; rows
// stage as words, kQmWords per row per chunk.
__global__ void __launch_bounds__(kQmRows)
query_major_i8_kernel(const int* __restrict__ probes, const float* __restrict__ q,
                      const float* __restrict__ q2v, const int8_t* __restrict__ data,
                      const float* __restrict__ y2, const int* __restrict__ ids,
                      int P, int cap, int d, int kk, int metric, int p_chunk,
                      float scan_scale, float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ unsigned char smem_raw[];
  float* lv = reinterpret_cast<float*>(smem_raw);   // [kk]
  int* li = reinterpret_cast<int*>(lv + kk);        // [kk]
  int* qw = li + kk;                                // [d4]
  __shared__ int xw[kQmRows][kQmWords + 1];
  __shared__ float sv[kQmRows];
  __shared__ int sid[kQmRows];
  __shared__ float s_rescale;

  const int tid = threadIdx.x;
  const int qi = blockIdx.x;
  const float q2 = q2v[qi];
  const int d4 = (d + 3) / 4;

  if (tid < 32) {
    rt::list_init(lv, li, kk, tid);
    const float sq = quantize_row(q + (size_t)qi * d, d, qw, 1, 0, tid);
    if (tid == 0) s_rescale = __fmul_rn(sq, scan_scale);
  }
  __syncthreads();
  const float rescale = s_rescale;

  const int p_begin = blockIdx.y * p_chunk;
  const int p_end = min(P, p_begin + p_chunk);
  if (!isinf(q2)) {
    qm_walk(probes, y2, ids, qi, P, cap, p_begin, p_end, q2, metric, kk, lv, li, sv, sid,
            [&](int l, int c0, int c_rows) {
              const int8_t* rows = data + ((size_t)l * cap + c0) * d;
              int acc = 0;
              for (int w0 = 0; w0 < d4; w0 += kQmWords) {
                __syncthreads();
#pragma unroll
                for (int s = 0; s < kQmWords; ++s) {
                  const int idx = tid + s * kQmRows;
                  const int r = idx / kQmWords;
                  const int w = idx % kQmWords;
                  xw[r][w] = load_word(rows + (size_t)r * d, r < c_rows, d, w0 + w);
                }
                __syncthreads();
                const int wn = min(kQmWords, d4 - w0);
                for (int w = 0; w < wn; ++w) acc = __dp4a(qw[w0 + w], xw[tid][w], acc);
              }
              return __fmul_rn((float)acc, rescale);
            });
  }
  qm_write(lv, li, qi, kk, out_v, out_i);
}

// -- launchers ------------------------------------------------------------

// dynamic shared memory a launch may ask for: the 227 KB a block can hold,
// less room for the kernels' static tiles
constexpr size_t kMaxDynamicSmem = 179 * 1024;

// A block may hold more than 48 KB of shared memory in all (static tiles
// plus the dynamic lists) only once its kernel opts in to the dynamic part.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t dynamic) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dynamic);
}

bool bad_shape(int kk, int d, int cap, int g) {
  return kk < 1 || kk > rt::kMaxK || d < 1 || cap < 1 || g < 1;
}

template <typename T, bool kBf16>
int launch_probe_major(const int* bl, const float* qg, const float* q2g, const T* data,
                       const float* y2, const int* ids, int B, int G, int cap, int d,
                       int kk, int metric, float* out_v, int* out_i, cudaStream_t stream) {
  if (bad_shape(kk, d, cap, G)) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)rt::kBM * kk * (sizeof(float) + sizeof(int));
  cudaError_t err = allow_smem(probe_major_kernel<T, kBf16>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, (G + rt::kBM - 1) / rt::kBM);
  probe_major_kernel<T, kBf16><<<grid, rt::kGemmThreads, smem, stream>>>(
      bl, qg, q2g, data, y2, ids, G, cap, d, kk, metric, out_v, out_i);
  return (int)cudaGetLastError();
}

// splits > 1 cuts each query's probes into that many contiguous parts, one
// grid column each (so a serving batch of 64 queries still fills the card);
// their lists land in part_v / part_i [Q, splits * kk] and merge_parts
// folds them in probe order.
template <typename Kernel, typename Row, typename... Extra>
int launch_query_major(Kernel kernel, size_t smem, const int* probes, const float* q,
                       const float* q2, const Row* data, const float* y2, const int* ids,
                       int Q, int P, int cap, int d, int kk, int metric, int splits,
                       float* part_v, int* part_i, float* out_v, int* out_i,
                       cudaStream_t stream, Extra... extra) {
  if (bad_shape(kk, d, cap, P) || splits < 1) return (int)cudaErrorInvalidValue;
  if (Q == 0) return (int)cudaSuccess;
  if (smem > kMaxDynamicSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int p_chunk = (P + splits - 1) / splits;
  splits = (P + p_chunk - 1) / p_chunk;
  const bool merge = splits > 1;
  kernel<<<dim3(Q, splits), kQmRows, smem, stream>>>(
      probes, q, q2, data, y2, ids, P, cap, d, kk, metric, p_chunk, extra...,
      merge ? part_v : out_v, merge ? part_i : out_i);
  err = cudaGetLastError();
  if (err != cudaSuccess || !merge) return (int)err;
  return (int)rt::merge_parts(part_v, part_i, Q, splits * kk, kk, out_v, out_i, stream);
}

}  // namespace

// -- C entries: probe-major ----------------------------------------------

extern "C" int rt_ivf_scan_probe_major(const int* bucket_list, const float* qg,
                                       const float* q2g, const float* data,
                                       const float* y2, const int* ids, int B, int G,
                                       int cap, int d, int kk, int metric, int bf16_compute,
                                       float* out_v, int* out_i, void* stream) {
  auto s = (cudaStream_t)stream;
  return bf16_compute
      ? launch_probe_major<float, true>(bucket_list, qg, q2g, data, y2, ids, B, G, cap, d,
                                        kk, metric, out_v, out_i, s)
      : launch_probe_major<float, false>(bucket_list, qg, q2g, data, y2, ids, B, G, cap, d,
                                         kk, metric, out_v, out_i, s);
}

extern "C" int rt_ivf_scan_probe_major_bf16(const int* bucket_list, const float* qg,
                                            const float* q2g, const void* data,
                                            const float* y2, const int* ids, int B, int G,
                                            int cap, int d, int kk, int metric,
                                            int bf16_compute, float* out_v, int* out_i,
                                            void* stream) {
  auto s = (cudaStream_t)stream;
  auto rows = static_cast<const __nv_bfloat16*>(data);
  return bf16_compute
      ? launch_probe_major<__nv_bfloat16, true>(bucket_list, qg, q2g, rows, y2, ids, B, G,
                                                cap, d, kk, metric, out_v, out_i, s)
      : launch_probe_major<__nv_bfloat16, false>(bucket_list, qg, q2g, rows, y2, ids, B, G,
                                                 cap, d, kk, metric, out_v, out_i, s);
}

extern "C" int rt_ivf_scan_probe_major_int8(const int* bucket_list, const float* qg,
                                            const float* q2g, const void* data,
                                            const float* y2, const int* ids, int B, int G,
                                            int cap, int d, int kk, int metric,
                                            float scan_scale, float* out_v, int* out_i,
                                            void* stream) {
  if (bad_shape(kk, d, cap, G)) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)rt::kBM * kk * (sizeof(float) + sizeof(int)) +
                      (size_t)((d + 3) / 4) * (rt::kBM + 1) * sizeof(int);
  if (smem > kMaxDynamicSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(probe_major_i8_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, (G + rt::kBM - 1) / rt::kBM);
  probe_major_i8_kernel<<<grid, rt::kGemmThreads, smem, (cudaStream_t)stream>>>(
      bucket_list, qg, q2g, static_cast<const int8_t*>(data), y2, ids, G, cap, d, kk,
      metric, scan_scale, out_v, out_i);
  return (int)cudaGetLastError();
}

// -- C entries: query-major ----------------------------------------------

extern "C" int rt_ivf_scan_query_major(const int* probes, const float* q, const float* q2,
                                       const float* data, const float* y2, const int* ids,
                                       int Q, int P, int cap, int d, int kk, int metric,
                                       int splits, int bf16_compute, float* part_v,
                                       int* part_i, float* out_v, int* out_i, void* stream) {
  const size_t smem = (size_t)kk * (sizeof(float) + sizeof(int)) + (size_t)d * sizeof(float);
  auto s = (cudaStream_t)stream;
  return bf16_compute
      ? launch_query_major(query_major_kernel<float, true>, smem, probes, q, q2, data, y2,
                           ids, Q, P, cap, d, kk, metric, splits, part_v, part_i, out_v,
                           out_i, s)
      : launch_query_major(query_major_kernel<float, false>, smem, probes, q, q2, data, y2,
                           ids, Q, P, cap, d, kk, metric, splits, part_v, part_i, out_v,
                           out_i, s);
}

extern "C" int rt_ivf_scan_query_major_bf16(const int* probes, const float* q,
                                            const float* q2, const void* data,
                                            const float* y2, const int* ids, int Q, int P,
                                            int cap, int d, int kk, int metric, int splits,
                                            int bf16_compute, float* part_v, int* part_i,
                                            float* out_v, int* out_i, void* stream) {
  const size_t smem = (size_t)kk * (sizeof(float) + sizeof(int)) + (size_t)d * sizeof(float);
  auto s = (cudaStream_t)stream;
  auto rows = static_cast<const __nv_bfloat16*>(data);
  return bf16_compute
      ? launch_query_major(query_major_kernel<__nv_bfloat16, true>, smem, probes, q, q2,
                           rows, y2, ids, Q, P, cap, d, kk, metric, splits, part_v, part_i,
                           out_v, out_i, s)
      : launch_query_major(query_major_kernel<__nv_bfloat16, false>, smem, probes, q, q2,
                           rows, y2, ids, Q, P, cap, d, kk, metric, splits, part_v, part_i,
                           out_v, out_i, s);
}

extern "C" int rt_ivf_scan_query_major_int8(const int* probes, const float* q,
                                            const float* q2, const void* data,
                                            const float* y2, const int* ids, int Q, int P,
                                            int cap, int d, int kk, int metric, int splits,
                                            float scan_scale, float* part_v, int* part_i,
                                            float* out_v, int* out_i, void* stream) {
  const size_t smem = (size_t)kk * (sizeof(float) + sizeof(int)) +
                      (size_t)((d + 3) / 4) * sizeof(int);
  return launch_query_major(query_major_i8_kernel, smem, probes, q, q2,
                            static_cast<const int8_t*>(data), y2, ids, Q, P, cap, d, kk,
                            metric, splits, part_v, part_i, out_v, out_i,
                            (cudaStream_t)stream, scan_scale);
}
