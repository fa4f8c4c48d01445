// IVF list scans, f32 storage, unfiltered: score stored rows against
// queries and keep each query's top-kk by (score, position).
//
// ivf_scan_probe_major replaces raft_tpu/kernels/ivf_scan.py
// ivf_scan_probe_major / _scan_kernel (f32 unfiltered leg).  One bucket is
// one list and up to G queries that probe it; position = slot in the list.
// ivf_scan_query_major replaces ivf_scan_query_major / _scan_qm_kernel
// (f32 unfiltered leg).  One query streams its P probed lists; position =
// p * cap + slot, so the lists are walked in probe order.
//
// Scores (as _score_against_list): l2 (y2 - 2 ip) + q2; ip -ip; cosine
// 1 - ip * rsqrt(max(q2, 1e-24)) * rsqrt(max(y2, 1e-24)).  A slot whose id
// is negative, or a query whose q2 is +inf (padding), scores +inf; a +inf
// score never enters the list, so its output id is -1.
//
// What bounds them on the H100.  Probe-major reuses each streamed list
// across the bucket's queries (G ~ 256 at 10^4 queries), so it is bound by
// f32 FMA rate like the brute-force kernel and shares its 64 x 64 register
// tile (tile_gemm.cuh); tiles whose slots are all padding are skipped, and
// blocks whose queries are all padding exit at once.  Query-major reads
// P * cap rows for each query with no reuse, so it is bound by device
// memory bytes: rows stage through shared memory with coalesced loads, one
// thread scores one row with a single sequential accumulator, and warp 0
// folds the 256 scores of a tile into the list (topk.cuh).  A small batch
// splits each query's probes over several blocks and merges their lists.
#include <cuda_runtime.h>
#include <math_constants.h>

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
  return __fadd_rn(__fsub_rn(y2, 2.0f * ip), q2);
}

__global__ void __launch_bounds__(rt::kGemmThreads)
probe_major_kernel(const int* __restrict__ bucket_list, const float* __restrict__ qg,
                   const float* __restrict__ q2g, const float* __restrict__ data,
                   const float* __restrict__ y2, const int* __restrict__ ids,
                   int G, int cap, int d, int kk, int metric,
                   float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ unsigned char smem_raw[];
  float* lv = reinterpret_cast<float*>(smem_raw);          // [kBM][kk]
  int* li = reinterpret_cast<int*>(lv + rt::kBM * kk);     // [kBM][kk]
  __shared__ rt::GemmSmem gsm;
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
    const int l = bucket_list[b];
    const float* qa = qg + ((size_t)b * G + g0) * d;
    const float* rows = data + (size_t)l * cap * d;
    float acc[4][4];
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
      rt::tile_gemm(qa, q_rows, d, rows + (size_t)c0 * d, c_rows, d, d, gsm, acc);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = ty + 16 * i;
          const float q2 = sq2[m];
          const bool bad = sid[c] < 0 || isinf(q2);
          s[m][c] = bad ? CUDART_INF_F : score(metric, acc[i][j], q2, sy2[c]);
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

constexpr int kQmRows = 256;   // rows scored per tile, one per thread
constexpr int kQmBK = 32;      // dimensions staged per chunk

__global__ void __launch_bounds__(kQmRows)
query_major_kernel(const int* __restrict__ probes, const float* __restrict__ q,
                   const float* __restrict__ q2v, const float* __restrict__ data,
                   const float* __restrict__ y2, const int* __restrict__ ids,
                   int P, int cap, int d, int kk, int metric, int p_chunk,
                   float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ unsigned char smem_raw[];
  float* lv = reinterpret_cast<float*>(smem_raw);   // [kk]
  int* li = reinterpret_cast<int*>(lv + kk);        // [kk]
  float* sq = reinterpret_cast<float*>(li + kk);    // [d]
  __shared__ float xs[kQmRows][kQmBK + 1];
  __shared__ float sv[kQmRows];
  __shared__ int sid[kQmRows];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int qi = blockIdx.x;
  const float q2 = q2v[qi];

  if (tid < 32) rt::list_init(lv, li, kk, lane);
  for (int k = tid; k < d; k += kQmRows) sq[k] = q[(size_t)qi * d + k];
  __syncthreads();

  // this block's probes [p_begin, p_end), a contiguous part of the pool
  const int p_begin = blockIdx.y * p_chunk;
  const int p_end = min(P, p_begin + p_chunk);
  if (!isinf(q2)) {
    for (int p = p_begin; p < p_end; ++p) {
      const int l = probes[(size_t)qi * P + p];
      const float* rows = data + (size_t)l * cap * d;
      for (int c0 = 0; c0 < cap; c0 += kQmRows) {
        const int c_rows = min(kQmRows, cap - c0);
        const int id = tid < c_rows ? ids[(size_t)l * cap + c0 + tid] : -1;
        if (!__syncthreads_or(id >= 0)) continue;
        float acc = 0.0f;
        for (int k0 = 0; k0 < d; k0 += kQmBK) {
          __syncthreads();
#pragma unroll 4
          for (int s = 0; s < kQmBK; ++s) {
            const int idx = tid + s * kQmRows;
            const int r = idx / kQmBK;
            const int kk2 = idx % kQmBK;
            const int k = k0 + kk2;
            xs[r][kk2] = (r < c_rows && k < d) ? rows[(size_t)(c0 + r) * d + k] : 0.0f;
          }
          __syncthreads();
          const int kn = min(kQmBK, d - k0);
          for (int k2 = 0; k2 < kn; ++k2) acc = fmaf(sq[k0 + k2], xs[tid][k2], acc);
        }
        const float y = tid < c_rows ? y2[(size_t)l * cap + c0 + tid] : 0.0f;
        sv[tid] = id < 0 ? CUDART_INF_F : score(metric, acc, q2, y);
        sid[tid] = id;
        __syncthreads();
        if (tid < 32) rt::list_offer_row(sv, sid, c_rows, lv, li, kk, lane);
      }
    }
  }
  __syncthreads();
  const size_t out_base = (size_t)qi * gridDim.y * kk + (size_t)blockIdx.y * kk;
  for (int p = tid; p < kk; p += kQmRows) {
    out_v[out_base + p] = lv[p];
    out_i[out_base + p] = li[p];
  }
}

}  // namespace

extern "C" int rt_ivf_scan_probe_major(const int* bucket_list, const float* qg,
                                       const float* q2g, const float* data,
                                       const float* y2, const int* ids, int B, int G,
                                       int cap, int d, int kk, int metric,
                                       float* out_v, int* out_i, void* stream) {
  if (kk < 1 || kk > rt::kMaxK || d < 1 || cap < 1 || G < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)rt::kBM * kk * (sizeof(float) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      probe_major_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)((size_t)rt::kBM * rt::kMaxK * (sizeof(float) + sizeof(int))));
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, (G + rt::kBM - 1) / rt::kBM);
  probe_major_kernel<<<grid, rt::kGemmThreads, smem, (cudaStream_t)stream>>>(
      bucket_list, qg, q2g, data, y2, ids, G, cap, d, kk, metric, out_v, out_i);
  return (int)cudaGetLastError();
}

// splits > 1 cuts each query's probes into that many contiguous parts, one
// grid column each (so a serving batch of 64 queries still fills the card);
// their lists land in part_v / part_i [Q, splits * kk] and merge_parts
// folds them in probe order.
extern "C" int rt_ivf_scan_query_major(const int* probes, const float* q,
                                       const float* q2, const float* data,
                                       const float* y2, const int* ids, int Q, int P,
                                       int cap, int d, int kk, int metric, int splits,
                                       float* part_v, int* part_i,
                                       float* out_v, int* out_i, void* stream) {
  if (kk < 1 || kk > rt::kMaxK || d < 1 || cap < 1 || P < 1 || splits < 1)
    return (int)cudaErrorInvalidValue;
  if (Q == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)kk * (sizeof(float) + sizeof(int)) + (size_t)d * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        query_major_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int p_chunk = (P + splits - 1) / splits;
  splits = (P + p_chunk - 1) / p_chunk;
  const bool merge = splits > 1;
  query_major_kernel<<<dim3(Q, splits), kQmRows, smem, (cudaStream_t)stream>>>(
      probes, q, q2, data, y2, ids, P, cap, d, kk, metric, p_chunk,
      merge ? part_v : out_v, merge ? part_i : out_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !merge) return (int)err;
  return (int)rt::merge_parts(part_v, part_i, Q, splits * kk, kk, out_v, out_i,
                              (cudaStream_t)stream);
}
