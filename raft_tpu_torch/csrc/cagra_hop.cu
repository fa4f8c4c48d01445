// One CAGRA beam-search hop: expand each query's parents, score their
// neighbour rows, drop repeats, fold the survivors into the query's sorted
// candidate buffer, and recover the explored flags.
//
// Replaces raft_tpu/kernels/cagra_traverse.py cagra_fused_hop / _hop_kernel
// (the dense-dataset leg) and _hop_kernel_paged (the paged leg: the rows sit
// in a pool of pages [slots][page_rows][d] behind a page table, and row id
// is row id % page_rows of pool slot page_slot[id / page_rows]; a -1 entry,
// a page not resident, reads slot 0, as raft_tpu's kernel clamps it).  The
// paged leg differs only in where a row is read: the threads that load the
// candidate ids also stage each candidate's row index (the id itself when
// dense), and the row loads go through it.  Same scores, same fold: the
// paged leg is bitwise the dense leg on an identity-placed pool.
//
// Semantics, identical to the TPU kernel and to the plain version
// (kernels/cagra_traverse.py cagra_fused_hop_torch).  For parent w = 0 ..
// width-1 in order, candidate j of the parent's neighbour list scores
//   l2  max((q2 + v2) - 2 ip, 0)      ip  -ip
// (ip = q.v, v2 = |v|^2, q2 = |q|^2, each one f32 accumulator updated by
// fmaf in dimension order), or +inf when the id is negative, the parent is
// negative (-1: no parent), the id already sits in the live merged buffer
// (the buffer after the folds of parents 0 .. w-1), or an earlier slot of
// the same list holds the same id.  The candidates then fold into the
// buffer by (value, position), residents first (topk.cuh: residents win
// ties), and every +inf slot's id becomes -1.  After the last parent a slot
// is explored when its id was an explored slot's id in the INPUT buffer, or
// when its value is +inf.
//
// What bounds it on the H100: per query and parent, deg random rows of d
// values (32 KB at deg 64, d 128, f32) against 2 deg d flops, so it is
// bound by the bytes of the gathered rows, and at serving batch sizes by
// latency (one small block per query, a few microseconds of work).  The
// design: one block per query, the query and the buffer in shared memory
// for the whole hop; each parent's rows stage through shared memory in
// 32-dimension chunks with coalesced loads (bf16 rows upcast exactly), one
// thread per candidate keeps the two dot products in registers; then one
// warp folds the scores into the buffer with the port's running top-k list.
// Folding the parent pick and all hops of a search into one launch, and TMA
// row gathers, are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "tile_gemm.cuh"
#include "topk.cuh"

namespace {

constexpr int kHopThreads = 128;   // candidates scored per pass, one per thread
// deepest internal buffer: raft's own itopk bound (raft_tpu's
// kernels/cagra_traverse.py:33), below the lists' kMaxK
constexpr int kMaxItopk = 512;
constexpr int kHopBK = 32;         // dimensions staged per chunk

template <typename T, bool kWide>
__global__ void __launch_bounds__(kHopThreads)
cagra_hop_kernel(const T* __restrict__ data, const int* __restrict__ graph,
                 const float* __restrict__ queries, const int* __restrict__ parents,
                 const float* __restrict__ buf_d, const int* __restrict__ buf_i,
                 const uint8_t* __restrict__ explored, int d, int deg, int width,
                 int itopk, int ip_mode, const int* __restrict__ page_slot, int page_rows,
                 float* __restrict__ out_d, int* __restrict__ out_i,
                 uint8_t* __restrict__ out_e) {
  extern __shared__ unsigned char smem_raw[];
  size_t* crow = reinterpret_cast<size_t*>(smem_raw);  // [deg] candidate row indices
  float* lv = reinterpret_cast<float*>(crow + deg);  // [itopk] merged values
  int* li = reinterpret_cast<int*>(lv + itopk);      // [itopk] merged ids
  int* in_i = li + itopk;                            // [itopk] input ids
  float* sq = reinterpret_cast<float*>(in_i + itopk);  // [d] the query
  float* cv = sq + d;                                // [deg] candidate scores
  int* cid = reinterpret_cast<int*>(cv + deg);       // [deg] candidate ids
  uint8_t* in_e = reinterpret_cast<uint8_t*>(cid + deg);  // [itopk] input flags
  __shared__ float xs[kHopThreads][kHopBK + 1];
  __shared__ float s_q2;

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t base = (size_t)t * itopk;

  for (int p = tid; p < itopk; p += kHopThreads) {
    lv[p] = buf_d[base + p];
    li[p] = buf_i[base + p];
    in_i[p] = li[p];
    in_e[p] = explored[base + p];
  }
  for (int k = tid; k < d; k += kHopThreads) sq[k] = queries[(size_t)t * d + k];
  __syncthreads();
  if (tid == 0) {
    float acc = 0.0f;
    for (int k = 0; k < d; ++k) acc = fmaf(sq[k], sq[k], acc);
    s_q2 = acc;
  }

  for (int w = 0; w < width; ++w) {
    const int pid = parents[(size_t)t * width + w];
    for (int j = tid; j < deg; j += kHopThreads) {
      const int id = pid >= 0 ? graph[(size_t)pid * deg + j] : -1;
      cid[j] = id;
      size_t row = id;
      if (page_slot != nullptr && id >= 0)
        row = (size_t)max(page_slot[id / page_rows], 0) * page_rows + id % page_rows;
      crow[j] = row;
    }
    __syncthreads();
    const float q2 = s_q2;
    for (int c0 = 0; c0 < deg; c0 += kHopThreads) {
      const int c_rows = min(kHopThreads, deg - c0);
      float ip = 0.0f, v2 = 0.0f;
      for (int k0 = 0; k0 < d; k0 += kHopBK) {
        __syncthreads();
        // all kHopBK loads of a thread in flight at once: the rows are random,
        // so each load waits out a full device-memory latency
#pragma unroll
        for (int s = 0; s < kHopBK; ++s) {
          const int idx = tid + s * kHopThreads;
          const int r = idx / kHopBK;
          const int k = k0 + idx % kHopBK;
          const int id = r < c_rows ? cid[c0 + r] : -1;
          xs[r][idx % kHopBK] =
              (id >= 0 && k < d) ? rt::as_f32(data[crow[c0 + r] * d + k]) : 0.0f;
        }
        __syncthreads();
        if (tid < c_rows) {
          const int kn = min(kHopBK, d - k0);
          for (int kc = 0; kc < kn; ++kc) {
            const float y = xs[tid][kc];
            ip = fmaf(sq[k0 + kc], y, ip);
            v2 = fmaf(y, y, v2);
          }
        }
      }
      if (tid < c_rows) {
        const int c = c0 + tid;
        const int id = cid[c];
        bool bad = id < 0 || pid < 0;
        for (int i = 0; i < c && !bad; ++i) bad = cid[i] == id;
        for (int p = 0; p < itopk && !bad; ++p) bad = li[p] == id;
        // explicit _rn operations: no contraction into an fma, so each step
        // rounds where the plain version's tensor operations do
        cv[c] = bad ? CUDART_INF_F
                    : ip_mode ? -ip
                              : fmaxf(__fsub_rn(__fadd_rn(q2, v2), __fmul_rn(2.0f, ip)), 0.0f);
      }
    }
    __syncthreads();
    if (tid < 32) {
      rt::list_offer_row<kWide>(cv, cid, deg, lv, li, itopk, tid);
      for (int p = tid; p < itopk; p += 32)
        if (isinf(lv[p])) li[p] = -1;
      __syncwarp();
    }
    __syncthreads();
  }

  for (int p = tid; p < itopk; p += kHopThreads) {
    const float v = lv[p];
    const int id = li[p];
    bool e = isinf(v);
    for (int s = 0; s < itopk && !e; ++s) e = in_e[s] && in_i[s] == id;
    out_d[base + p] = v;
    out_i[base + p] = id;
    out_e[base + p] = e ? 1 : 0;
  }
}

template <typename T>
int launch_hop(const T* data, const int* graph, const float* queries, const int* parents,
               const float* buf_d, const int* buf_i, const uint8_t* explored, int tile, int d,
               int deg, int width, int itopk, int ip_mode, const int* page_slot,
               int page_rows, float* out_d, int* out_i, uint8_t* out_e,
               cudaStream_t stream) {
  if (itopk < 1 || itopk > kMaxItopk || d < 1 || deg < 1 || width < 1 ||
      (page_slot != nullptr && page_rows < 1))
    return (int)cudaErrorInvalidValue;
  if (tile == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)deg * sizeof(size_t) + (size_t)itopk * (3 * sizeof(int) + 1) +
                      (size_t)d * sizeof(float) + (size_t)deg * (sizeof(float) + sizeof(int));
  if (smem > rt::kMaxDynamicSmem) return (int)cudaErrorInvalidValue;
  auto kernel =
      rt::pick_wide(itopk, [](auto w) { return cagra_hop_kernel<T, decltype(w)::value>; });
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<tile, kHopThreads, smem, stream>>>(
      data, graph, queries, parents, buf_d, buf_i, explored, d, deg, width, itopk, ip_mode,
      page_slot, page_rows, out_d, out_i, out_e);
  return (int)cudaGetLastError();
}

}  // namespace

// dataset [n, d] f32 (bf16 != 0: bf16) — or, with a page table page_slot
// [n_pages] int32 (null: dense), the pool of pages [slots][page_rows][d] —
// graph [n, deg] int32, queries [tile, d] f32, parents [tile, width] int32,
// buffers [tile, itopk] (f32 values, int32 ids, uint8 flags); outputs of
// the same shapes.
extern "C" int rt_cagra_hop(const void* data, int bf16, const int* graph, const float* queries,
                            const int* parents, const float* buf_d, const int* buf_i,
                            const void* explored, int tile, int d, int deg, int width,
                            int itopk, int ip_mode, const int* page_slot, int page_rows,
                            float* out_d, int* out_i, void* out_e, void* stream) {
  auto s = (cudaStream_t)stream;
  auto e_in = static_cast<const uint8_t*>(explored);
  auto e_out = static_cast<uint8_t*>(out_e);
  return bf16 ? launch_hop(static_cast<const __nv_bfloat16*>(data), graph, queries, parents,
                           buf_d, buf_i, e_in, tile, d, deg, width, itopk, ip_mode, page_slot,
                           page_rows, out_d, out_i, e_out, s)
              : launch_hop(static_cast<const float*>(data), graph, queries, parents, buf_d,
                           buf_i, e_in, tile, d, deg, width, itopk, ip_mode, page_slot,
                           page_rows, out_d, out_i, e_out, s);
}
