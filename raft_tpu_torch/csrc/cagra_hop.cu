// CAGRA beam-search hops: expand each query's parents, score their
// neighbour rows, drop repeats, fold the survivors into the query's sorted
// candidate buffer, and recover the explored flags.  rt_cagra_hop runs one
// hop from given parents; rt_cagra_traverse runs a tile's whole walk,
// `steps` hops each picking its own parents, in one launch.  Both run the
// one kernel below.
//
// Replaces raft_tpu/kernels/cagra_traverse.py cagra_fused_hop / _hop_kernel
// (the dense-dataset leg, f32 or bf16 rows; uint8 / int8 rows, which
// raft_tpu walks in its XLA body, are legs of the same kernel here, each
// value converted exactly to f32 as it is read from the staged row) and
// _hop_kernel_paged (the paged leg: the rows sit
// in a pool of pages [slots][page_rows][d] behind a page table, and row id
// is row id % page_rows of pool slot page_slot[id / page_rows]; a -1 entry,
// a page not resident, reads slot 0, as raft_tpu's kernel clamps it).  The
// paged leg differs only in where a row is read, so it is bitwise the dense
// leg on an identity-placed pool.
//
// Semantics of a hop, identical to the TPU kernel and to the plain version
// (kernels/cagra_traverse.py cagra_fused_hop_torch).  For parent w = 0 ..
// width-1 in order, candidate j of the parent's neighbour list scores
//   l2  max((q2 + v2) - 2 ip, 0)      ip  -ip
// (ip = q.v, v2 = |v|^2, q2 = |q|^2, each one f32 accumulator updated by
// fmaf in dimension order), or +inf when the id is negative, the parent is
// negative (-1: no parent), the id already sits in the live merged buffer
// (the buffer after the folds of parents 0 .. w-1), or an earlier slot of
// the same list holds the same id.  The candidates then fold into the
// buffer by (value, position), residents first, and every +inf slot's id
// becomes -1.  After the last parent a slot is explored when its id was an
// explored slot's id in the INPUT buffer, or when its value is +inf.
//
// The walk: per hop each query's block picks its parents (the `width` best
// unexplored finite slots by (value, slot), as pick_parents' select_k; -1
// where the frontier ran out), marks them explored, then runs the hop; the
// buffer, its ids and flags stay in shared memory across hops and are
// written once (raft_tpu runs the loop as one lax.while_loop, and the
// reference's search_single_cta keeps a query's walk in one CTA).  A query
// whose frontier is exhausted stops: every further hop changes nothing but
// to mark the +inf slots explored, which it does once.
//
// What bounds it on the H100: per live parent, the latency of two dependent
// gathers (the parent's graph row, then its neighbours' rows) and the bytes
// of the rows it reads; a tile of queries is the launch's parallelism (a
// query's walk has none across hops).  The design, one 64-thread block a
// query:
//  - the repeats and ids already in the buffer are dropped first (their
//    rows are never read), then all of a parent's remaining rows are issued
//    at once by cp.async (16-byte copies, 32 KB for f32 at deg 64 x d 128);
//  - at deg 64 every thread scores a candidate, one fmaf chain in dimension
//    order each;
//  - the fold is a merge, not a list insert: the candidates are ranked by
//    (value, slot), and every resident and candidate finds its place in
//    the merged buffer by binary search (residents win ties), each thread
//    writing its own, so no warp serialises the fold;
//  - in the walk, explored flags ride with the entries through the merge,
//    and a candidate that re-enters takes its flag from the hop's input.
//    The buffer's finite ids are distinct (traverse_init and every hop keep
//    them so), which makes that the rule above.  The single hop, whose
//    input may repeat an id, applies the rule itself at the end.
// The kernel returns, a query, the live parents its hops had and the rows
// they read: the work the launch really did, for its bound.  TMA row
// gathers are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "block_select.cuh"
#include "tile_gemm.cuh"
#include "topk.cuh"

namespace {

// deepest internal buffer: raft's own itopk bound (raft_tpu's
// kernels/cagra_traverse.py:33), below the lists' kMaxK
constexpr int kMaxItopk = 512;

constexpr int kWalkThreads = 64;          // candidates scored at once, one a thread
constexpr size_t kWalkRowBytes = 48 * 1024;   // shared memory of a group of staged rows

// Bytes between two staged rows: the row rounded up to an odd number of
// 16-byte words (LDS.128 reads of 8 threads on distinct bank groups).
inline int walk_stride(int row_bytes) { return 16 * (((row_bytes + 15) / 16) | 1); }

// Candidate rows staged at once: all deg of a parent where they fit the
// budget.
inline int walk_group(int deg, int stride) {
  const int fit = (int)(kWalkRowBytes / (size_t)stride);
  return deg < fit ? deg : (fit > 0 ? fit : 1);
}

// Dynamic shared memory of a block: staged rows, their indices, two
// buffers (values, ids), the hop's input ids, the query, the candidates'
// ids, values, sorted values and ranks, the parents, then the byte flags
// (two buffers and the hop's input).
inline size_t walk_smem(int d, int deg, int width, int itopk, int stride, int group) {
  return (size_t)group * stride + (size_t)deg * sizeof(long long) +
         (size_t)itopk * (2 * sizeof(float) + 3 * sizeof(int)) + (size_t)d * sizeof(float) +
         (size_t)deg * (2 * sizeof(int) + 2 * sizeof(float)) + (size_t)width * sizeof(int) +
         (size_t)itopk * 3;
}

// Value e of a 16-byte word of T values, as f32 (exact: an 8-bit value
// through rt::as_f32, the staging conversion of the raw 8-bit scans).
template <typename T>
__device__ __forceinline__ float walk_elem(const uint4& w, int e) {
  const int byte = e * (int)sizeof(T);
  const unsigned word = byte < 4 ? w.x : byte < 8 ? w.y : byte < 12 ? w.z : w.w;
  if constexpr (sizeof(T) == 4) return __uint_as_float(word);
  else if constexpr (sizeof(T) == 2) return __uint_as_float(((word >> ((byte & 3) * 8)) & 0xffffu) << 16);
  else return rt::as_f32(static_cast<T>((word >> ((byte & 3) * 8)) & 0xffu));
}

// Number of the first n values of a sorted array below v (kUpper: at or
// below v).
template <bool kUpper>
__device__ __forceinline__ int rank_in(const float* a, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (kUpper ? a[mid] <= v : a[mid] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// One block a query.  parents [tile, width]: one hop from those parents
// (steps is 1); null: `steps` hops, each picking its own.
template <typename T>
__global__ void __launch_bounds__(kWalkThreads)
cagra_walk_kernel(const T* __restrict__ data, const int* __restrict__ graph,
                  const float* __restrict__ queries, const int* __restrict__ parents,
                  const float* __restrict__ buf_d, const int* __restrict__ buf_i,
                  const uint8_t* __restrict__ explored, int d, int deg, int width, int itopk,
                  int ip_mode, int steps, const int* __restrict__ page_slot, int page_rows,
                  int vec, int stride, int group, float* __restrict__ out_d,
                  int* __restrict__ out_i, uint8_t* __restrict__ out_e,
                  int* __restrict__ live_out, int* __restrict__ fetched_out) {
  extern __shared__ __align__(16) unsigned char walk_dyn[];
  unsigned char* rows = walk_dyn;                                       // [group][stride]
  long long* crow = reinterpret_cast<long long*>(rows + (size_t)group * stride);   // [deg]
  // two buffers each of values, ids and flags: buffer c at + c * itopk
  float* lv2 = reinterpret_cast<float*>(crow + deg);                     // [2][itopk]
  int* li2 = reinterpret_cast<int*>(lv2 + 2 * itopk);                    // [2][itopk]
  int* in_i = li2 + 2 * itopk;                                          // [itopk]
  float* sq = reinterpret_cast<float*>(in_i + itopk);                    // [d]
  int* cid = reinterpret_cast<int*>(sq + d);                             // [deg]
  float* cv = reinterpret_cast<float*>(cid + deg);                       // [deg]
  float* srt = cv + deg;                                                 // [deg]
  int* crank = reinterpret_cast<int*>(srt + deg);                        // [deg]
  int* par = crank + deg;                                               // [width]
  uint8_t* le2 = reinterpret_cast<uint8_t*>(par + width);               // [2][itopk]
  uint8_t* in_e = le2 + 2 * itopk;                                      // [itopk]
  auto lv = [&](int c) { return lv2 + c * itopk; };
  auto li = [&](int c) { return li2 + c * itopk; };
  auto le = [&](int c) { return le2 + c * itopk; };
  __shared__ unsigned long long s_best[kWalkThreads / 32];
  __shared__ int s_sum[kWalkThreads / 32];
  __shared__ int s_nent;
  __shared__ float s_q2;

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t base = (size_t)t * itopk;
  const int rb = d * (int)sizeof(T);
  const unsigned char* bytes = reinterpret_cast<const unsigned char*>(data);
  int cur = 0;

  for (int p = tid; p < itopk; p += kWalkThreads) {
    lv(0)[p] = buf_d[base + p];
    li(0)[p] = buf_i[base + p];
    le(0)[p] = explored[base + p];
  }
  for (int w = tid; parents != nullptr && w < width; w += kWalkThreads)
    par[w] = parents[(size_t)t * width + w];
  for (int k = tid; k < d; k += kWalkThreads) sq[k] = queries[(size_t)t * d + k];
  __syncthreads();
  if (tid == 0) {
    float acc = 0.0f;
    for (int k = 0; k < d; ++k) acc = fmaf(sq[k], sq[k], acc);
    s_q2 = acc;
  }

  int live = 0, fetched = 0;   // fetched: this thread's share
  for (int step = 0; step < steps; ++step) {
    const float* v0 = lv(cur);
    const int* i0 = li(cur);
    uint8_t* e0 = le(cur);
    // the parents: width argmins of (okey(value), slot) over the unexplored
    // finite slots, each marked explored
    for (int w = 0; parents == nullptr && w < width; ++w) {
      unsigned long long best = rt::kPadKey;
      for (int p = tid; p < itopk; p += kWalkThreads) {
        const float v = v0[p];
        if (!e0[p] && isfinite(v)) {
          const unsigned long long key = (unsigned long long)rt::okey(v) << 32 | (unsigned)p;
          best = key < best ? key : best;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long other = __shfl_xor_sync(rt::kFull, best, o);
        best = other < best ? other : best;
      }
      if ((tid & 31) == 0) s_best[tid >> 5] = best;
      __syncthreads();
      if (tid == 0) {
        unsigned long long b = s_best[0];
        for (int i = 1; i < kWalkThreads / 32; ++i) b = s_best[i] < b ? s_best[i] : b;
        int pid = -1;
        if (b != rt::kPadKey) {
          const int p = (int)(unsigned)b;
          pid = i0[p];
          e0[p] = 1;
        }
        par[w] = pid;
      }
      __syncthreads();
    }
    if (parents == nullptr && par[0] < 0) {
      // the frontier is exhausted: this hop and every later one leave the
      // buffer as it is, every slot explored and every +inf slot's id -1
      for (int p = tid; p < itopk; p += kWalkThreads) {
        e0[p] = 1;
        if (!isfinite(v0[p])) li(cur)[p] = -1;
      }
      break;
    }
    for (int p = tid; p < itopk; p += kWalkThreads) {
      in_i[p] = i0[p];
      in_e[p] = e0[p];
    }
    for (int w = 0; w < width; ++w) {
      const int pid = par[w];
      if (pid < 0) continue;   // no parent: every candidate scores +inf, the fold keeps all
      ++live;
      const float* bv = lv(cur);
      const int* bi = li(cur);
      for (int j = tid; j < deg; j += kWalkThreads) cid[j] = graph[(size_t)pid * deg + j];
      if (tid == 0) s_nent = 0;
      __syncthreads();
      // drop repeats of an earlier slot and ids already in the live buffer:
      // their rows are never read (no early exit: the loads pipeline)
      for (int j = tid; j < deg; j += kWalkThreads) {
        const int id = cid[j];
        bool bad = id < 0;
#pragma unroll 8
        for (int i = 0; i < j; ++i) bad |= cid[i] == id;
#pragma unroll 8
        for (int p = 0; p < itopk; ++p) bad |= bi[p] == id;
        long long row = -1;
        if (!bad) {
          row = page_slot == nullptr
                    ? (long long)id
                    : (long long)max(page_slot[id / page_rows], 0) * page_rows + id % page_rows;
          ++fetched;
        }
        crow[j] = row;
      }
      __syncthreads();
      const float q2 = s_q2;
      const int n16 = (rb + 15) / 16;
      for (int c0 = 0; c0 < deg; c0 += group) {
        const int g = min(group, deg - c0);
        for (int u = tid; u < g * n16; u += kWalkThreads) {
          const int j = u / n16;
          const int sg = u - j * n16;
          const long long row = crow[c0 + j];
          rt::stage16(rows + (size_t)j * stride + 16 * sg,
                      row >= 0 ? bytes + (size_t)row * rb : nullptr, 16 * sg, rb, vec, data);
        }
        rt::cp_async_commit();
        rt::cp_async_wait<0>();
        __syncthreads();
        for (int j = tid; j < g; j += kWalkThreads) {
          float v = CUDART_INF_F;
          if (crow[c0 + j] >= 0) {
            const unsigned char* r = rows + (size_t)j * stride;
            float ip = 0.0f, v2 = 0.0f;
            constexpr int kPer = 16 / (int)sizeof(T);
#pragma unroll 4
            for (int s = 0; s < n16; ++s) {
              const uint4 word = *reinterpret_cast<const uint4*>(r + 16 * s);
#pragma unroll
              for (int e = 0; e < kPer; ++e) {
                const int k = s * kPer + e;
                if (k < d) {
                  const float y = walk_elem<T>(word, e);
                  ip = fmaf(sq[k], y, ip);
                  v2 = fmaf(y, y, v2);
                }
              }
            }
            // explicit _rn operations: no contraction into an fma, so each
            // step rounds where the plain version's tensor operations do
            v = ip_mode ? -ip : fmaxf(__fsub_rn(__fadd_rn(q2, v2), __fmul_rn(2.0f, ip)), 0.0f);
          }
          cv[c0 + j] = v;
        }
        __syncthreads();   // the group's rows are read before the next group lands
      }
      // rank the candidates that may enter (v < +inf) by (value, slot)
      int own = 0;
      for (int j = tid; j < deg; j += kWalkThreads) {
        const float v = cv[j];
        int r = -1;
        if (v < CUDART_INF_F) {
          r = 0;
#pragma unroll 8
          for (int i = 0; i < deg; ++i) {
            const float u = cv[i];
            r += (u < v || (u == v && i < j)) ? 1 : 0;
          }
          srt[r] = v;
          ++own;
        }
        crank[j] = r;
      }
      own = __reduce_add_sync(rt::kFull, own);
      if ((tid & 31) == 0 && own) atomicAdd(&s_nent, own);
      __syncthreads();
      const int nent = s_nent;
      float* nv = lv(cur ^ 1);
      int* ni = li(cur ^ 1);
      uint8_t* ne = le(cur ^ 1);
      const uint8_t* be = le(cur);
      // the merge: residents first on ties
      for (int p = tid; p < itopk; p += kWalkThreads) {
        const float v = bv[p];
        const int to = p + rank_in<false>(srt, nent, v);
        if (to < itopk) {
          nv[to] = v;
          ni[to] = isfinite(v) ? bi[p] : -1;
          ne[to] = be[p];
        }
      }
      for (int j = tid; j < deg; j += kWalkThreads) {
        const int r = crank[j];
        if (r < 0) continue;
        const float v = cv[j];
        const int to = r + rank_in<true>(bv, itopk, v);
        if (to < itopk) {
          const int id = cid[j];
          bool e = false;   // explored in the hop's input: a re-entry
#pragma unroll 8
          for (int s2 = 0; s2 < itopk; ++s2) e |= in_e[s2] && in_i[s2] == id;
          nv[to] = v;
          ni[to] = isfinite(v) ? id : -1;
          ne[to] = e ? 1 : 0;
        }
      }
      cur ^= 1;
      __syncthreads();
    }
    // every +inf slot explored with id -1; the single hop's flags by the
    // rule itself (its input may repeat an id)
    for (int p = tid; p < itopk; p += kWalkThreads) {
      const int id = li(cur)[p];
      if (!isfinite(lv(cur)[p])) {
        li(cur)[p] = -1;
        le(cur)[p] = 1;
      } else if (parents != nullptr) {
        bool e = false;
        for (int s2 = 0; s2 < itopk; ++s2) e |= in_e[s2] && in_i[s2] == id;
        le(cur)[p] = e ? 1 : 0;
      }
    }
    __syncthreads();
  }
  fetched = __reduce_add_sync(rt::kFull, fetched);
  if ((tid & 31) == 0) s_sum[tid >> 5] = fetched;
  __syncthreads();
  for (int p = tid; p < itopk; p += kWalkThreads) {
    out_d[base + p] = lv(cur)[p];
    out_i[base + p] = li(cur)[p];
    out_e[base + p] = le(cur)[p];
  }
  if (tid == 0 && live_out != nullptr) {
    live_out[t] = live;
    int sum = 0;
    for (int i = 0; i < kWalkThreads / 32; ++i) sum += s_sum[i];
    fetched_out[t] = sum;
  }
}

template <typename T>
int launch_walk(const T* data, const int* graph, const float* queries, const int* parents,
                const float* buf_d, const int* buf_i, const uint8_t* explored, int tile, int d,
                int deg, int width, int itopk, int ip_mode, int steps, const int* page_slot,
                int page_rows, float* out_d, int* out_i, uint8_t* out_e, int* live,
                int* fetched, cudaStream_t stream) {
  if (itopk < 1 || itopk > kMaxItopk || d < 1 || deg < 1 || width < 1 ||
      (parents == nullptr ? width > itopk || steps < 0 || live == nullptr || fetched == nullptr
                          : steps != 1) ||
      (page_slot != nullptr && page_rows < 1))
    return (int)cudaErrorInvalidValue;
  if (tile == 0) return (int)cudaSuccess;
  const int rb = d * (int)sizeof(T);
  const int stride = walk_stride(rb);
  const int group = walk_group(deg, stride);
  const size_t smem = walk_smem(d, deg, width, itopk, stride, group);
  if (smem > rt::kMaxDynamicSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(cagra_walk_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cagra_walk_kernel<T><<<tile, kWalkThreads, smem, stream>>>(
      data, graph, queries, parents, buf_d, buf_i, explored, d, deg, width, itopk, ip_mode,
      steps, page_slot, page_rows, rt::stage_vec(data, (size_t)rb), stride, group, out_d, out_i,
      out_e, live, fetched);
  return (int)cudaGetLastError();
}

// The row type's code: 0 f32, 1 bf16, 2 uint8, 3 int8.
template <typename... A>
int launch_either(const void* data, int dtype, A... args) {
  switch (dtype) {
    case 0: return launch_walk(static_cast<const float*>(data), args...);
    case 1: return launch_walk(static_cast<const __nv_bfloat16*>(data), args...);
    case 2: return launch_walk(static_cast<const uint8_t*>(data), args...);
    case 3: return launch_walk(static_cast<const int8_t*>(data), args...);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dataset [n, d] of the type `dtype` names (0 f32, 1 bf16, 2 uint8, 3 int8)
// — or, with a page table page_slot [n_pages] int32 (null: dense), the pool
// of pages [slots][page_rows][d] —
// graph [n, deg] int32, queries [tile, d] f32, parents [tile, width] int32,
// buffers [tile, itopk] (f32 values, int32 ids, uint8 flags); outputs of
// the same shapes.
extern "C" int rt_cagra_hop(const void* data, int dtype, const int* graph, const float* queries,
                            const int* parents, const float* buf_d, const int* buf_i,
                            const void* explored, int tile, int d, int deg, int width,
                            int itopk, int ip_mode, const int* page_slot, int page_rows,
                            float* out_d, int* out_i, void* out_e, void* stream) {
  return launch_either(data, dtype, graph, queries, parents, buf_d, buf_i,
                       static_cast<const uint8_t*>(explored), tile, d, deg, width, itopk,
                       ip_mode, 1, page_slot, page_rows, out_d, out_i,
                       static_cast<uint8_t*>(out_e), (int*)nullptr, (int*)nullptr,
                       (cudaStream_t)stream);
}

// A tile's whole walk: `steps` hops, each picking the `width` (<= itopk)
// best unexplored finite slots of a query's buffer as its parents, then the
// hop of rt_cagra_hop.  Arguments as rt_cagra_hop without the parents, plus
// `steps`; live and fetched [tile] int32 receive the live parents each
// query's walk ran and the candidate rows it read (the work it really did,
// for the bound).
extern "C" int rt_cagra_traverse(const void* data, int dtype, const int* graph,
                                 const float* queries, const float* buf_d, const int* buf_i,
                                 const void* explored, int tile, int d, int deg, int width,
                                 int itopk, int ip_mode, int steps, const int* page_slot,
                                 int page_rows, float* out_d, int* out_i, void* out_e, int* live,
                                 int* fetched, void* stream) {
  return launch_either(data, dtype, graph, queries, (const int*)nullptr, buf_d, buf_i,
                       static_cast<const uint8_t*>(explored), tile, d, deg, width, itopk,
                       ip_mode, steps, page_slot, page_rows, out_d, out_i,
                       static_cast<uint8_t*>(out_e), live, fetched, (cudaStream_t)stream);
}
