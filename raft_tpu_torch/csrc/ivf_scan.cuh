// IVF list scans: score stored rows against queries and keep each query's
// top-kk by (score, position).  This header holds the kernels and their
// launchers; the C entries are split by storage type over
// ivf_scan_f32.cu, ivf_scan_bf16.cu, ivf_scan_int8.cu and ivf_scan_8bit.cu,
// so that the library build compiles them in parallel (one nvcc each).
//
// ivf_scan_probe_major replaces raft_tpu/kernels/ivf_scan.py
// ivf_scan_probe_major / _scan_kernel.  One bucket is one list and up to G
// queries that probe it; position = slot in the list.
// ivf_scan_query_major replaces ivf_scan_query_major / _scan_qm_kernel, and
// its query_fid leg _scan_qm_kernel_fid.  One query streams its P probed
// lists; position = p * cap + slot, so the lists are walked in probe order.
//
// Each schedule has one C entry per storage type (_score_against_list's
// legs), each with its own launch count in the wrapper:
//  - f32 rows (IVF-Flat, IVF-PQ decoded_dtype="float32");
//  - bf16 rows (IVF-PQ's default scan cache), upcast exactly on load;
//  - uint8 / int8 rows as raw values (IVF-Flat over 8-bit datasets, which
//    raft_tpu scans upcast to f32 at scan_dtype "highest"): each value is
//    converted to f32 where it is staged, then the f32 legs' fmaf chain
//    runs on it.  Unfiltered and filter legs; no paged or bf16-compute leg.
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
// Filter legs (kFilt, every storage type, each with its own launch count in
// the wrapper): the pass bits of each list's slots come packed per list,
// [n_lists][cap_w] words (bit j of word w: slot 32 w + j; padding slots
// pack as fail), the format raft_tpu packs for VMEM and also what a block
// wants here: one list's words are one contiguous run of a few dozen ints.
// A failing slot is treated as padding: its id is read as -1 where the ids
// are loaded, so it scores +inf at the point where id < 0 does, and a tile
// of failing slots is skipped like a tile of padding.  Probe-major stages
// its bucket's list words in shared memory once.  Query-major reads one
// word per slot from plane fid[q] of an [F][n_lists][cap_w] table (the
// query_fid leg) or from the one plane; the word is shared by 32 threads.
//
// Paged legs (kernel #4, raft_tpu's _ivf_scan_probe_major_paged, and the
// same read in query-major; each with its own launch count in the
// wrapper): the lists' rows sit in a pool of pages [slots][page_rows][d]
// behind a page table [n_lists * ppl] (ppl = cap / page_rows), and slot c
// of list l is row c % page_rows of pool slot table[l * ppl + c /
// page_rows] (a -1 entry, a page not resident, reads slot 0 as raft_tpu's
// kernels clamp it).  Only the row address changes: ids, norms and filter
// words stay indexed by (list, slot) on the logical capacity, and the tile
// walk, the fmaf order and the list insert are the monolithic leg's, so the
// result is bitwise the monolithic scan's on the same rows.  A tile may
// straddle pages (page_rows need only be a multiple of 8), so each row's
// index is translated on its own, once a tile: one row a thread, kept in
// shared memory for the copies of every chunk (probe-major's float legs),
// passed across the warp by shuffle to the lanes that load it (the int8
// leg, rt::lane_value), or kept in the tile's ring slot (query-major).  The
// paged loaders are a template flag (kPaged) of each kernel, so that the
// monolithic instantiations compile as before: kernels whose monolithic
// lists went through the translated loaders (on a null table) ran up to
// 66 % slower on the card, or spilled registers (PERF.md, Findings).
//
// What bounds them on the H100.  Probe-major reuses each streamed list
// across the bucket's queries (G ~ 256 at 10^4 queries), so it is bound by
// arithmetic: f32 FMA for f32 compute, the bf16 or int8 tensor-core rate
// for the other legs, which these kernels do not use (CUDA-core fmaf on a
// 64 x 128 tile over cp.async stages for the float legs, __dp4a on a
// 64 x 64 tile for the int8 leg); tiles whose slots are all padding are
// skipped, and blocks whose queries are all padding exit at once.  The
// fold of the scores into each query's kk best was the larger cost (a list
// insert is a chain of dependent shared-memory round trips; past kk = 128
// it costs O(kk), and the CAGRA build's kk = 258 scan ran at 0.8 % of the
// FMA bound): lists in registers up to kk = 32, candidate arrays and a
// radix select past kk = 128 (see the probe-major section).  Query-major
// reads P * cap rows for each query with no reuse, so it is bound by
// device memory bytes: rows stream through a two-stage cp.async ring at
// their stored width, one thread scores one row with a single
// accumulator, and the whole block folds each tile into a candidate array
// (block_select.cuh; see the query-major section).  A small
// batch splits each query's probes over several blocks and merges their
// parts (merge_parts).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "block_select.cuh"
#include "tile_gemm.cuh"
#include "topk.cuh"

namespace {

enum Metric { kL2 = 0, kIp = 1, kCosine = 2 };

// The filter of a scan: pass words [planes][n_lists][cap_w] (nullptr:
// unfiltered) and, on the query_fid leg, each query's plane (nullptr: 0).
struct Filt {
  const int* words;
  const int* fid;
  int n_lists;
  int cap_w;
};

// The rows of the lists: monolithic [n_lists][cap][d] (slot == nullptr),
// or pages [slots][rows][d] behind the page table slot [n_lists * ppl].
struct Pages {
  const int* slot;
  int rows;
  int ppl;
};

// Index, in the row array (the pool when paged), of slot c of list l.
__device__ __forceinline__ size_t row_index(const Pages& pg, int l, int cap, int c) {
  if (pg.slot == nullptr) return (size_t)l * cap + c;
  const int s = max(pg.slot[(size_t)l * pg.ppl + c / pg.rows], 0);
  return (size_t)s * pg.rows + c % pg.rows;
}

// Slot `slot`'s pass bit in a list's words; an arithmetic shift's sign
// copies drop out at & 1.
__device__ __forceinline__ bool passes(const int* list_words, int slot) {
  return ((list_words[slot >> 5] >> (slot & 31)) & 1) != 0;
}

// The kernel of a leg, filtered or not, paged or not: `pick(f, p)` returns
// it for kFilt = decltype(f)::value and kPaged = decltype(p)::value.
template <typename Pick>
static inline auto pick_fp(bool filtered, bool paged, Pick pick) {
  auto with = [&](auto f) {
    return paged ? pick(f, std::true_type{}) : pick(f, std::false_type{});
  };
  return filtered ? with(std::true_type{}) : with(std::false_type{});
}

// The same for lists of kk entries: `pick(w, f, p)` with kWide =
// decltype(w)::value (probe-major's fold past kk = 128).
template <typename Pick>
static inline auto pick_leg(int kk, bool filtered, bool paged, Pick pick) {
  return rt::pick_wide(kk, [&](auto w) {
    return pick_fp(filtered, paged, [&](auto f, auto p) { return pick(w, f, p); });
  });
}

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
// A block scans one bucket's list for up to kBM of the bucket's queries (a
// PmBlock: the bucket b, its first query g0 and q_rows queries), a tile of
// slots at a time.  Each query keeps its kk smallest (score, slot).  The
// fold of a tile's scores into them (PERF.md times it apart from the
// product; in the first kernel it took 4.2 of 5.6 ms at kk = 10; its cost
// follows the inserts, kk (1 + ln(n / kk)) a query of an n-row list, each
// a chain of warp-wide steps, and the shuffle unit, one warp instruction a
// cycle an SM, bounds it):
//  - up to kk = 32 (kRegLists) each query's list stays in registers for the
//    whole walk, one entry a lane of the warp that owns the query
//    (pm_walk_reglists): an insert is two ballots and three shuffles, the
//    candidate read from shared memory by every lane.  (Tried and dropped:
//    four threads a query, each with a list of its own, made the fold five
//    times slower, their inserts diverging within a warp; two queries'
//    inserts interleaved a step at a time, 15 % slower);
//  - up to kk = 128 the lists sit in shared memory between tiles
//    (pm_walk_lists); the owning warp loads a query's list into registers
//    (up to four entries a lane), offers the tile's scores there
//    (reg_insert) and stores it back: topk.cuh's list_insert in shared
//    memory, the same list, made the kk = 40 scan 5 % slower (PERF.md);
//  - past it a list insert costs O(kk) and a survivor of a ~900-row list at
//    kk = 258 is most of the rows, so each query appends what beats its
//    threshold to a candidate array instead (pm_walk_select): the
//    block_select.cuh scheme of fused_knn, O(1) amortised per survivor.
// Each fold receives a tile's scores as s[m * stride + c] (query m of the
// block, slot c < kN of the tile) and the slots' ids sid[c], and is called
// by every thread.
constexpr int kWarps = rt::kGemmThreads / 32;

// How a leg folds lists of kk entries (pm_fold).
enum PmFold { kRegLists = 0, kLists = 1, kWideFold = 2 };

__host__ __device__ inline int pm_fold(int kk) {
  return kk > rt::kRegK ? kWideFold : kk > 32 ? kLists : kRegLists;
}

// The bucket and queries of a block.
struct PmBlock {
  int b;        // bucket
  int g0;       // its first query's index in the bucket
  int q_rows;   // queries (the rest of the block's kBM rows are padding)
};

// The outputs of a probe-major launch [B][G][kk] and, past kk = 128
// (kWideFold), its workspace: each output row is the head of its query's
// candidate array, and ws row [B][G][extra] its tail (extra <= kk, so the
// workspace is no larger than the outputs); the array's kk smallest are
// sorted in shared memory, sort_rows queries at a time.
struct PmOut {
  float* v;
  int* i;
  float* ws_v;
  int* ws_i;
  int extra;
  int sort_rows;
};

// Bytes of dynamic shared memory the fold of kk entries takes (fold, a
// PmFold): none in registers, the lists [kBM][kk] of (value, id), or past
// kk = 128 the sort of sort_rows arrays (keys [sort_rows][pow2 >= kk], then
// values and ids [sort_rows][kk]).
__host__ __device__ inline size_t fold_smem(int fold, int kk, int sort_rows) {
  if (fold == kRegLists) return 0;
  if (fold == kLists) return (size_t)rt::kBM * kk * (sizeof(float) + sizeof(int));
  return (size_t)sort_rows * ((size_t)rt::pow2_at_least(kk) * sizeof(unsigned long long) +
                              (size_t)kk * (sizeof(float) + sizeof(int)));
}

__host__ __device__ inline size_t align16(size_t bytes) { return (bytes + 15) & ~(size_t)15; }

// The int8 leg's score tiles: for each tile of kBN slots with a real
// (passing) row, `tile_ip(l, c0, c_rows, ip)` sets ip[i][j] to the dot
// product of the block's query ty + 16 i with slot c0 + tx + 16 j of list
// l, the scores go to s[m][c] (+inf for a padding or failing slot, or a
// padding query), and `fold(s, kBN + 1, sid)` folds them (sid[c]: the
// slots' ids).  A block whose queries are all padding skips the walk, and a
// tile whose slots are all padding (or all fail the filter) is skipped.
// `prologue()` runs once before the walk of a live block.  Every thread
// calls all three.  kFilt: the list's words are staged into `sfilt`
// (cap_w ints of dynamic shared memory) before the walk.
template <bool kFilt, typename Prologue, typename TileIp, typename Fold>
__device__ __forceinline__ void pm_scores(const PmBlock& pb, const int* __restrict__ bucket_list,
                                          const float* __restrict__ q2g,
                                          const float* __restrict__ y2,
                                          const int* __restrict__ ids, int G, int cap,
                                          int metric, Filt filt, int* sfilt,
                                          Prologue&& prologue, TileIp&& tile_ip, Fold&& fold) {
  __shared__ float s[rt::kBM][rt::kBN + 1];
  __shared__ float sq2[rt::kBM];
  __shared__ float sy2[rt::kBN];
  __shared__ int sid[rt::kBN];

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int b = pb.b;

  bool live = false;
  if (tid < rt::kBM) {
    const float v = tid < pb.q_rows ? q2g[(size_t)b * G + pb.g0 + tid] : CUDART_INF_F;
    sq2[tid] = v;
    live = !isinf(v);
  }
  if (!__syncthreads_or(live)) return;
  prologue();
  const int l = bucket_list[b];
  if constexpr (kFilt) {
    for (int w = tid; w < filt.cap_w; w += rt::kGemmThreads)
      sfilt[w] = filt.words[(size_t)l * filt.cap_w + w];
    __syncthreads();
  }
  float ip[4][4];
  for (int c0 = 0; c0 < cap; c0 += rt::kBN) {
    const int c_rows = min(rt::kBN, cap - c0);
    bool valid = false;
    if (tid < rt::kBN) {
      int id = tid < c_rows ? ids[(size_t)l * cap + c0 + tid] : -1;
      if constexpr (kFilt) {
        if (id >= 0 && !passes(sfilt, c0 + tid)) id = -1;
      }
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
    fold(&s[0][0], rt::kBN + 1, sid);
    __syncthreads();
  }
}

// Up to kk = 32: warp w owns queries w + 8 j (j < 8), and lane e holds
// entry e of each of their lists in registers for the whole walk (sorted by
// value; lanes past kk hold nothing read); the rules of the lists.
template <int kN, typename Walk>
__device__ __forceinline__ void pm_walk_reglists(const PmBlock& pb, int G, int kk, PmOut out,
                                                 Walk&& walk) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const size_t out_base = ((size_t)pb.b * G + pb.g0) * kk;
  constexpr int kPerWarp = rt::kBM / kWarps;
  const unsigned in_list = kk >= 32 ? rt::kFull : (1u << kk) - 1u;
  float rv[kPerWarp];
  int ri[kPerWarp];
#pragma unroll
  for (int j = 0; j < kPerWarp; ++j) {
    rv[j] = CUDART_INF_F;
    ri[j] = -1;
  }
  walk([&](const float* s, int stride, const int* sid) {
#pragma unroll
    for (int j = 0; j < kPerWarp; ++j) {
      const int m = warp + kWarps * j;
      if (m >= pb.q_rows) break;   // uniform across the warp
      const float* row = s + m * stride;
      float thr = __shfl_sync(rt::kFull, rv[j], kk - 1);
#pragma unroll
      for (int cc = 0; cc < kN; cc += 32) {
        unsigned mask = __ballot_sync(rt::kFull, row[cc + lane] < thr);
        while (mask) {
          const int src = cc + __ffs(mask) - 1;
          mask &= mask - 1;
          const float cv = row[src];   // every lane reads it
          if (cv < thr) {              // uniform: thr is the warp's
            const int ci = sid[src];
            const int pos = __popc(__ballot_sync(rt::kFull, rv[j] <= cv) & in_list);
            const float uv = __shfl_up_sync(rt::kFull, rv[j], 1);
            const int ui = __shfl_up_sync(rt::kFull, ri[j], 1);
            if (lane > pos) {
              rv[j] = uv;
              ri[j] = ui;
            } else if (lane == pos) {
              rv[j] = cv;
              ri[j] = ci;
            }
            thr = __shfl_sync(rt::kFull, rv[j], kk - 1);
          }
        }
      }
    }
  });
#pragma unroll
  for (int j = 0; j < kPerWarp; ++j) {
    const int m = warp + kWarps * j;
    if (m < pb.q_rows && lane < kk) {
      out.v[out_base + (size_t)m * kk + lane] = rv[j];
      out.i[out_base + (size_t)m * kk + lane] = ri[j];
    }
  }
}

constexpr int kListRegs = rt::kRegK / 32;   // list entries a lane: kk <= 128

// The kk-th entry's value of a list held kListRegs entries a lane (entry e
// in register e / 32 of lane e % 32), on every lane.
__device__ __forceinline__ float reg_kth(const float (&rv)[kListRegs], int kk) {
  const int r = (kk - 1) >> 5;
  float t = rv[0];
#pragma unroll
  for (int j = 1; j < kListRegs; ++j)
    if (r == j) t = rv[j];
  return __shfl_sync(rt::kFull, t, (kk - 1) & 31);
}

// topk.cuh's list_insert on a list held in registers: (cv, ci), below the
// kk-th value, lands after every resident of value <= cv, and the entries
// past it move up one (the kk-th drops out).  Every lane calls it with the
// same (cv, ci).
__device__ __forceinline__ void reg_insert(float (&rv)[kListRegs], int (&ri)[kListRegs],
                                           float cv, int ci, int kk, int lane) {
  int pos = 0;
#pragma unroll
  for (int j = 0; j < kListRegs; ++j)
    if (32 * j < kk) pos += __popc(__ballot_sync(rt::kFull, 32 * j + lane < kk && rv[j] <= cv));
  float tv[kListRegs];
  int ti[kListRegs];
#pragma unroll
  for (int j = 0; j < kListRegs; ++j) {   // entry e - 1, read before any write
    if (32 * j < kk) {
      tv[j] = __shfl_up_sync(rt::kFull, rv[j], 1);
      ti[j] = __shfl_up_sync(rt::kFull, ri[j], 1);
      if (j > 0) {   // lane 0 takes the entry before: lane 31 of register j - 1
        const float last = __shfl_sync(rt::kFull, rv[j > 0 ? j - 1 : 0], 31);
        const int lasti = __shfl_sync(rt::kFull, ri[j > 0 ? j - 1 : 0], 31);
        if (lane == 0) {
          tv[j] = last;
          ti[j] = lasti;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kListRegs; ++j) {
    const int e = 32 * j + lane;
    if (32 * j < kk) {
      if (e > pos) {
        rv[j] = tv[j];
        ri[j] = ti[j];
      } else if (e == pos) {
        rv[j] = cv;
        ri[j] = ci;
      }
    }
  }
}

// Up to kk = 128: the queries' lists lv / li ([kBM][kk], shared), sorted by
// value, written out at the end.  Warp w folds queries w, w + 8, ... of a
// tile: it loads a query's list into registers, offers the tile's scores in
// slot order (a score enters only when strictly below the kk-th value), and
// stores the list back if it changed.
template <int kN, typename Walk>
__device__ __forceinline__ void pm_walk_lists(const PmBlock& pb, int G, int kk, void* fold_mem,
                                              PmOut out, Walk&& walk) {
  float* lv = static_cast<float*>(fold_mem);
  int* li = reinterpret_cast<int*>(lv + rt::kBM * kk);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const size_t out_base = ((size_t)pb.b * G + pb.g0) * kk;

  for (int m = warp; m < pb.q_rows; m += kWarps)
    rt::list_init(lv + m * kk, li + m * kk, kk, lane);
  walk([&](const float* s, int stride, const int* sid) {
    for (int m = warp; m < pb.q_rows; m += kWarps) {
      float* qv = lv + m * kk;
      int* qi = li + m * kk;
      float rv[kListRegs];
      int ri[kListRegs];
#pragma unroll
      for (int j = 0; j < kListRegs; ++j) {
        const int e = 32 * j + lane;
        rv[j] = e < kk ? qv[e] : CUDART_INF_F;
        ri[j] = e < kk ? qi[e] : -1;
      }
      float thr = reg_kth(rv, kk);
      bool changed = false;
      const float* row = s + m * stride;
#pragma unroll
      for (int cc = 0; cc < kN; cc += 32) {
        unsigned mask = __ballot_sync(rt::kFull, row[cc + lane] < thr);
        while (mask) {
          const int src = cc + __ffs(mask) - 1;
          mask &= mask - 1;
          const float cv = row[src];   // every lane reads it
          if (cv < thr) {              // uniform: thr is the warp's
            reg_insert(rv, ri, cv, sid[src], kk, lane);
            thr = reg_kth(rv, kk);
            changed = true;
          }
        }
      }
      if (changed) {
#pragma unroll
        for (int j = 0; j < kListRegs; ++j) {
          const int e = 32 * j + lane;
          if (e < kk) {
            qv[e] = rv[j];
            qi[e] = ri[j];
          }
        }
      }
    }
  });
  __syncwarp();
  for (int m = warp; m < pb.q_rows; m += kWarps) {
    for (int p = lane; p < kk; p += 32) {
      out.v[out_base + (size_t)m * kk + p] = lv[m * kk + p];
      out.i[out_base + (size_t)m * kk + p] = li[m * kk + p];
    }
  }
}

// Past kk = 128: warp w owns queries w, w + 8, ...  A query appends the
// scores of each tile that are below its threshold (+inf at first) to its
// candidate array (kk + extra entries: its output row, then its workspace
// row), in slot order.  When the array may not hold another tile, the warp
// radix-selects its kk-th key, keeps the kk smallest in place (stable, so
// that the array stays in slot order and the lower slot wins a tie) and
// makes that key the threshold; a later score equal to it ranks after all
// kk and never enters, as with the lists.  At the end every array is cut
// to kk, and groups of sort_rows queries sort theirs in shared memory
// (bitonic) by (okey, array position) = (score, slot), the key carrying
// the position, so that each value comes out as stored (a -0.0 score as
// -0.0); slots past the count are (+inf, -1).
template <int kN, typename Walk>
__device__ __forceinline__ void pm_walk_select(const PmBlock& pb, int G, int kk, void* fold_mem,
                                               PmOut out, Walk&& walk) {
  __shared__ float sthr[rt::kBM];
  __shared__ int scnt[rt::kBM];
  __shared__ int shist[kWarps][258];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int q_rows = pb.q_rows;
  const size_t row0 = (size_t)pb.b * G + pb.g0;   // of query 0
  const int entries = kk + out.extra;
  auto slots = [&](int m) {
    float* ov = out.v + (row0 + m) * kk;
    int* oi = out.i + (row0 + m) * kk;
    float* wv = out.ws_v + (row0 + m) * out.extra;
    int* wi = out.ws_i + (row0 + m) * out.extra;
    return [=](int e) {
      return e < kk ? rt::Slot{ov + e, oi + e} : rt::Slot{wv + (e - kk), wi + (e - kk)};
    };
  };

  if (tid < rt::kBM) {
    sthr[tid] = CUDART_INF_F;
    scnt[tid] = 0;
  }
  walk([&](const float* s, int stride, const int* sid) {
    for (int m = warp; m < q_rows; m += kWarps) {
      const float thr = sthr[m];
      int cnt = scnt[m];
      const auto at = slots(m);
      for (int cc = 0; cc < kN; cc += 32) {
        const int c = cc + lane;
        const float v = s[m * stride + c];
        const bool keep = v < thr;
        const unsigned km = __ballot_sync(rt::kFull, keep);
        if (keep) {
          const rt::Slot sl = at(cnt + __popc(km & rt::lanemask_lt(lane)));
          *sl.v = v;
          *sl.i = sid[c];
        }
        cnt += __popc(km);
      }
      if (cnt > entries - kN) {   // the next tile might not fit
        __syncwarp();
        const float t = rt::warp_compact(at, cnt, kk, shist[warp], lane);
        cnt = kk;
        if (lane == 0) sthr[m] = t;
      }
      if (lane == 0) scnt[m] = cnt;
    }
  });
  for (int m = warp; m < q_rows; m += kWarps) {
    if (scnt[m] > kk) {
      __syncwarp();
      rt::warp_compact(slots(m), scnt[m], kk, shist[warp], lane);
      __syncwarp();
      if (lane == 0) scnt[m] = kk;
    }
  }
  __syncthreads();
  const int kp = rt::pow2_at_least(kk);
  auto* skey = static_cast<unsigned long long*>(fold_mem);            // [sort_rows][kp]
  float* sv = reinterpret_cast<float*>(skey + (size_t)out.sort_rows * kp);   // [sort_rows][kk]
  int* si = reinterpret_cast<int*>(sv + (size_t)out.sort_rows * kk);        // [sort_rows][kk]
  for (int m0 = 0; m0 < q_rows; m0 += out.sort_rows) {
    const int nr = min(out.sort_rows, q_rows - m0);
    int most = 0;
    for (int r = 0; r < nr; ++r) most = max(most, scnt[m0 + r]);
    const int n = rt::pow2_at_least(most);   // every row's count fits in n
    if (most > 0) {
      for (int t = tid; t < nr * n; t += rt::kGemmThreads) {
        const int r = t / n;
        const int e = t - r * n;
        unsigned long long key = rt::kPadKey;
        if (e < scnt[m0 + r]) {   // e < kk: the output row holds it
          const float v = out.v[(row0 + m0 + r) * kk + e];
          sv[r * kk + e] = v;
          si[r * kk + e] = out.i[(row0 + m0 + r) * kk + e];
          key = (unsigned long long)rt::okey(v) << 32 | (unsigned)e;
        }
        skey[t] = key;
      }
      rt::block_sort<false>(skey, nullptr, n, nr);
    }
    for (int t = tid; t < nr * kk; t += rt::kGemmThreads) {
      const int r = t / kk;
      const int p = t - r * kk;
      float v = CUDART_INF_F;
      int id = -1;
      if (p < scnt[m0 + r]) {
        const int e = (int)(unsigned)skey[r * n + p];
        v = sv[r * kk + e];
        id = si[r * kk + e];
      }
      out.v[(row0 + m0) * kk + t] = v;
      out.i[(row0 + m0) * kk + t] = id;
    }
    __syncthreads();   // the group's keys are read before the next group's land
  }
}

// The fold of a leg (kFold, a PmFold) over tiles of kN slots.
template <int kFold, int kN, typename Walk>
__device__ __forceinline__ void pm_walk(const PmBlock& pb, int G, int kk, void* fold_mem,
                                        PmOut out, Walk&& walk) {
  if constexpr (kFold == kWideFold)
    pm_walk_select<kN>(pb, G, kk, fold_mem, out, walk);
  else if constexpr (kFold == kLists)
    pm_walk_lists<kN>(pb, G, kk, fold_mem, out, walk);
  else
    pm_walk_reglists<kN>(pb, G, kk, out, walk);
}

// Value e of a 16-byte word of T values, as f32 (exact: a bf16 is the high
// half of its f32, as __bfloat162float makes it).
template <typename T>
__device__ __forceinline__ float qm_elem(const uint4& w, int e) {
  const int byte = e * (int)sizeof(T);
  const unsigned word = byte < 4 ? w.x : byte < 8 ? w.y : byte < 12 ? w.z : w.w;
  const int sh = (byte & 3) * 8;
  if constexpr (std::is_same<T, float>::value) return __uint_as_float(word);
  else if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __uint_as_float(((word >> sh) & 0xffffu) << 16);
  else if constexpr (std::is_same<T, uint8_t>::value) return (float)((word >> sh) & 0xffu);
  else return (float)(int8_t)((word >> sh) & 0xffu);
}

// -- the float legs' product ----------------------------------------------
// T = f32, bf16, uint8 or int8 rows (the 8-bit ones raw values, converted
// exactly).  The old product (a 64 x 64 tile, a 4 x 4 register tile a
// thread reading transposed operands one float at a time, each 32-dimension
// chunk loaded synchronously, the block's queries loaded again for every
// tile) ran at ~13 % of the FMA bound.  This one is #7's scheme
// (fused_argmin.cu) with the queries staged once:
//  - a tile is 64 queries x kPN = 128 slots; thread (qy, sx) owns queries
//    qy + 16 i (i < 4) and slots sx + 16 j (j < 8), a 4 x 8 register tile
//    (a warp covers 4 query rows and 8 slot rows, so each float4 read is
//    conflict-free: one wavefront for the queries, one for the rows).  64
//    queries, not 128, keep the kk <= 128 lists and two blocks on an SM;
//  - the block's queries are staged once, row-major and rounded to bf16
//    where kBf16, for the whole list walk (`sq`, rows padded to a multiple
//    of 32 floats plus 4), up to d = kMaxStagedD; wider queries
//    are staged a chunk at a time beside the rows;
//  - each chunk of 32 dimensions of the tile's rows is copied by cp.async
//    into one of two raw stages, the next chunk in flight while this one is
//    multiplied (rt::stage16: 16-byte copies, narrower ones for rows whose
//    width in bytes is not a multiple of 16); f32 rows are read from the
//    stage as float4, other rows (and f32 rows under kBf16) are first
//    converted once into an f32 stage (exactly, as rt::as_f32, then bf16
//    rounding where kBf16);
//  - a paged tile translates each slot's row once (row_index) into
//    `srow`, read by the copies of every chunk;
//  - the scores go to a [64][kSStride] tile in the stages' memory, which
//    is free once the tile's last chunk is multiplied.
// Every dot product is one f32 accumulator updated by fmaf in dimension
// order, as before, and the score is score()'s _rn epilogue: bitwise the
// plain version.
constexpr int kPN = 128;                 // slots a tile
constexpr int kPRow = rt::kBK + 4;       // floats a row of an f32 stage (16-byte aligned)
constexpr int kSStride = kPN + 8;        // floats a row of the score tile
constexpr int kMaxStagedD = 256;         // widest queries staged once
constexpr size_t kPmSortSmem = 28 * 1024;   // the wide fold's sort: two blocks an SM

// Bytes of a row's chunk in a raw stage (16 more than the chunk: 16-byte
// copies; f32: kPRow floats).
template <typename T>
__host__ __device__ constexpr int pm_raw_row() {
  return rt::kBK * (int)sizeof(T) + 16;
}

// Rows first converted to an f32 stage (all but plain f32 products).
template <typename T, bool kBf16>
__host__ __device__ constexpr bool pm_converts() {
  return kBf16 || !std::is_same<T, float>::value;
}

// Floats a staged query row: d rounded up to 32, plus 4 (rows 16-byte
// aligned and 4 banks apart); past kMaxStagedD one chunk (kPRow).
__host__ __device__ inline int pm_q_stride(int d) {
  return d <= kMaxStagedD ? (d + rt::kBK - 1) / rt::kBK * rt::kBK + 4 : kPRow;
}

// Bytes of the stages (and the f32 stage) or of the score tile, which
// share memory.
template <typename T, bool kBf16>
__host__ __device__ inline size_t pm_union_bytes() {
  const size_t stages = 2 * (size_t)kPN * pm_raw_row<T>() +
                        (pm_converts<T, kBf16>() ? (size_t)kPN * kPRow * sizeof(float) : 0);
  const size_t scores = (size_t)rt::kBM * kSStride * sizeof(float);
  return stages > scores ? stages : scores;
}

// Bytes of a float leg's dynamic shared memory past the fold: the filter
// words, the queries, then the stages / score tile.
template <typename T, bool kBf16>
__host__ __device__ inline size_t pm_leg_smem(int d, int cap_w) {
  return align16((size_t)cap_w * sizeof(int)) +
         align16((size_t)rt::kBM * pm_q_stride(d) * sizeof(float)) +
         pm_union_bytes<T, kBf16>();
}

// Float legs: kBf16 = lut_dtype bfloat16; kFold = pm_fold(kk); kFilt =
// filter words; kPaged = rows through the page table `pg`.  Block i scans
// bucket i / groups for its query group i % groups (groups = G / kBM
// rounded up): a bucket's groups run side by side and share its list's
// reads in L2.  Dynamic shared memory: the fold (fold_smem), the filter
// words, the queries, then the stages / score tile (pm_leg_smem).
template <typename T, bool kBf16, int kFold, bool kFilt, bool kPaged>
__global__ void __launch_bounds__(rt::kGemmThreads, 2)
probe_major_kernel(const int* __restrict__ bucket_list, const float* __restrict__ qg,
                   const float* __restrict__ q2g, const T* __restrict__ data,
                   const float* __restrict__ y2, const int* __restrict__ ids,
                   int G, int cap, int d, int kk, int metric, Filt filt, Pages pg, PmOut out) {
  extern __shared__ float4 pm_dyn16[];
  __shared__ float sq2[rt::kBM];
  __shared__ float sy2[kPN];
  __shared__ int sid[kPN];
  __shared__ long long srow[kPaged ? kPN : 1];
  constexpr int kRaw = pm_raw_row<T>();
  constexpr bool kConv = pm_converts<T, kBf16>();

  unsigned char* base = reinterpret_cast<unsigned char*>(pm_dyn16);
  void* fold_mem = base;
  base += align16(fold_smem(kFold, kk, out.sort_rows));
  int* sfilt = reinterpret_cast<int*>(base);   // [cap_w] (kFilt)
  base += align16((size_t)filt.cap_w * sizeof(int));
  const int qs = pm_q_stride(d);
  const bool staged = d <= kMaxStagedD;
  float* sq = reinterpret_cast<float*>(base);   // [kBM][qs]
  base += align16((size_t)rt::kBM * qs * sizeof(float));
  unsigned char* stages = base;                                   // [2][kPN][kRaw] bytes
  auto stage = [&](int ch) { return stages + (ch & 1) * (kPN * kRaw); };
  float* sb = reinterpret_cast<float*>(base + 2 * kPN * kRaw);   // f32 stage (kConv)
  float* ss = reinterpret_cast<float*>(base);                    // score tile [kBM][kSStride]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int qy = (warp >> 1) * 4 + (lane >> 3);
  const int sx = (warp & 1) * 8 + (lane & 7);
  const int groups = (G + rt::kBM - 1) / rt::kBM;
  const int b = blockIdx.x / groups;
  const int g0 = (blockIdx.x - b * groups) * rt::kBM;
  const int q_rows = min(rt::kBM, G - g0);
  const PmBlock pb{b, g0, q_rows};
  const float* qa = qg + ((size_t)b * G + g0) * d;
  const int nch = (d + rt::kBK - 1) / rt::kBK;
  const int rb = d * (int)sizeof(T);
  const int vec = rt::stage_vec(data, (size_t)rb);
  const unsigned char* bytes = reinterpret_cast<const unsigned char*>(data);

  const int l = bucket_list[b];
  pm_walk<kFold, kPN>(pb, G, kk, fold_mem, out, [&](auto&& fold) {
    bool live = false;
    if (tid < rt::kBM) {
      const float v = tid < q_rows ? q2g[(size_t)b * G + g0 + tid] : CUDART_INF_F;
      sq2[tid] = v;
      live = !isinf(v);
    }
    if (!__syncthreads_or(live)) return;
    if constexpr (kFilt) {
      for (int w = tid; w < filt.cap_w; w += rt::kGemmThreads)
        sfilt[w] = filt.words[(size_t)l * filt.cap_w + w];
    }
    if (staged) {
      for (int e = tid; e < rt::kBM * qs; e += rt::kGemmThreads) {
        const int m = e / qs;
        const int k = e - m * qs;
        const float v = (m < q_rows && k < d) ? qa[(size_t)m * d + k] : 0.0f;
        sq[e] = kBf16 ? rt::round_bf16(v) : v;
      }
    }
    __syncthreads();
    // chunk ch of the tile at c0 into stage ch & 1, one commit group
    auto issue = [&](int c0, int ch) {
      constexpr int kSegs = rt::kBK * (int)sizeof(T) / 16;   // 16-byte copies a row
      unsigned char* st = stage(ch);
#pragma unroll
      for (int s = 0; s < kPN * kSegs / rt::kGemmThreads; ++s) {
        const int idx = tid + s * rt::kGemmThreads;
        const int r = idx / kSegs;
        const int seg = idx - r * kSegs;
        const unsigned char* row = nullptr;
        if (sid[r] >= 0) {
          if constexpr (kPaged) row = bytes + (size_t)srow[r] * rb;
          else row = bytes + ((size_t)l * cap + c0 + r) * rb;
        }
        rt::stage16(st + r * kRaw + 16 * seg, row, ch * rt::kBK * (int)sizeof(T) + 16 * seg, rb,
                    vec, data);
      }
      rt::cp_async_commit();
    };
    for (int c0 = 0; c0 < cap; c0 += kPN) {
      const int c_rows = min(kPN, cap - c0);
      bool valid = false;
      if (tid < kPN) {
        int id = tid < c_rows ? ids[(size_t)l * cap + c0 + tid] : -1;
        if constexpr (kFilt) {
          if (id >= 0 && !passes(sfilt, c0 + tid)) id = -1;
        }
        sid[tid] = id;
        sy2[tid] = tid < c_rows ? y2[(size_t)l * cap + c0 + tid] : 0.0f;
        if constexpr (kPaged) srow[tid] = id >= 0 ? (long long)row_index(pg, l, cap, c0 + tid) : 0;
        valid = id >= 0;
      }
      if (!__syncthreads_or(valid)) continue;
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
      issue(c0, 0);
      for (int ch = 0; ch < nch; ++ch) {
        if (ch + 1 < nch) {
          issue(c0, ch + 1);
          rt::cp_async_wait<1>();
        } else {
          rt::cp_async_wait<0>();
        }
        __syncthreads();
        const int k0 = ch * rt::kBK;
        const float* bs = reinterpret_cast<const float*>(stage(ch));
        if constexpr (kConv) {   // row r, dimensions 16 h .. 16 h + 15
          const int r = tid >> 1;
          const int h = tid & 1;
          const uint4* src =
              reinterpret_cast<const uint4*>(stage(ch) + r * kRaw + h * 16 * (int)sizeof(T));
          float* dst = sb + r * kPRow + 16 * h;
          constexpr int kPerWord = 16 / (int)sizeof(T);
#pragma unroll
          for (int w = 0; w < (int)sizeof(T); ++w) {
            const uint4 word = src[w];
#pragma unroll
            for (int e = 0; e < kPerWord; ++e) {
              const float v = qm_elem<T>(word, e);
              dst[w * kPerWord + e] = kBf16 ? rt::round_bf16(v) : v;
            }
          }
          bs = sb;
        }
        if (!staged) {   // the queries' chunk: row m, dimensions 8 p .. 8 p + 7
          const int m = tid >> 2;
          const int p = tid & 3;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int k = k0 + 8 * p + e;
            const float v = (m < q_rows && k < d) ? qa[(size_t)m * d + k] : 0.0f;
            sq[m * kPRow + 8 * p + e] = kBf16 ? rt::round_bf16(v) : v;
          }
        }
        if (kConv || !staged) __syncthreads();
        const float* as = staged ? sq + k0 : sq;
        const int kn = min(rt::kBK, d - k0);
        int kq = 0;
        for (; kq + 4 <= kn; kq += 4) {   // four dimensions, in order, per pair
          float4 av[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            av[i] = *reinterpret_cast<const float4*>(&as[(qy + 16 * i) * qs + kq]);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float4 bv = *reinterpret_cast<const float4*>(&bs[(sx + 16 * j) * kPRow + kq]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[i][j] = fmaf(av[i].x, bv.x, acc[i][j]);
              acc[i][j] = fmaf(av[i].y, bv.y, acc[i][j]);
              acc[i][j] = fmaf(av[i].z, bv.z, acc[i][j]);
              acc[i][j] = fmaf(av[i].w, bv.w, acc[i][j]);
            }
          }
        }
        for (; kq < kn; ++kq) {
          float av[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = as[(qy + 16 * i) * qs + kq];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float bv = bs[(sx + 16 * j) * kPRow + kq];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(av[i], bv, acc[i][j]);
          }
        }
        __syncthreads();   // the stages are read before the next copies land
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = qy + 16 * i;
        const float q2 = sq2[m];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = sx + 16 * j;
          const bool bad = sid[c] < 0 || isinf(q2);
          ss[m * kSStride + c] = bad ? CUDART_INF_F : score(metric, acc[i][j], q2, sy2[c]);
        }
      }
      __syncthreads();
      fold(ss, kSStride, sid);
      __syncthreads();
    }
  });
}

constexpr int kWords = rt::kBK / 4;   // int8 words (4 dimensions) per chunk

// int8 leg: the block's queries are quantised once into shared memory as a
// transposed [d4][kBM + 1] word array; rows stage kWords words at a time,
// 64 x 64 tiles (pm_scores).  Dynamic shared memory: the fold (fold_smem),
// the query words, then the filter words.
template <bool kWide, bool kFilt, bool kPaged>
__global__ void __launch_bounds__(rt::kGemmThreads)
probe_major_i8_kernel(const int* __restrict__ bucket_list, const float* __restrict__ qg,
                      const float* __restrict__ q2g, const int8_t* __restrict__ data,
                      const float* __restrict__ y2, const int* __restrict__ ids,
                      int G, int cap, int d, int kk, int metric, float scan_scale,
                      Filt filt, Pages pg, PmOut out) {
  extern __shared__ unsigned long long pm_dyn[];   // 8-byte aligned: the sort's keys
  constexpr int kFold = kWide ? kWideFold : kLists;
  int* qw = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(pm_dyn) +
                                   fold_smem(kFold, kk, out.sort_rows));   // [d4][kBM + 1]
  int* sfilt = qw + ((d + 3) / 4) * (rt::kBM + 1);                        // [cap_w] (kFilt)
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

  auto prologue = [&] {
    for (int m = warp; m < rt::kBM; m += rt::kGemmThreads / 32) {
      const float* qrow = m < q_rows ? qg + ((size_t)blockIdx.x * G + g0 + m) * d : nullptr;
      const float sq = quantize_row(qrow, d, qw, kStride, m, lane);
      if (lane == 0) srescale[m] = __fmul_rn(sq, scan_scale);
    }
  };
  auto tile_ip = [&](int l, int c0, int c_rows, float (&ip)[4][4]) {
    const int8_t* rows = data + ((size_t)l * cap + c0) * d;
    size_t mine = 0;   // kPaged: the index of tile row 8 warp + (lane & 7)
    if constexpr (kPaged) {
      const int r = 8 * warp + (lane & 7);
      if (r < c_rows) mine = row_index(pg, l, cap, c0 + r);
    }
    int acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0;
    for (int w0 = 0; w0 < d4; w0 += kWords) {
      __syncthreads();
      if constexpr (kPaged) {   // rows 8 warp + 4 t + lane / 8, word lane % 8
#pragma unroll
        for (int t = 0; t < (rt::kBN * kWords) / rt::kGemmThreads; ++t) {
          const int j = 4 * t + lane / 8;
          const int w = lane % 8;
          sb[w][8 * warp + j] = load_word(data + rt::lane_value(mine, j) * d,
                                          8 * warp + j < c_rows, d, w0 + w);
        }
      } else {
#pragma unroll
        for (int t = 0; t < (rt::kBN * kWords) / rt::kGemmThreads; ++t) {
          const int idx = tid + t * rt::kGemmThreads;
          const int r = idx / kWords;
          const int w = idx % kWords;
          sb[w][r] = load_word(rows + (size_t)r * d, r < c_rows, d, w0 + w);
        }
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
      for (int j = 0; j < 4; ++j) ip[i][j] = __fmul_rn((float)acc[i][j], srescale[ty + 16 * i]);
  };
  const PmBlock pb{(int)blockIdx.x, g0, q_rows};
  pm_walk<kFold, rt::kBN>(pb, G, kk, pm_dyn, out, [&](auto&& fold) {
    pm_scores<kFilt>(pb, bucket_list, q2g, y2, ids, G, cap, metric, filt, sfilt, prologue,
                     tile_ip, fold);
  });
}

// -- query-major ----------------------------------------------------------
// One block scans one query's part of its probed lists, [p_begin, p_end),
// in tiles of kQmRows slots, one row a thread.  It is bound by device-memory
// bytes, so the design keeps copies in flight and every warp busy:
//  - each tile's rows stage kQmChunk bytes at a time through a ring of
//    kQmStages stages by cp.async (16-byte copies where rows are 16-byte
//    aligned, rt::stage16), the next stage streaming in while the block
//    scores the current one; a thread reads its row back as 16-byte words
//    (row stride an odd number of 16-byte words: no bank conflicts) and
//    converts where it reads (bf16, u8 / s8 -> f32; int8 words to __dp4a);
//  - a tile's ids, norms, pass bits and (paged) row indices are loaded a
//    tile ahead into registers, and only its real, passing rows are copied;
//    a tile with none is skipped;
//  - the fold is the block_select.cuh scheme at every kk: at a tile's end
//    every thread holding a score below the threshold appends it to the
//    query's candidate array in shared memory, in slot order (block_rank);
//    when the array may not hold another tile, the block radix-selects its
//    kk-th key, keeps the kk smallest in place and makes that key the
//    threshold; at the end one sort by (okey, array position) =
//    (score, p * cap + slot).
// The dot product of a row is one accumulator in dimension order (fmaf, or
// __dp4a on int8 words), so values are bitwise the plain version's.
constexpr int kQmRows = 256;                  // slots a tile, one a thread
constexpr int kQmChunk = 128;                 // bytes of each row a stage
constexpr int kQmSegs = kQmChunk / 16;        // 16-byte copies a row a stage
constexpr int kQmStride = kQmChunk + 16;      // 9 16-byte words: LDS.128 conflict-free
constexpr int kQmStages = 2;
constexpr int kQmStageBytes = kQmRows * kQmStride;
constexpr int kQmMaxExtra = 1024;

// Candidate array entries past kk: at least one tile, at most kk (one
// compaction per kk - 255 survivors or fewer) and kQmMaxExtra, so that at
// kk = 2048 two blocks still fit an SM.
__host__ __device__ inline int qm_extra(int kk) {
  return kk < kQmRows ? kQmRows : (kk < kQmMaxExtra ? kk : kQmMaxExtra);
}

// One ring slot: a tile's rows.
struct QmMeta {
  long long row[kQmRows];   // index in the row array; -1: padding or failing
  int id[kQmRows];
  float y2[kQmRows];
};

// Dynamic shared memory of a query-major block: the stages (after the walk,
// the final sort's keys), the ring of tiles, the candidate array (values,
// ids), then the query (d floats, or d4 int8 words).
__host__ __device__ inline size_t qm_smem(int kk, int d, bool i8) {
  return (size_t)kQmStages * kQmStageBytes + kQmStages * sizeof(QmMeta) +
         (size_t)(kk + qm_extra(kk)) * (sizeof(float) + sizeof(int)) +
         (size_t)(i8 ? (d + 3) / 4 : d) * 4;
}

// A float leg's dot product: T = f32, bf16, uint8 or int8 rows, converted
// to f32 where read; kBf16 rounds them to bf16 (sq already is).
template <typename T, bool kBf16>
struct QmFloatLeg {
  const float* sq;
  int d;
  float acc;

  __device__ __forceinline__ void chunk(const unsigned char* row, int c) {
    constexpr int kPer = 16 / (int)sizeof(T);
    constexpr int kEpc = kQmChunk / (int)sizeof(T);
    const int k0 = c * kEpc;
    if (c == 0) acc = 0.0f;
    const bool full = k0 + kEpc <= d;
#pragma unroll
    for (int s = 0; s < kQmSegs; ++s) {
      const uint4 w = *reinterpret_cast<const uint4*>(row + 16 * s);
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int k = k0 + s * kPer + e;
        if (full || k < d) {
          const float y = qm_elem<T>(w, e);
          acc = fmaf(sq[k], kBf16 ? rt::round_bf16(y) : y, acc);
        }
      }
    }
  }
  __device__ __forceinline__ float ip() const { return acc; }
};

// The int8 cache's leg: the query quantised into words qw [d4]; the sum of
// int8 products is exact in int32, rescaled once.
struct QmI8Leg {
  const int* qw;
  int d4;
  float rescale;
  int acc;

  __device__ __forceinline__ void chunk(const unsigned char* row, int c) {
    constexpr int kWpc = kQmChunk / 4;
    const int w0 = c * kWpc;
    if (c == 0) acc = 0;
    const bool full = w0 + kWpc <= d4;
#pragma unroll
    for (int s = 0; s < kQmSegs; ++s) {
      const int4 w = *reinterpret_cast<const int4*>(row + 16 * s);
      const int x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = w0 + 4 * s + j;
        if (full || k < d4) acc = __dp4a(qw[k], x[j], acc);
      }
    }
  }
  __device__ __forceinline__ float ip() const { return __fmul_rn((float)acc, rescale); }
};

// The walk and fold of a query-major block (see above); every thread calls
// it.  Writes the block's kk entries at out_v / out_i.
template <typename T, bool kFilt, bool kPaged, typename Leg>
__device__ __forceinline__ void qm_scan(const int* __restrict__ probes, const T* __restrict__ data,
                                        const float* __restrict__ y2g,
                                        const int* __restrict__ ids, int qi, int P, int cap, int d,
                                        int kk, int metric, float q2, int p_begin, int p_end,
                                        Filt filt, Pages pg, unsigned char* smem, Leg& leg,
                                        float* __restrict__ out_v, int* __restrict__ out_i) {
  __shared__ int hist[258];
  __shared__ int wc_rank[2 * rt::kMaxWarps];
  __shared__ int wc_keep[4 * rt::kMaxWarps];
  int par_rank = 0;

  const int tid = threadIdx.x;
  unsigned char* stages = smem;
  QmMeta* meta = reinterpret_cast<QmMeta*>(stages + kQmStages * kQmStageBytes);
  float* cv = reinterpret_cast<float*>(meta + kQmStages);
  int* ci = reinterpret_cast<int*>(cv + kk + qm_extra(kk));
  const int limit = kk + qm_extra(kk) - kQmRows;   // compact past it

  const int* plane = nullptr;
  if constexpr (kFilt)
    plane = filt.words +
            (size_t)(filt.fid != nullptr ? filt.fid[qi] : 0) * filt.n_lists * filt.cap_w;
  const int rb = d * (int)sizeof(T);
  const int n_chunks = (rb + kQmChunk - 1) / kQmChunk;
  const int vec = rt::stage_vec(data, (size_t)rb);
  const unsigned char* bytes = reinterpret_cast<const unsigned char*>(data);

  // this thread's slot of the next tile to look at (np, nc0), loaded ahead
  int np = p_begin, nc0 = 0;
  int pf_id = -1;
  float pf_y2 = 0.0f;
  long long pf_row = -1;
  auto prefetch = [&]() {
    pf_id = -1;
    pf_y2 = 0.0f;
    pf_row = -1;
    if (np >= p_end) return;
    const int l = probes[(size_t)qi * P + np];
    const int c = nc0 + tid;
    if (c >= cap) return;
    int id = ids[(size_t)l * cap + c];
    if constexpr (kFilt) {
      if (id >= 0 && !passes(plane + (size_t)l * filt.cap_w, c)) id = -1;
    }
    pf_id = id;
    pf_y2 = y2g[(size_t)l * cap + c];
    if (id >= 0) {
      if constexpr (kPaged) pf_row = (long long)row_index(pg, l, cap, c);
      else pf_row = (long long)l * cap + c;
    }
  };
  auto advance = [&]() {
    nc0 += kQmRows;
    if (nc0 >= cap) {
      nc0 = 0;
      ++np;
    }
  };

  int tiles = 0;            // tiles taken into the ring
  int chunk = n_chunks;     // next chunk of the newest tile to issue
  int issued = 0;           // steps (tile, chunk) issued
  // Issue the next step's copies into stage issued % kQmStages; false when
  // the walk is over.  Uniform over the block.
  auto issue = [&]() -> bool {
    if (chunk == n_chunks) {
      for (;;) {
        if (np >= p_end) return false;
        const bool any = __syncthreads_or(pf_id >= 0);
        if (any) {
          QmMeta& m = meta[tiles % kQmStages];
          m.row[tid] = pf_row;
          m.id[tid] = pf_id;
          m.y2[tid] = pf_y2;
          ++tiles;
          chunk = 0;
          advance();
          prefetch();
          __syncthreads();
          break;
        }
        advance();
        prefetch();
      }
    }
    const QmMeta& m = meta[(tiles - 1) % kQmStages];
    unsigned char* st = stages + (issued % kQmStages) * kQmStageBytes;
    const int seg = tid % kQmSegs;
    const int off = chunk * kQmChunk + 16 * seg;
#pragma unroll
    for (int j = 0; j < kQmRows * kQmSegs / kQmRows; ++j) {
      const int r = tid / kQmSegs + j * (kQmRows / kQmSegs);
      const long long row = m.row[r];
      rt::stage16(st + r * kQmStride + 16 * seg,
                  row >= 0 ? bytes + (size_t)row * rb : nullptr, off, rb, vec, data);
    }
    ++chunk;
    ++issued;
    return true;
  };

  float thr = CUDART_INF_F;
  int cnt = 0;
  if (!isinf(q2)) {
    prefetch();
    for (int s = 0; s < kQmStages; ++s) {
      issue();
      rt::cp_async_commit();
    }
    for (int i = 0; i < issued; ++i) {
      rt::cp_async_wait<kQmStages - 1>();
      __syncthreads();
      const int c = i % n_chunks;
      const QmMeta& m = meta[(i / n_chunks) % kQmStages];
      const int id = m.id[tid];
      if (id >= 0) leg.chunk(stages + (i % kQmStages) * kQmStageBytes + tid * kQmStride, c);
      if (c == n_chunks - 1) {   // the tile's end: append what beats the threshold
        const float v = id < 0 ? CUDART_INF_F : score(metric, leg.ip(), q2, m.y2[tid]);
        const bool keep = v < thr;
        int total;
        const int pos = rt::block_rank(keep, wc_rank, par_rank, &total);
        if (keep) {
          cv[cnt + pos] = v;
          ci[cnt + pos] = id;
        }
        cnt += total;
        if (cnt > limit) {
          thr = rt::block_compact(cv, ci, cnt, kk, hist, wc_keep);
          cnt = kk;
        }
      }
      __syncthreads();   // the stage is read before its next copies land
      issue();
      rt::cp_async_commit();
    }
    rt::cp_async_wait<0>();
    if (cnt > kk) {
      rt::block_compact(cv, ci, cnt, kk, hist, wc_keep);
      cnt = kk;
    }
  }
  __syncthreads();   // the stages are free: the sort's keys go there
  rt::block_sort_write(cv, ci, cnt, kk, reinterpret_cast<unsigned long long*>(stages), out_v,
                       out_i);
}

// The output row of block (qi, part): [Q][parts][kk].
__device__ __forceinline__ size_t qm_out(int qi, int kk) {
  return ((size_t)qi * gridDim.y + blockIdx.y) * kk;
}

// Float legs: T = float, __nv_bfloat16, uint8_t or int8_t rows; kBf16 =
// lut_dtype bfloat16; kFilt = filter words; kPaged = rows through the page
// table `pg`, each row translated once a tile (row_index) by the thread
// that owns its slot.
template <typename T, bool kBf16, bool kFilt, bool kPaged>
__global__ void __launch_bounds__(kQmRows, 2)
query_major_kernel(const int* __restrict__ probes, const float* __restrict__ q,
                   const float* __restrict__ q2v, const T* __restrict__ data,
                   const float* __restrict__ y2, const int* __restrict__ ids,
                   int P, int cap, int d, int kk, int metric, int p_chunk, Filt filt,
                   Pages pg, float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char qm_dyn[];
  float* sq = reinterpret_cast<float*>(qm_dyn + qm_smem(kk, d, false)) - d;   // [d]
  const int qi = blockIdx.x;
  for (int k = threadIdx.x; k < d; k += kQmRows) {
    const float v = q[(size_t)qi * d + k];
    sq[k] = kBf16 ? rt::round_bf16(v) : v;
  }
  __syncthreads();
  QmFloatLeg<T, kBf16> leg{sq, d, 0.0f};
  const int p_begin = blockIdx.y * p_chunk;
  qm_scan<T, kFilt, kPaged>(probes, data, y2, ids, qi, P, cap, d, kk, metric, q2v[qi], p_begin,
                            min(P, p_begin + p_chunk), filt, pg, qm_dyn, leg,
                            out_v + qm_out(qi, kk), out_i + qm_out(qi, kk));
}

// int8 leg: the query is quantised once into shared memory words.
template <bool kFilt, bool kPaged>
__global__ void __launch_bounds__(kQmRows, 2)
query_major_i8_kernel(const int* __restrict__ probes, const float* __restrict__ q,
                      const float* __restrict__ q2v, const int8_t* __restrict__ data,
                      const float* __restrict__ y2, const int* __restrict__ ids,
                      int P, int cap, int d, int kk, int metric, int p_chunk, Filt filt,
                      Pages pg, float scan_scale, float* __restrict__ out_v,
                      int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char qm_dyn[];
  const int d4 = (d + 3) / 4;
  int* qw = reinterpret_cast<int*>(qm_dyn + qm_smem(kk, d, true)) - d4;   // [d4]
  __shared__ float s_rescale;
  const int qi = blockIdx.x;
  if (threadIdx.x < 32) {
    const float sq = quantize_row(q + (size_t)qi * d, d, qw, 1, 0, threadIdx.x);
    if (threadIdx.x == 0) s_rescale = __fmul_rn(sq, scan_scale);
  }
  __syncthreads();
  QmI8Leg leg{qw, d4, s_rescale, 0};
  const int p_begin = blockIdx.y * p_chunk;
  qm_scan<int8_t, kFilt, kPaged>(probes, data, y2, ids, qi, P, cap, d, kk, metric, q2v[qi],
                                 p_begin, min(P, p_begin + p_chunk), filt, pg, qm_dyn, leg,
                                 out_v + qm_out(qi, kk), out_i + qm_out(qi, kk));
}

// -- launchers ------------------------------------------------------------

// A block may hold more than 48 KB of shared memory in all (static tiles
// plus the dynamic lists) only once its kernel opts in to the dynamic part.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t dynamic) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dynamic);
}

inline bool bad_shape(int kk, int d, int cap, int g) {
  return kk < 1 || kk > rt::kMaxK || d < 1 || cap < 1 || g < 1;
}

// The rows of a C entry: `page_slot` null means monolithic lists
// (page_rows ignored); paged lists need cap to be a multiple of page_rows.
inline Pages make_pages(const int* page_slot, int page_rows, int cap) {
  if (page_slot == nullptr) return Pages{nullptr, 1, 0};
  return Pages{page_slot, page_rows, page_rows > 0 ? cap / page_rows : 0};
}

inline bool bad_pages(const Pages& pg, int cap) {
  return pg.slot != nullptr && (pg.rows < 1 || cap % pg.rows != 0);
}

// The filter of a C entry: `words` null means unfiltered (cap_w ignored).
inline Filt make_filt(const int* words, const int* fid, int n_lists, int cap_w) {
  return Filt{words, fid, n_lists, words != nullptr ? cap_w : 0};
}

// Bytes of dynamic shared memory a probe-major block stages its list's
// filter words in (0 unfiltered).
inline size_t filt_smem(const Filt& f) { return (size_t)f.cap_w * sizeof(int); }

// Bytes of shared memory the final sort of the int8 leg's wide fold may
// take: with that kernel's ~43 KB of static tiles, two blocks an SM.
constexpr size_t kSortSmem = 48 * 1024;

// The probe-major launch of a leg's kernel: B buckets of G / kBM query
// groups, as a grid (B, groups) or, `flat`, one dimension bucket-major
// (the float legs); the fold's (`fold`, a PmFold) dynamic shared memory
// (the wide fold's sort within `sort_budget` bytes) then `leg_smem` bytes
// of the leg's own.  Past kk = 128 `out` carries the candidate workspace
// (extra >= one tile of `tile_n` slots); `args` are the kernel's arguments
// up to its PmOut.
template <typename Kernel, typename... Args>
int launch_pm(Kernel kernel, int B, int G, int kk, int fold, size_t sort_budget, int tile_n,
              size_t leg_smem, bool flat, PmOut out, cudaStream_t stream, Args... args) {
  if (fold == kWideFold) {
    const size_t per_row = fold_smem(kWideFold, kk, 1);
    out.sort_rows = (int)(sort_budget / per_row < 1 ? 1 : sort_budget / per_row);
    if (out.sort_rows > rt::kBM) out.sort_rows = rt::kBM;
    if (out.ws_v == nullptr || out.ws_i == nullptr || out.extra < tile_n || out.extra > kk)
      return (int)cudaErrorInvalidValue;
  }
  const size_t smem = align16(fold_smem(fold, kk, out.sort_rows)) + leg_smem;
  if (smem > rt::kMaxDynamicSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int groups = (G + rt::kBM - 1) / rt::kBM;
  if (flat && (long)B * groups > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const dim3 grid = flat ? dim3(B * groups) : dim3(B, groups);
  kernel<<<grid, rt::kGemmThreads, smem, stream>>>(args..., out);
  return (int)cudaGetLastError();
}

// The float legs' kernel for lists of kk entries: `pick(fold, f, p)` with
// kFold = decltype(fold)::value (pm_fold(kk)), kFilt and kPaged as pick_fp.
template <typename Pick>
static inline auto pick_pm(int kk, bool filtered, bool paged, Pick pick) {
  auto with = [&](auto fold) {
    return pick_fp(filtered, paged, [&](auto f, auto p) { return pick(fold, f, p); });
  };
  const int fold = pm_fold(kk);
  return fold == kWideFold ? with(std::integral_constant<int, kWideFold>{})
         : fold == kLists  ? with(std::integral_constant<int, kLists>{})
                           : with(std::integral_constant<int, kRegLists>{});
}

template <typename T, bool kBf16>
int launch_probe_major(const int* bl, const float* qg, const float* q2g, const T* data,
                       const float* y2, const int* ids, int B, int G, int cap, int d,
                       int kk, int metric, Filt filt, Pages pg, PmOut out,
                       cudaStream_t stream) {
  if (bad_shape(kk, d, cap, G) || bad_pages(pg, cap)) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  auto kernel = pick_pm(kk, filt.words != nullptr, pg.slot != nullptr,
                        [](auto fold, auto f, auto p) {
                          return probe_major_kernel<T, kBf16, decltype(fold)::value,
                                                    decltype(f)::value, decltype(p)::value>;
                        });
  return launch_pm(kernel, B, G, kk, pm_fold(kk), kPmSortSmem, kPN,
                   pm_leg_smem<T, kBf16>(d, filt.cap_w), true, out, stream, bl, qg, q2g, data,
                   y2, ids, G, cap, d, kk, metric, filt, pg);
}

// splits > 1 cuts each query's probes into that many contiguous parts, one
// grid column each (so a serving batch of 64 queries still fills the card);
// their kk entries land in part_v / part_i [Q, splits * kk] and merge_parts
// folds them in probe order.
template <typename Kernel, typename Row, typename... Extra>
int launch_query_major(Kernel kernel, size_t smem, const int* probes, const float* q,
                       const float* q2, const Row* data, const float* y2, const int* ids,
                       int Q, int P, int cap, int d, int kk, int metric, int splits,
                       Filt filt, Pages pg, float* part_v, int* part_i, float* out_v,
                       int* out_i, cudaStream_t stream, Extra... extra) {
  if (bad_shape(kk, d, cap, P) || splits < 1 || bad_pages(pg, cap))
    return (int)cudaErrorInvalidValue;
  if (Q == 0) return (int)cudaSuccess;
  if (smem > rt::kMaxDynamicSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int p_chunk = (P + splits - 1) / splits;
  splits = (P + p_chunk - 1) / p_chunk;
  const bool merge = splits > 1;
  kernel<<<dim3(Q, splits), kQmRows, smem, stream>>>(
      probes, q, q2, data, y2, ids, P, cap, d, kk, metric, p_chunk, filt, pg, extra...,
      merge ? part_v : out_v, merge ? part_i : out_i);
  err = cudaGetLastError();
  if (err != cudaSuccess || !merge) return (int)err;
  return (int)rt::merge_parts(part_v, part_i, Q, splits * kk, kk, out_v, out_i, stream);
}

// The query-major kernel of a float leg (T = f32, bf16, uint8 or int8 rows).
template <typename T, bool kBf16>
auto qm_float_kernel(const Filt& filt, const Pages& pg) {
  return pick_fp(filt.words != nullptr, pg.slot != nullptr, [](auto f, auto p) {
    return query_major_kernel<T, kBf16, decltype(f)::value, decltype(p)::value>;
  });
}

template <typename T>
int float_query_major(const int* probes, const float* q, const float* q2, const T* data,
                      const float* y2, const int* ids, int Q, int P, int cap, int d, int kk,
                      int metric, int splits, int bf16_compute, Filt filt, Pages pg,
                      float* part_v, int* part_i, float* out_v, int* out_i, cudaStream_t s) {
  const size_t smem = qm_smem(kk, d, false);
  return bf16_compute
      ? launch_query_major(qm_float_kernel<T, true>(filt, pg), smem, probes, q, q2, data, y2,
                           ids, Q, P, cap, d, kk, metric, splits, filt, pg, part_v, part_i,
                           out_v, out_i, s)
      : launch_query_major(qm_float_kernel<T, false>(filt, pg), smem, probes, q, q2, data, y2,
                           ids, Q, P, cap, d, kk, metric, splits, filt, pg, part_v, part_i,
                           out_v, out_i, s);
}

}  // namespace
