// Selection building blocks of select_k (#1), fused_knn (#2), the
// probe-major scans past kk = 128 (#3 / #4), the query-major scans (#5 /
// #6) and merge_parts past k = 128, after RAFT's warp-sort / block-select
// (matrix/detail/select_warpsort.cuh, select_radix.cuh): keys that order as
// unsigned integers, bitonic networks in registers (one warp) and in shared
// memory (one block), a radix select of the k-th key, and the compaction of
// a candidate array around it (by one warp, or by the whole block).
// Probe-major up to kk = 128 keeps topk.cuh's lists, as do merge_parts up to
// k = 128 and the single CAGRA hop.
//
// Keys.  A float orders as the unsigned integer `okey`: the sign bit is
// flipped for a positive value and every bit for a negative one, so that
// unsigned order is float order (NaN folded to one key above +inf).
// `okey` holds -0.0 and +0.0 equal; `okey_signed` ranks -0.0 below +0.0
// (the IEEE total order of lax.top_k).  A 64-bit sort key puts okey above
// a 32-bit tie (a position, an id or a column), so that one unsigned
// compare orders (value, tie).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace rt {

constexpr unsigned long long kPadKey = ~0ull;   // above every real key
constexpr int kMaxWarps = 32;                   // warps a block may have

__host__ __device__ inline int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p *= 2;
  return p;
}

__device__ __forceinline__ unsigned okey_signed(float v) {
  if (v != v) return 0xffc00000u;                // NaN: above +inf (0xff800000)
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned okey(float v) {
  return okey_signed(v == 0.0f ? 0.0f : v);
}

// The float of an okey (zeros come back as +0.0).
__device__ __forceinline__ float okey_value(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// -- one warp, keys in registers ------------------------------------------
// Element e of a warp's 32 R elements sits in register e % R of lane e / R,
// so strides below R are exchanges within a lane and the rest are shuffles
// (lane ^ stride / R).  An Item is a 64-bit key, plus a position when two
// items may share a key (kTwo: select_k's stable mode).

template <bool kTwo>
struct Item {
  unsigned long long k;
  int p;
};

template <bool kTwo>
__device__ __forceinline__ bool item_less(const Item<kTwo>& a, const Item<kTwo>& b) {
  if constexpr (kTwo) return a.k < b.k || (a.k == b.k && a.p < b.p);
  return a.k < b.k;
}

template <bool kTwo>
__device__ __forceinline__ Item<kTwo> shfl_xor_item(const Item<kTwo>& a, int mask) {
  Item<kTwo> o;
  o.k = __shfl_xor_sync(0xffffffffu, a.k, mask);
  if constexpr (kTwo) o.p = __shfl_xor_sync(0xffffffffu, a.p, mask);
  else o.p = 0;
  return o;
}

// One compare-exchange stage of a bitonic network over the warp's 32 R
// items: partners e and e ^ stride; the pair is ascending where e & size is
// 0 (size = 32 R: every pair ascending).
template <int R, bool kTwo>
__device__ __forceinline__ void warp_stage(Item<kTwo> (&x)[R], int size, int stride, int lane) {
  if (stride < R) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int jp = j ^ stride;
      if (jp > j) {
        const int e = lane * R + j;
        const bool asc = (e & size) == 0;
        if (item_less(x[jp], x[j]) == asc) {
          const Item<kTwo> t = x[j];
          x[j] = x[jp];
          x[jp] = t;
        }
      }
    }
  } else {
    const int lm = stride / R;
    const bool lower = (lane & lm) == 0;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int e = lane * R + j;
      const bool asc = (e & size) == 0;
      const Item<kTwo> o = shfl_xor_item(x[j], lm);
      // the lower element of an ascending pair keeps the smaller one
      const bool take_small = lower == asc;
      if (item_less(o, x[j]) == take_small) x[j] = o;
    }
  }
}

__host__ __device__ constexpr int log2_of(int v) { return v <= 1 ? 0 : 1 + log2_of(v / 2); }

// Sort the warp's 32 R items ascending.  (Loops over exponents, so that
// they unroll and every register index is a constant.)
template <int R, bool kTwo>
__device__ __forceinline__ void warp_sort(Item<kTwo> (&x)[R], int lane) {
  constexpr int kLog = log2_of(32 * R);
#pragma unroll
  for (int ls = 1; ls <= kLog; ++ls)
#pragma unroll
    for (int ss = ls - 1; ss >= 0; --ss) warp_stage<R, kTwo>(x, 1 << ls, 1 << ss, lane);
}

// q (sorted ascending) becomes the 32 R smallest of q and c (c sorted
// ascending), sorted: min(q[e], c[32 R - 1 - e]) is bitonic and holds them.
template <int R, bool kTwo>
__device__ __forceinline__ void warp_merge(Item<kTwo> (&q)[R], const Item<kTwo> (&c)[R],
                                           int lane) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const Item<kTwo> o = shfl_xor_item(c[R - 1 - j], 31);   // element 32 R - 1 - e
    if (item_less(o, q[j])) q[j] = o;
  }
  constexpr int kLog = log2_of(32 * R);
#pragma unroll
  for (int ss = kLog - 1; ss >= 0; --ss) warp_stage<R, kTwo>(q, 32 * R, 1 << ss, lane);
}

// -- one block, keys in shared memory ---------------------------------------
// Sort n (a power of two) items ascending: 64-bit keys, and with kTwo a
// position that breaks equal keys; `segs` > 1 sorts that many runs of n
// items, one after another in `key`, each on its own.  Every thread of the
// block calls it.

template <bool kTwo>
__device__ void block_sort(unsigned long long* key, int* pos, int n, int segs = 1) {
  for (int size = 2; size <= n; size *= 2) {
    for (int stride = size / 2; stride > 0; stride /= 2) {
      __syncthreads();
      for (int t = threadIdx.x; t < segs * (n / 2); t += blockDim.x) {
        const int lo = 2 * t - (t & (stride - 1));   // the pair (lo, lo + stride)
        const int hi = lo + stride;
        // runs of `size` alternate direction within a segment; the last
        // merge (size n) sorts every segment ascending
        const bool asc = size == n || (lo & size) == 0;
        const unsigned long long a = key[lo], b = key[hi];
        bool swap;
        if constexpr (kTwo) {
          const int pa = pos[lo], pb = pos[hi];
          swap = (b < a || (b == a && pb < pa)) == asc;
          if (swap) {
            pos[lo] = pb;
            pos[hi] = pa;
          }
        } else {
          swap = (b < a) == asc;
        }
        if (swap) {
          key[lo] = b;
          key[hi] = a;
        }
      }
    }
  }
  __syncthreads();
}

// -- radix select -----------------------------------------------------------
// The k-th smallest of the 32-bit keys at indices [0, n) (1 <= k <= the
// number of keys) by four passes of eight
// bits, most significant first, over a 256-bin histogram `hist` in shared
// memory (258 ints); `key_at(e, key)` sets key e and returns false for an
// index that holds none.  Returns the key; *below is the count of keys
// strictly smaller.  kBlock: the whole block calls it (indices split over
// its threads, blockDim.x a multiple of 32); else one warp does (lanes
// split them), with a `hist` of its own.

template <bool kBlock, typename KeyAt>
__device__ unsigned radix_select(KeyAt key_at, int n, int k, int* hist, int* below) {
  const int tid = kBlock ? threadIdx.x : (threadIdx.x & 31);
  const int nt = kBlock ? blockDim.x : 32;
  auto sync = [] {
    if constexpr (kBlock) __syncthreads();
    else __syncwarp();
  };
  unsigned prefix = 0u, mask = 0u;
  int rank = k;   // the rank still to find among the keys matching prefix
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = tid; b < 256; b += nt) hist[b] = 0;
    sync();
    // plain atomics, no warp vote in the loop: the loads of many
    // iterations stay in flight (a vote a round to merge a warp's adds to
    // one bin made the k = 2048 fused_knn 50 % slower)
    for (int e = tid; e < n; e += nt) {
      unsigned key;
      if (key_at(e, key) && (key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 255u], 1);
    }
    sync();
    // the bin where the cumulative count reaches rank: the first warp scans
    // eight bins a lane and leaves (bin, count before it) in hist[256..257]
    if (tid < 32) {
      int own = 0;
#pragma unroll
      for (int b = 0; b < 8; ++b) own += hist[8 * tid + b];
      int incl = own;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const int o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      const int excl = incl - own;
      if (excl < rank && rank <= incl) {
        int c = excl;
        for (int b = 0; b < 8; ++b) {
          const int h = hist[8 * tid + b];
          if (c + h >= rank) {
            hist[256] = 8 * tid + b;
            hist[257] = c;
            break;
          }
          c += h;
        }
      }
    }
    sync();
    rank -= hist[257];
    prefix |= (unsigned)hist[256] << shift;
    mask |= 255u << shift;
    sync();
  }
  *below = k - rank;
  return prefix;
}

// -- candidate arrays ---------------------------------------------------------
// A candidate array holds (value, id) entries in the order they were
// offered.  `slot(e)` gives the addresses of entry e (so that an array may
// span two buffers).

struct Slot {
  float* v;
  int* i;
};

__device__ __forceinline__ unsigned lanemask_lt(int lane) { return (1u << lane) - 1u; }

// One warp: keep the k smallest (okey, then array position) of the cnt
// entries of a candidate array, in place and in their order; returns the
// k-th value (the array's new threshold: a later entry must be below it).
// (A whole block compacting one array at a time, staged in shared memory,
// made fused_knn's k = 10 12 % slower: at a small k every row compacts at
// once after the first tiles, and eight warps do eight rows at a time.)
template <typename SlotAt>
__device__ float warp_compact(SlotAt slot, int cnt, int k, int* hist, int lane) {
  int below;
  const unsigned kth = radix_select<false>(
      [&](int e, unsigned& key) {
        key = okey(*slot(e).v);
        return true;
      },
      cnt, k, hist, &below);
  const int need_eq = k - below;   // of the entries equal to the k-th, the first need_eq stay
  int w = 0, eq = 0;
  for (int e0 = 0; e0 < cnt; e0 += 32) {
    const int e = e0 + lane;
    float v = 0.0f;
    int id = 0;
    unsigned key = ~0u;
    if (e < cnt) {
      const Slot s = slot(e);
      v = *s.v;
      id = *s.i;
      key = okey(v);
    }
    const bool is_eq = e < cnt && key == kth;
    const unsigned eqm = __ballot_sync(0xffffffffu, is_eq);
    const bool keep =
        (e < cnt && key < kth) || (is_eq && eq + __popc(eqm & lanemask_lt(lane)) < need_eq);
    const unsigned km = __ballot_sync(0xffffffffu, keep);
    __syncwarp();   // the chunk is read before any lane writes (writes go at or below it)
    if (keep) {
      const Slot s = slot(w + __popc(km & lanemask_lt(lane)));
      *s.v = v;
      *s.i = id;
    }
    w += __popc(km);
    eq += __popc(eqm);
    __syncwarp();
  }
  return okey_value(kth);
}

// -- candidate arrays of a whole block ---------------------------------------
// One array per block (query-major holds one query a block; merge_parts one
// row), so the whole block appends, compacts and sorts it: no warp waits at
// a barrier while another folds.

// This thread's rank among the threads before it (in thread order) whose
// `keep` is set; *total: all of them.  One __syncthreads; `wc` [2][kMaxWarps]
// ints, `parity` flipped by the call so that the next call writes the other
// half while a slow thread may still read this one.
__device__ __forceinline__ int block_rank(bool keep, int* wc, int& parity, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const unsigned m = __ballot_sync(0xffffffffu, keep);
  int* w = wc + parity * kMaxWarps;
  parity ^= 1;
  if (lane == 0) w[warp] = __popc(m);
  __syncthreads();
  int before = 0, all = 0;
  for (int i = 0; i < nw; ++i) {
    const int c = w[i];
    before += i < warp ? c : 0;
    all += c;
  }
  *total = all;
  return before + __popc(m & lanemask_lt(lane));
}

// Of the n entries `at(e)` gives, keep those whose okey is below kth and the
// first need_eq equal to it, in their order: kept entry w goes to `to(w)`.
// Returns the count kept.  In place (to == at) is allowed: a round reads
// blockDim.x entries into registers before its sync and writes at or below
// them after it.  `wc` [2][2][kMaxWarps] ints and `parity` as block_rank.
// Ends with a __syncthreads, so the kept entries can be read at once.
template <typename At, typename To>
__device__ int block_keep(At at, To to, int n, unsigned kth, int need_eq, int* wc, int& parity) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int kept = 0, eq_seen = 0;
  for (int e0 = 0; e0 < n; e0 += blockDim.x) {
    const int e = e0 + threadIdx.x;
    float v = 0.0f;
    int id = 0;
    unsigned key = ~0u;
    if (e < n) {
      const Slot s = at(e);
      v = *s.v;
      id = *s.i;
      key = okey(v);
    }
    const bool lt = e < n && key < kth;
    const bool eq = e < n && key == kth;
    const unsigned ltm = __ballot_sync(0xffffffffu, lt);
    const unsigned eqm = __ballot_sync(0xffffffffu, eq);
    int* w = wc + parity * 2 * kMaxWarps;
    parity ^= 1;
    if (lane == 0) {
      w[warp] = __popc(ltm);
      w[kMaxWarps + warp] = __popc(eqm);
    }
    __syncthreads();
    // warp i keeps its lt entries and the first equal ones while the
    // budget lasts, in warp order
    int eq_before = eq_seen, pos = kept, round = 0;
    for (int i = 0; i < nw; ++i) {
      const int li = w[i], ei = w[kMaxWarps + i];
      const int take = min(max(need_eq - eq_before, 0), ei);
      if (i < warp) {
        pos += li + take;
      }
      if (i == warp) {
        const int my_eq = eq_before + __popc(eqm & lanemask_lt(lane));
        const bool keep = lt || (eq && my_eq < need_eq);
        const unsigned km = __ballot_sync(0xffffffffu, keep);
        if (keep) {
          const Slot s = to(pos + __popc(km & lanemask_lt(lane)));
          *s.v = v;
          *s.i = id;
        }
      }
      eq_before += ei;
      round += li + take;
    }
    kept += round;
    eq_seen = eq_before;
  }
  __syncthreads();
  return kept;
}

// Sort the n entries (cv[e], ci[e]) of a candidate array in shared memory
// by (okey, e) and write the first k to out_v / out_i, (+inf, -1) past n.
// `keys`: pow2_at_least(n) 64-bit keys of shared memory.  Each value comes
// out as stored (a -0.0 as -0.0).  Out of line: it runs once a block.
static __device__ __noinline__ void block_sort_write(const float* cv, const int* ci, int n,
                                                     int k, unsigned long long* keys,
                                                     float* __restrict__ out_v,
                                                     int* __restrict__ out_i) {
  const int np = pow2_at_least(max(n, 1));
  for (int t = threadIdx.x; t < np; t += blockDim.x)
    keys[t] = t < n ? (unsigned long long)okey(cv[t]) << 32 | (unsigned)t : kPadKey;
  block_sort<false>(keys, nullptr, np);
  for (int p = threadIdx.x; p < k; p += blockDim.x) {
    float v = CUDART_INF_F;
    int id = -1;
    if (p < n) {
      const int e = (int)(unsigned)keys[p];
      v = cv[e];
      id = ci[e];
    }
    out_v[p] = v;
    out_i[p] = id;
  }
}

// Keep the k smallest (okey, position) of a candidate array of cnt > k
// entries in shared memory (values cv, ids ci), in place and in their
// order; returns the k-th value (the new threshold).  `hist`: 258 ints,
// `wc`: block_keep's (a call starts at parity 0: the previous one ended
// at a barrier).  Out of line: a compaction is rare (one per ~kk
// survivors).
static __device__ __noinline__ float block_compact(float* cv, int* ci, int cnt, int k, int* hist,
                                                   int* wc) {
  int parity = 0;
  __syncthreads();   // the array's last appends are visible
  int below;
  const unsigned kth = radix_select<true>(
      [&](int e, unsigned& key) {
        key = okey(cv[e]);
        return true;
      },
      cnt, k, hist, &below);
  auto slot = [&](int e) { return Slot{cv + e, ci + e}; };
  block_keep(slot, slot, cnt, kth, k - below, wc, parity);
  return okey_value(kth);
}

// -- merge_parts past k = 128 ------------------------------------------------
// Row r's n_cand candidates are `splits` sorted parts of k (value, id),
// parts in pool order.  The row's k smallest by (value, position in the
// row) = (value, part, position in the part), the order the lists' merge
// keeps: a radix select of the k-th key over the row's finite values (a
// part's +inf tail never enters, as a list never admits +inf), the
// entries below it and the first equal ones compacted in order into shared
// memory, then one sort.  One block a row.  Dynamic shared memory:
// merge_select_smem(k).
constexpr int kMergeThreads = 256;

__host__ __device__ inline size_t merge_select_smem(int k) {
  return (size_t)pow2_at_least(k) * sizeof(unsigned long long) +
         (size_t)k * (sizeof(float) + sizeof(int));
}

static __global__ void __launch_bounds__(kMergeThreads)
merge_select_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
                    int n_cand, int k, float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ unsigned long long ms_dyn[];
  unsigned long long* keys = ms_dyn;                            // [pow2 >= k]
  float* cv = reinterpret_cast<float*>(keys + pow2_at_least(k));   // [k]
  int* ci = reinterpret_cast<int*>(cv + k);                        // [k]
  __shared__ int hist[258];
  __shared__ int wc[4 * kMaxWarps];
  __shared__ int s_finite;
  int parity = 0;
  const size_t row = blockIdx.x;
  const float* pv = part_v + row * n_cand;
  const int* pi = part_i + row * n_cand;

  if (threadIdx.x == 0) s_finite = 0;
  __syncthreads();
  int own = 0;
  for (int e = threadIdx.x; e < n_cand; e += blockDim.x) own += pv[e] < CUDART_INF_F ? 1 : 0;
  own = __reduce_add_sync(0xffffffffu, own);
  if ((threadIdx.x & 31) == 0) atomicAdd(&s_finite, own);
  __syncthreads();
  const int finite = s_finite;
  unsigned kth = okey(CUDART_INF_F);   // every finite entry is below it
  int need_eq = 0;
  if (finite > k) {
    int below;
    kth = radix_select<true>(
        [&](int e, unsigned& key) {
          const float v = pv[e];
          key = okey(v);
          return v < CUDART_INF_F;
        },
        n_cand, k, hist, &below);
    need_eq = k - below;
  }
  const int cnt = block_keep(
      [&](int e) { return Slot{const_cast<float*>(pv + e), const_cast<int*>(pi + e)}; },
      [&](int w) { return Slot{cv + w, ci + w}; }, n_cand, kth, need_eq, wc, parity);
  block_sort_write(cv, ci, cnt, k, keys, out_v + row * k, out_i + row * k);
}

}  // namespace rt
