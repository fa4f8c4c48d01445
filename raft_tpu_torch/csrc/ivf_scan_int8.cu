// IVF list scans, int8 rows of a scaled cache (IVF-PQ): the C entries of
// both schedules (the kernels and launchers are ivf_scan.cuh).

#include "ivf_scan.cuh"

// -- C entries: probe-major ----------------------------------------------
// filt: [n_lists][cap_w] pass words, or null for the unfiltered leg.
// page_slot: the page table [n_lists * cap / page_rows] of a pool of pages
// passed as `data` ([slots][page_rows][d]), or null for monolithic lists.
// ws_v / ws_i / ws_extra: as the f32 entry (ivf_scan_f32.cu).

extern "C" int rt_ivf_scan_probe_major_int8(const int* bucket_list, const float* qg,
                                            const float* q2g, const void* data,
                                            const float* y2, const int* ids, int B, int G,
                                            int cap, int d, int kk, int metric,
                                            float scan_scale, const int* filt, int cap_w,
                                            const int* page_slot, int page_rows,
                                            float* ws_v, int* ws_i, int ws_extra,
                                            float* out_v, int* out_i, void* stream) {
  const Pages pg = make_pages(page_slot, page_rows, cap);
  if (bad_shape(kk, d, cap, G) || bad_pages(pg, cap)) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const Filt f = make_filt(filt, nullptr, 0, cap_w);
  // the block's quantised queries, then the filter words
  const size_t leg = (size_t)((d + 3) / 4) * (rt::kBM + 1) * sizeof(int) + filt_smem(f);
  auto kernel = pick_leg(kk, f.words != nullptr, pg.slot != nullptr,
                         [](auto w, auto fl, auto p) {
                           return probe_major_i8_kernel<decltype(w)::value, decltype(fl)::value,
                                                        decltype(p)::value>;
                         });
  return launch_pm(kernel, B, G, kk, kk > rt::kRegK ? kWideFold : kLists, kSortSmem, rt::kBN,
                   leg, false, PmOut{out_v, out_i, ws_v, ws_i, ws_extra, 0},
                   (cudaStream_t)stream, bucket_list, qg, q2g, static_cast<const int8_t*>(data),
                   y2, ids, G, cap, d, kk, metric, scan_scale, f, pg);
}

// -- C entries: query-major ----------------------------------------------
// filt: pass words, [n_lists][cap_w], or [F][n_lists][cap_w] with fid [Q]
// naming each query's plane (the query_fid leg); null filt: unfiltered.
// page_slot / page_rows: as probe-major.

extern "C" int rt_ivf_scan_query_major_int8(const int* probes, const float* q,
                                            const float* q2, const void* data,
                                            const float* y2, const int* ids, int Q, int P,
                                            int cap, int d, int kk, int metric, int splits,
                                            float scan_scale, const int* filt, const int* fid,
                                            int n_lists, int cap_w, const int* page_slot,
                                            int page_rows, float* part_v, int* part_i,
                                            float* out_v, int* out_i, void* stream) {
  const Filt f = make_filt(filt, fid, n_lists, cap_w);
  const Pages pg = make_pages(page_slot, page_rows, cap);
  auto kernel = pick_fp(f.words != nullptr, pg.slot != nullptr, [](auto fl, auto p) {
    return query_major_i8_kernel<decltype(fl)::value, decltype(p)::value>;
  });
  return launch_query_major(kernel, qm_smem(kk, d, true), probes, q, q2,
                            static_cast<const int8_t*>(data), y2, ids, Q, P, cap, d, kk,
                            metric, splits, f, pg, part_v, part_i, out_v, out_i,
                            (cudaStream_t)stream, scan_scale);
}
