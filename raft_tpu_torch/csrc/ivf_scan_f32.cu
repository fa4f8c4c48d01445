// IVF list scans, f32 rows: the C entries of both schedules (the kernels
// and launchers are ivf_scan.cuh).

#include "ivf_scan.cuh"

// -- C entries: probe-major ----------------------------------------------
// filt: [n_lists][cap_w] pass words, or null for the unfiltered leg.
// page_slot: the page table [n_lists * cap / page_rows] of a pool of pages
// passed as `data` ([slots][page_rows][d]), or null for monolithic lists.
// ws_v / ws_i: past kk = 128, the candidate workspace [B][G][ws_extra]
// (64 <= ws_extra <= kk; PmOut in ivf_scan.cuh), else null.

extern "C" int rt_ivf_scan_probe_major(const int* bucket_list, const float* qg,
                                       const float* q2g, const float* data,
                                       const float* y2, const int* ids, int B, int G,
                                       int cap, int d, int kk, int metric, int bf16_compute,
                                       const int* filt, int cap_w, const int* page_slot,
                                       int page_rows, float* ws_v, int* ws_i, int ws_extra,
                                       float* out_v, int* out_i, void* stream) {
  auto s = (cudaStream_t)stream;
  const Filt f = make_filt(filt, nullptr, 0, cap_w);
  const Pages pg = make_pages(page_slot, page_rows, cap);
  const PmOut out{out_v, out_i, ws_v, ws_i, ws_extra, 0};
  return bf16_compute
      ? launch_probe_major<float, true>(bucket_list, qg, q2g, data, y2, ids, B, G, cap, d,
                                        kk, metric, f, pg, out, s)
      : launch_probe_major<float, false>(bucket_list, qg, q2g, data, y2, ids, B, G, cap, d,
                                         kk, metric, f, pg, out, s);
}

// -- C entries: query-major ----------------------------------------------
// filt: pass words, [n_lists][cap_w], or [F][n_lists][cap_w] with fid [Q]
// naming each query's plane (the query_fid leg); null filt: unfiltered.
// page_slot / page_rows: as probe-major.

extern "C" int rt_ivf_scan_query_major(const int* probes, const float* q, const float* q2,
                                       const float* data, const float* y2, const int* ids,
                                       int Q, int P, int cap, int d, int kk, int metric,
                                       int splits, int bf16_compute, const int* filt,
                                       const int* fid, int n_lists, int cap_w,
                                       const int* page_slot, int page_rows, float* part_v,
                                       int* part_i, float* out_v, int* out_i, void* stream) {
  return float_query_major(probes, q, q2, data, y2, ids, Q, P, cap, d, kk, metric, splits,
                           bf16_compute, make_filt(filt, fid, n_lists, cap_w),
                           make_pages(page_slot, page_rows, cap), part_v, part_i, out_v,
                           out_i, (cudaStream_t)stream);
}
