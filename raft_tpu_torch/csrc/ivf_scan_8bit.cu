// IVF list scans, uint8 / int8 rows holding raw values (IVF-Flat over an
// 8-bit dataset): the C entries of both schedules (the kernels and
// launchers are ivf_scan.cuh).
//
// raft_tpu stores such lists in the dataset's dtype and scans them upcast
// to f32 at scan_dtype "highest" (its XLA leg; its Pallas scan admits int8
// only as IVF-PQ's scaled cache).  Here the float legs' kernels take T =
// uint8_t / int8_t: each value is converted to f32 where it is staged, and
// the product is the f32 legs' fmaf chain in dimension order, bitwise the
// plain version's sequential_dot over the upcast rows.  This is not the
// int8 cache's leg, which quantises the queries.  bf16_compute must be 0.
// A page table (page_slot) takes the paged instantiations of the same
// kernels (kPaged), as for f32 rows: raft_tpu pages such lists through its
// XLA gather.

#include "ivf_scan.cuh"

namespace {

template <typename T>
int probe_major_8bit(const int* bucket_list, const float* qg, const float* q2g, const void* data,
                     const float* y2, const int* ids, int B, int G, int cap, int d, int kk,
                     int metric, int bf16_compute, const int* filt, int cap_w,
                     const int* page_slot, int page_rows, float* ws_v, int* ws_i,
                     int ws_extra, float* out_v, int* out_i, void* stream) {
  if (bf16_compute) return (int)cudaErrorInvalidValue;
  return launch_probe_major<T, false>(
      bucket_list, qg, q2g, static_cast<const T*>(data), y2, ids, B, G, cap, d, kk, metric,
      make_filt(filt, nullptr, 0, cap_w), make_pages(page_slot, page_rows, cap),
      PmOut{out_v, out_i, ws_v, ws_i, ws_extra, 0}, (cudaStream_t)stream);
}

template <typename T>
int query_major_8bit(const int* probes, const float* q, const float* q2, const void* data,
                     const float* y2, const int* ids, int Q, int P, int cap, int d, int kk,
                     int metric, int splits, int bf16_compute, const int* filt, const int* fid,
                     int n_lists, int cap_w, const int* page_slot, int page_rows,
                     float* part_v, int* part_i, float* out_v, int* out_i, void* stream) {
  if (bf16_compute) return (int)cudaErrorInvalidValue;
  const Filt f = make_filt(filt, fid, n_lists, cap_w);
  const Pages pg = make_pages(page_slot, page_rows, cap);
  return launch_query_major(qm_float_kernel<T, false>(f, pg), qm_smem(kk, d, false), probes, q, q2,
                            static_cast<const T*>(data), y2, ids, Q, P, cap, d, kk, metric,
                            splits, f, pg, part_v, part_i, out_v, out_i, (cudaStream_t)stream);
}

}  // namespace

// Arguments as the bf16 entries (ivf_scan_bf16.cu).

extern "C" int rt_ivf_scan_probe_major_u8(const int* bucket_list, const float* qg,
                                          const float* q2g, const void* data, const float* y2,
                                          const int* ids, int B, int G, int cap, int d, int kk,
                                          int metric, int bf16_compute, const int* filt,
                                          int cap_w, const int* page_slot, int page_rows,
                                          float* ws_v, int* ws_i, int ws_extra, float* out_v,
                                          int* out_i, void* stream) {
  return probe_major_8bit<uint8_t>(bucket_list, qg, q2g, data, y2, ids, B, G, cap, d, kk,
                                   metric, bf16_compute, filt, cap_w, page_slot, page_rows,
                                   ws_v, ws_i, ws_extra, out_v, out_i, stream);
}

extern "C" int rt_ivf_scan_probe_major_s8(const int* bucket_list, const float* qg,
                                          const float* q2g, const void* data, const float* y2,
                                          const int* ids, int B, int G, int cap, int d, int kk,
                                          int metric, int bf16_compute, const int* filt,
                                          int cap_w, const int* page_slot, int page_rows,
                                          float* ws_v, int* ws_i, int ws_extra, float* out_v,
                                          int* out_i, void* stream) {
  return probe_major_8bit<int8_t>(bucket_list, qg, q2g, data, y2, ids, B, G, cap, d, kk,
                                  metric, bf16_compute, filt, cap_w, page_slot, page_rows,
                                  ws_v, ws_i, ws_extra, out_v, out_i, stream);
}

extern "C" int rt_ivf_scan_query_major_u8(const int* probes, const float* q, const float* q2,
                                          const void* data, const float* y2, const int* ids,
                                          int Q, int P, int cap, int d, int kk, int metric,
                                          int splits, int bf16_compute, const int* filt,
                                          const int* fid, int n_lists, int cap_w,
                                          const int* page_slot, int page_rows, float* part_v,
                                          int* part_i, float* out_v, int* out_i, void* stream) {
  return query_major_8bit<uint8_t>(probes, q, q2, data, y2, ids, Q, P, cap, d, kk, metric,
                                   splits, bf16_compute, filt, fid, n_lists, cap_w, page_slot,
                                   page_rows, part_v, part_i, out_v, out_i, stream);
}

extern "C" int rt_ivf_scan_query_major_s8(const int* probes, const float* q, const float* q2,
                                          const void* data, const float* y2, const int* ids,
                                          int Q, int P, int cap, int d, int kk, int metric,
                                          int splits, int bf16_compute, const int* filt,
                                          const int* fid, int n_lists, int cap_w,
                                          const int* page_slot, int page_rows, float* part_v,
                                          int* part_i, float* out_v, int* out_i, void* stream) {
  return query_major_8bit<int8_t>(probes, q, q2, data, y2, ids, Q, P, cap, d, kk, metric,
                                  splits, bf16_compute, filt, fid, n_lists, cap_w, page_slot,
                                  page_rows, part_v, part_i, out_v, out_i, stream);
}
