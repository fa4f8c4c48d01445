// Deterministic CSR x dense product: out[r][c] = sum over the slots s of
// row r, in slot order, of data[s] * x[indices[s]][c].
//
// Replaces no TPU kernel.  raft_tpu sums these rows with XLA's segment_sum
// (raft_tpu/sparse/linalg.py:31,134, op.py:47, distance.py:94-96), whose
// CPU and TPU lowerings add each segment in slot order.  On the card the
// port needs the same sums run after run: index_add_ / scatter_add_ add by
// atomics in an order that changes between runs (two Lanczos runs with one
// seed would differ), and ops.matrix.segment_sum's one-hot product per
// block of rows does not scale to a million segments.
//
// Arithmetic: each term rounds once as a product (__fmul_rn) and is then
// added to the running sum (__fadd_rn), never fused into an fmaf: raft_tpu
// forms contrib = data * x and then sums it.  The sum starts at +0.0, so a
// row with no slots writes +0.0.  kernels/csr_spmm.py's plain version adds
// the same terms in the same order over a [rows, max degree] view, so the
// two agree bitwise.
//
// What bounds it on the H100: the bytes.  Each slot reads its index, its
// value and one gathered x element (8 + 4 bytes a slot for one column),
// against one multiply and one add, so a 30M-slot SpMV needs ~0.1 ms at
// 3.35 TB/s.  One warp takes one row: its lanes load 32 consecutive slots
// at once (coalesced) and form the 32 products in parallel, then every lane
// adds the 32 products to the running sum in slot order through warp
// shuffles, so the order of the sum is the slot order whatever the row's
// degree; a hub row of R-MAT (degree ~10^5) costs its warp ~3,000 such
// rounds while the other warps go on.  Columns past the first are taken one
// after another by the same warp (the slots are read again, from L1 / L2).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;   // warps (rows) a block

__global__ void __launch_bounds__(kWarps * 32)
csr_spmm_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                const float* __restrict__ data, const float* __restrict__ x, int n_rows,
                int n_cols, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;   // uniform across the warp
  const int begin = indptr[row];
  const int end = indptr[row + 1];
  for (int c = 0; c < n_cols; ++c) {
    float acc = 0.0f;
    for (int s0 = begin; s0 < end; s0 += 32) {
      const int s = s0 + lane;
      float p = 0.0f;
      if (s < end) p = __fmul_rn(data[s], x[(size_t)indices[s] * n_cols + c]);
      const int cnt = min(32, end - s0);   // uniform across the warp
      for (int t = 0; t < cnt; ++t) acc = __fadd_rn(acc, __shfl_sync(0xffffffffu, p, t));
    }
    if (lane == 0) out[(size_t)row * n_cols + c] = acc;
  }
}

}  // namespace

// indptr [n_rows + 1], indices / data [>= indptr[n_rows]], x [*, n_cols]
// row-major, out [n_rows, n_cols]; every index must lie within x's rows.
extern "C" int rt_csr_spmm(const int* indptr, const int* indices, const float* data,
                           const float* x, int n_rows, int n_cols, float* out,
                           cudaStream_t stream) {
  const long blocks = ((long)n_rows + kWarps - 1) / kWarps;
  csr_spmm_kernel<<<(unsigned)blocks, kWarps * 32, 0, stream>>>(indptr, indices, data, x,
                                                                n_rows, n_cols, out);
  return (int)cudaGetLastError();
}
