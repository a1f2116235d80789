// resolve_rows: SA row -> stored value (sequence id), kernel K2.
//
// Replaces centrifuger_tpu/fm/device.py DeviceFM._resolve_rows_impl (with lf,
// _sample_stored_here, get_sampled_sa and _rowmap_fetch).
//
// Bound: with a rowmap, one random 4-byte load per row (bytes-bound); without
// one, an LF walk of up to sample_rate dependent rank fetches per row
// (latency-bound).  Design: one thread per row walks to completion; the
// TPU version's lane compaction and lockstep loop are not needed, and
// sel_rows is searched by binary search.  A template over the rank layout;
// rows and values are in its index type (int64: kernel K9, where the LF walk
// is the only resolve of an index with n >= 2^31).
#include "fm_device.cuh"

namespace {

template <class Layout>
__global__ void resolve_rows_kernel(FMView f, const typename Layout::Idx* __restrict__ rows,
                                    const uint8_t* __restrict__ valid, int M,
                                    typename Layout::Idx* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  out[i] = valid[i] ? resolve_one<Layout>(f, rows[i]) : 0;
}

}  // namespace

extern "C" int resolve_rows_launch(const FMView* f, const void* rows, const uint8_t* valid,
                                   int M, void* out, cudaStream_t stream) {
  const int threads = 256;
  CFR_DISPATCH_LAYOUT(f, resolve_rows_kernel<Layout>
                      <<<(M + threads - 1) / threads, threads, 0, stream>>>(
                          *f, static_cast<const typename Layout::Idx*>(rows), valid, M,
                          static_cast<typename Layout::Idx*>(out)));
  return static_cast<int>(cudaGetLastError());
}
