// resolve_rows: SA row -> stored value (sequence id), kernel K2.
//
// Replaces centrifuger_tpu/fm/device.py DeviceFM._resolve_rows_impl (with lf,
// _sample_stored_here, get_sampled_sa and _rowmap_fetch).
//
// Bound on this card.  With a rowmap: one random 4-byte load a row, a few
// microseconds of device time for a batch's rows, so a call costs what the
// host spends to launch it (kernels/__init__.py keeps each index's FMView
// and each entry's ctypes prototype, so a launch is a dictionary lookup and
// one ctypes call).  Without one: an LF walk to a stored row, sample_rate
// dependent LF steps a row on average (every sample_rate-th SA row is
// stored, so the walk's length is geometric), each one rank from a wide
// row: latency-bound, one memory round a step at best.
//
// Design.  The rowmap branch runs one thread a row.  The LF walk runs on
// Lanes<Layout> (fm_device.cuh), a warp a row on every layout: on the plain
// layouts each step is one 512-byte row read in one round of 16-byte loads
// (group_lf, rank_plain.cuh) instead of one thread's word by word scan; on
// the run-block and generic layouts each step reads the indicator, then the
// literal and the run stream's rows or blocks once, and takes the symbol and
// its count from the same words (two rounds; MegaLayout::lf reads the three
// rows twice).
// sel_rows is searched by binary search.  The TPU version's lane compaction
// and lockstep loop are not needed.  A template over the rank layout; rows
// and values are in its index type (int64: kernel K9, where the LF walk is
// the only resolve of an index with n >= 2^31).
#include "fm_device.cuh"

namespace {

template <class Layout, class L>
__global__ void resolve_rows_kernel(FMView f, const typename Layout::Idx* __restrict__ rows,
                                    const uint8_t* __restrict__ valid, int M,
                                    typename Layout::Idx* __restrict__ out) {
  using Idx = typename Layout::Idx;
  const int i = static_cast<int>((blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) /
                                 L::G);
  if (i >= M) return;   // the whole group: i is the group's
  const typename L::Group g = L::Group::here();
  Idx v = 0;
  if (valid[i])
    v = Layout::has_rowmap(f) ? rowmap_value<Layout>(f, rows[i])
                              : lf_walk<Layout>(f, rows[i], [&](Idx p) { return L::lf(f, g, p); });
  if (g.t == 0) out[i] = v;
}

template <class Layout, class L>
void launch(const FMView* f, const void* rows, const uint8_t* valid, int M, void* out,
            cudaStream_t stream) {
  using Idx = typename Layout::Idx;
  const int threads = 256;   // a multiple of the warp: groups never straddle warps
  const int64_t blocks = (static_cast<int64_t>(M) * L::G + threads - 1) / threads;
  resolve_rows_kernel<Layout, L><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      *f, static_cast<const Idx*>(rows), valid, M, static_cast<Idx*>(out));
}

}  // namespace

extern "C" int resolve_rows_launch(const FMView* f, const void* rows, const uint8_t* valid,
                                   int M, void* out, cudaStream_t stream) {
  CFR_DISPATCH_LAYOUT(f, if (f->has_rowmap) launch<Layout, SoloLanes<Layout>>(
                             f, rows, valid, M, out, stream);
                      else launch<Layout, Lanes<Layout>>(f, rows, valid, M, out, stream));
  return static_cast<int>(cudaGetLastError());
}
