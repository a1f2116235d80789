// prefix_search: longest-suffix backward search of codes[:ms] per lane,
// kernel K5 (the boundary-adjustment searches of flagged units).
//
// Replaces centrifuger_tpu/fm/device.py DeviceFM._prefix_search_impl.
//
// Bound on this card.  A lane is a chain of dependent BackwardExtend steps
// (at most ms - pw; a few tens for a 100-code lane, up to thousands on long
// reads), each two ranks at random rows.  The bytes a call moves (the codes,
// ms, the outputs, and the table words the ranks read) bound it at well
// under a microsecond for the finish stage's tens of lanes; the latency
// floor is the longest lane's steps x one memory round (L2 or HBM, about
// 0.5-1 us), so the longest search, not the bytes, sets the time.
//
// Design.  A lane runs to completion on Lanes<Layout> threads
// (fm_device.cuh), as chain_search runs K1.  On the plain layouts (whole and
// sharded, int32 and int64) a warp runs a lane: each step issues the sp
// row's and the ep row's 16-byte loads together (one a thread a row) and
// sums them with one warp reduction (GroupLanes::backward_extend), so a step
// is one memory round, and the ep row is not counted where sp == ep.  On the
// run-block and generic layouts a warp runs a lane as well, a step in two
// rounds (MegaLanes / GenericLanes: the indicator, then the streams).
// Blocks of 128 threads; the b >= B exit is per warp, and thread 0
// writes out.  Every thread of the warp computes the start (start_kmer, then
// ftab_entry) itself: its loads are the lane's own codes and ftab pair, the
// same address in every thread, so each is one broadcast transaction, and no
// shuffle or divergent branch is needed to share the result.  So every
// decision (the ms < pw, short-tail and empty-ftab starts, the clamp of
// ms - 1 - l, the 255 and nsp > nep breaks) is taken alike by the whole
// warp, and every *_sync call has all 32 threads.  A template over the rank
// layout; (l, sp, ep) are in its index type (int64: kernel K9).
#include "fm_device.cuh"

namespace {

constexpr int PREFIX_THREADS = 128;   // a multiple of the warp: groups never straddle warps

template <class Layout>
__global__ void __launch_bounds__(PREFIX_THREADS)
    prefix_search_kernel(FMView f, const uint8_t* __restrict__ codes,
                         const int32_t* __restrict__ ms_in, int B, int L,
                         typename Layout::Idx* __restrict__ out) {
  using Idx = typename Layout::Idx;
  using Ln = Lanes<Layout>;
  const int b = static_cast<int>((blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) /
                                 Ln::G);
  if (b >= B) return;   // the whole group: b is the group's
  const typename Ln::Group g = Ln::Group::here();
  const CodeLanes::Lane cd{codes + static_cast<int64_t>(b) * L, L};
  const int32_t pw = f.pw;
  const int32_t ms = ms_in[b];
  const int32_t msc = min(max(ms, 0), L);
  int32_t l;
  Idx sp = 1, ep = 0;
  bool running = false;
  if (ms < pw) {
    l = 0;
  } else {
    uint64_t kmer;
    const int32_t tv = start_kmer(f, cd, msc, &kmer);
    if (tv < pw) {
      l = tv;
    } else {
      Idx fsp, flen;
      ftab_entry(f, kmer, &fsp, &flen);
      if (flen == 0) {
        l = pw - 1;
      } else {
        l = pw;
        sp = fsp;
        ep = fsp + flen - 1;
        running = true;
      }
    }
  }
  while (running && l < ms) {
    const int32_t c = cd.cd[min(max(ms - 1 - l, 0), L - 1)];
    if (c == 255) break;
    Idx nsp, nep;
    Ln::backward_extend(f, g, c, sp, ep, &nsp, &nep);
    if (nsp > nep) break;
    sp = nsp;
    ep = nep;
    ++l;
  }
  if (g.t == 0) {
    out[b] = l;
    out[B + b] = sp;
    out[2 * B + b] = ep;
  }
}

}  // namespace

extern "C" int prefix_search_launch(const FMView* f, const uint8_t* codes, const int32_t* ms,
                                    int B, int L, void* out, cudaStream_t stream) {
  CFR_DISPATCH_LAYOUT(
      f, const int64_t threads = static_cast<int64_t>(B) * Lanes<Layout>::G;
      prefix_search_kernel<Layout>
      <<<static_cast<unsigned>((threads + PREFIX_THREADS - 1) / PREFIX_THREADS), PREFIX_THREADS,
         0, stream>>>(*f, codes, ms, B, L, static_cast<typename Layout::Idx*>(out)));
  return static_cast<int>(cudaGetLastError());
}
