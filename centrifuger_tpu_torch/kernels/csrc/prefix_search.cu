// prefix_search: longest-suffix backward search of codes[:ms] per lane,
// kernel K5 (the boundary-adjustment searches of flagged units).
//
// Replaces centrifuger_tpu/fm/device.py DeviceFM._prefix_search_impl.
//
// Bound: each step is two dependent rank fetches at random rows
// (latency-bound); the batch is small (a few hundred lanes at most).
// Design: one thread per lane, ftab start then BackwardExtend until it fails
// or covers ms.  A template over the rank layout; (l, sp, ep) are in its
// index type (int64: kernel K9).
#include "fm_device.cuh"

namespace {

template <class Layout>
__global__ void prefix_search_kernel(FMView f, const uint8_t* __restrict__ codes,
                                     const int32_t* __restrict__ ms_in, int B, int L,
                                     typename Layout::Idx* __restrict__ out) {
  using Idx = typename Layout::Idx;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
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
    Layout::backward_extend(f, c, sp, ep, &nsp, &nep);
    if (nsp > nep) break;
    sp = nsp;
    ep = nep;
    ++l;
  }
  out[b] = l;
  out[B + b] = sp;
  out[2 * B + b] = ep;
}

}  // namespace

extern "C" int prefix_search_launch(const FMView* f, const uint8_t* codes, const int32_t* ms,
                                    int B, int L, void* out, cudaStream_t stream) {
  const int threads = 128;
  CFR_DISPATCH_LAYOUT(f, prefix_search_kernel<Layout>
                      <<<(B + threads - 1) / threads, threads, 0, stream>>>(
                          *f, codes, ms, B, L, static_cast<typename Layout::Idx*>(out)));
  return static_cast<int>(cudaGetLastError());
}
