// prefix_search: longest-suffix backward search of codes[:ms] per lane,
// kernel K5 (the boundary-adjustment searches of flagged units).
//
// Replaces centrifuger_tpu/fm/device.py DeviceFM._prefix_search_impl.
//
// Bound: each step is two dependent 128-byte line fetches from the wide rank
// rows (latency-bound); the batch is small (a few hundred lanes at most).
// Design: one thread per lane, ftab start then BackwardExtend until it fails
// or covers ms.
#include "fm_device.cuh"

namespace {

__global__ void prefix_search_kernel(FMView f, const uint8_t* __restrict__ codes,
                                     const int32_t* __restrict__ ms_in, int B, int L,
                                     int32_t* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint8_t* cd = codes + static_cast<int64_t>(b) * L;
  const int32_t pw = f.pw;
  const int32_t ms = ms_in[b];
  const int32_t msc = min(max(ms, 0), L);
  int32_t l, sp = 1, ep = 0;
  bool running = false;
  if (ms < pw) {
    l = 0;
  } else {
    int32_t tv = 0, kmer = 0;
    while (tv < pw && msc - 1 - tv >= 0) {
      const int32_t c = cd[msc - 1 - tv];
      if (c == 255) break;
      kmer |= c << (2 * (pw - 1 - tv));
      ++tv;
    }
    if (tv < pw) {
      l = tv;
    } else {
      int32_t fsp, flen;
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
    const int32_t c = cd[min(max(ms - 1 - l, 0), L - 1)];
    if (c == 255) break;
    int32_t nsp, nep;
    backward_extend(f, c, sp, ep, &nsp, &nep);
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
                                    int B, int L, int32_t* out, cudaStream_t stream) {
  const int threads = 128;
  prefix_search_kernel<<<(B + threads - 1) / threads, threads, 0, stream>>>(*f, codes, ms, B,
                                                                            L, out);
  return static_cast<int>(cudaGetLastError());
}
