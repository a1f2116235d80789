// rank_probe: the rank layouts' primitives for a batch of queries, one thread
// each.  It holds K7 (rank_runblock.cuh) and K8 (rank_mega.cuh) themselves,
// and not only the kernels built on them, to their plain twins, and times one
// rank of each layout.
//
// Replaces the public centrifuger_tpu/fm/device.py DeviceFM._fused_rank_sym
// (on the generic layout bwt_rank + bwt_access), backward_extend and lf.
//
//   mode 0  a = c, b = pos (>= -1)      out0 = rank_inclusive(c, pos), out1 = symbol
//   mode 1  a = c, b = sp, c = ep       out0 = nsp, out1 = nep
//   mode 2  a = p                       out0 = lf(p), out1 = 0
//
// Bound: the layout's dependent fetches at random rows (latency and bytes).
#include "fm_device.cuh"

namespace {

template <class Layout>
__global__ void rank_probe_kernel(FMView f, int mode, const int32_t* __restrict__ a,
                                  const int32_t* __restrict__ b,
                                  const int32_t* __restrict__ c, int M,
                                  int32_t* __restrict__ out0, int32_t* __restrict__ out1) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  int32_t r0, r1 = 0;
  if (mode == 0)
    r0 = Layout::rank_sym(f, a[i], b[i], &r1);
  else if (mode == 1)
    Layout::backward_extend(f, a[i], b[i], c[i], &r0, &r1);
  else
    r0 = Layout::lf(f, a[i]);
  out0[i] = r0;
  out1[i] = r1;
}

}  // namespace

extern "C" int rank_probe_launch(const FMView* f, int mode, const int32_t* a,
                                 const int32_t* b, const int32_t* c, int M, int32_t* out0,
                                 int32_t* out1, cudaStream_t stream) {
  const int threads = 128;
  CFR_DISPATCH_LAYOUT(f, rank_probe_kernel<Layout>
                      <<<(M + threads - 1) / threads, threads, 0, stream>>>(*f, mode, a, b, c,
                                                                            M, out0, out1));
  return static_cast<int>(cudaGetLastError());
}
