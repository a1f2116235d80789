// rank_probe: the rank layouts' primitives for a batch of queries.  It holds
// K7 (rank_runblock.cuh) and K8 (rank_mega.cuh) themselves, and not only the
// kernels built on them, to their plain twins, and times one rank of each
// layout.
//
// Replaces the public centrifuger_tpu/fm/device.py DeviceFM._fused_rank_sym
// (on the generic layout bwt_rank + bwt_access), backward_extend and lf.
//
//   mode 0  a = c, b = pos (>= -1)      out0 = rank_inclusive(c, pos), out1 = symbol
//   mode 1  a = c, b = sp, c = ep       out0 = nsp, out1 = nep
//   mode 2  a = p                       out0 = lf(p), out1 = 0
//   mode 3  as mode 1, and mode 4 as mode 2, through Lanes<Layout>: a group
//           (a warp) a query, the code every kernel of a lane runs
//
// Modes 0-2 run the layout's one-thread code, a thread a query.  Every array
// is in the layout's index type (int64: kernel K9), symbols too.  Bound: the
// layout's dependent fetches at random rows (latency and bytes).
#include "fm_device.cuh"

namespace {

template <class Layout>
__global__ void rank_probe_kernel(FMView f, int mode, const typename Layout::Idx* __restrict__ a,
                                  const typename Layout::Idx* __restrict__ b,
                                  const typename Layout::Idx* __restrict__ c, int M,
                                  typename Layout::Idx* __restrict__ out0,
                                  typename Layout::Idx* __restrict__ out1) {
  using Idx = typename Layout::Idx;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  Idx r0, r1 = 0;
  if (mode == 0) {
    int32_t sym;
    r0 = Layout::rank_sym(f, static_cast<int32_t>(a[i]), b[i], &sym);
    r1 = sym;
  } else if (mode == 1) {
    Layout::backward_extend(f, static_cast<int32_t>(a[i]), b[i], c[i], &r0, &r1);
  } else {
    r0 = Layout::lf(f, a[i]);
  }
  out0[i] = r0;
  out1[i] = r1;
}

constexpr int GROUP_THREADS = 128;   // a multiple of the warp: groups never straddle warps

template <class Layout>
__global__ void __launch_bounds__(GROUP_THREADS)
    rank_group_kernel(FMView f, int mode, const typename Layout::Idx* __restrict__ a,
                      const typename Layout::Idx* __restrict__ b,
                      const typename Layout::Idx* __restrict__ c, int M,
                      typename Layout::Idx* __restrict__ out0,
                      typename Layout::Idx* __restrict__ out1) {
  using Idx = typename Layout::Idx;
  using L = Lanes<Layout>;
  const int i = static_cast<int>((blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) /
                                 L::G);
  if (i >= M) return;   // the whole group: i is the group's
  const typename L::Group g = L::Group::here();
  Idx r0, r1 = 0;
  if (mode == 3)
    L::backward_extend(f, g, static_cast<int32_t>(a[i]), b[i], c[i], &r0, &r1);
  else
    r0 = L::lf(f, g, a[i]);
  if (g.t == 0) {
    out0[i] = r0;
    out1[i] = r1;
  }
}

}  // namespace

extern "C" int rank_probe_launch(const FMView* f, int mode, const void* a, const void* b,
                                 const void* c, int M, void* out0, void* out1,
                                 cudaStream_t stream) {
  const int threads = 128;
  CFR_DISPATCH_LAYOUT(
      f, using Idx = typename Layout::Idx;
      if (mode < 3) rank_probe_kernel<Layout><<<(M + threads - 1) / threads, threads, 0, stream>>>(
          *f, mode, static_cast<const Idx*>(a), static_cast<const Idx*>(b),
          static_cast<const Idx*>(c), M, static_cast<Idx*>(out0), static_cast<Idx*>(out1));
      else {
        const int64_t t = static_cast<int64_t>(M) * Lanes<Layout>::G;
        rank_group_kernel<Layout><<<static_cast<unsigned>((t + GROUP_THREADS - 1) /
                                                          GROUP_THREADS),
                                    GROUP_THREADS, 0, stream>>>(
            *f, mode, static_cast<const Idx*>(a), static_cast<const Idx*>(b),
            static_cast<const Idx*>(c), M, static_cast<Idx*>(out0), static_cast<Idx*>(out1));
      });
  return static_cast<int>(cudaGetLastError());
}
