// dep_gather: a chain of dependent row fetches per lane, kernel K12.
//
// Replaces the repo's only Pallas kernel, `kern` / `pallas_dep`
// (pl.pallas_call) in tools/micro_gather.py:98-117: a probe of the FM chain
// search's access pattern, on no serving path.  Each of
// B lanes starts at a row index and `iters` times fetches its row of a uint32
// [nrow, 21] table and moves on to (row[0] ^ row[20]) % nrow.
//
// Where Hopper differs: the Pallas kernel copies the padded 1.9 MB table into
// the TPU core's VMEM and gathers from there.  A Hopper block has at most
// 227 KB of shared memory, so the 1.6 MB table stays in device memory and is
// served from the 50 MB L2 cache after the first touches.  Bound: `iters`
// dependent L2 round trips per lane (latency); the bytes (the table read
// once, the indices in and out) and the integer work are far below it.
// Design: one thread per lane runs its chain to completion; nothing is shared.
#include "fm_view.cuh"

namespace {

constexpr int DEP_COLS = 21;   // words per table row

__global__ void dep_gather_kernel(const uint32_t* __restrict__ table, uint32_t nrow,
                                  const int32_t* __restrict__ idx0, int B, int iters,
                                  int32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  uint32_t idx = static_cast<uint32_t>(idx0[i]);
  for (int t = 0; t < iters; ++t) {
    const uint32_t* row = table + static_cast<int64_t>(idx) * DEP_COLS;
    idx = (__ldg(row) ^ __ldg(row + DEP_COLS - 1)) % nrow;
  }
  out[i] = static_cast<int32_t>(idx);
}

}  // namespace

extern "C" int dep_gather_launch(const int32_t* table, int nrow, const int32_t* idx, int B,
                                 int iters, int32_t* out, cudaStream_t stream) {
  const int threads = 128;
  dep_gather_kernel<<<(B + threads - 1) / threads, threads, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(table), static_cast<uint32_t>(nrow), idx, B, iters,
      out);
  return static_cast<int>(cudaGetLastError());
}
