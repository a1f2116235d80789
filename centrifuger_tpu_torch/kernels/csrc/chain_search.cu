// chain_search: semi-maximal exact-match chains per strand lane, with the
// 2-bit read decode fused in (kernels K1 + K4).
//
// Replaces centrifuger_tpu/fm/device.py DeviceFM._chain_search_lazyftab_impl
// (with _precompute_read_tables and the plain branch of backward_extend) and
// centrifuger_tpu/classify/device_engine.py decode_packed_dna + _rc_lanes.
//
// Bound: every EXTEND step is two dependent 128-byte line fetches from the
// wide rank rows at random rows (rank at sp - 1 and at ep), so the kernel is
// latency- and bytes-bound, not compute-bound.  Design: one thread per strand
// lane runs its START/EXTEND state machine to completion with no lockstep
// (lane 2u reads read u forward, lane 2u + 1 its reverse complement as
// 3 - code[len - 1 - i]); codes come straight from pack2/vmask, and the
// START k-mer and tail-valid count are rebuilt from the pw preceding codes
// instead of being tabulated per position.
#include "fm_device.cuh"

namespace {

struct Read {
  const uint8_t* pack2;   // [L / 4] 4 codes per byte, little-endian
  const uint8_t* vmask;   // [L / 8] validity bit per base, little-endian
  int32_t len;
  bool rc;
  // code at position i of this strand lane, 255 when invalid / out of range
  __device__ __forceinline__ int32_t code(int32_t i) const {
    if (i < 0 || i >= len) return 255;
    const int32_t j = rc ? len - 1 - i : i;
    if (!((vmask[j >> 3] >> (j & 7)) & 1)) return 255;
    const int32_t c = (pack2[j >> 2] >> ((j & 3) * 2)) & 3;
    return rc ? 3 - c : c;
  }
};

__global__ void chain_search_kernel(FMView f, const uint8_t* __restrict__ pack2,
                                    const uint8_t* __restrict__ vmask,
                                    const int32_t* __restrict__ lengths, int U, int L,
                                    int mhl, int H, int32_t* __restrict__ hits,
                                    int32_t* __restrict__ nhits) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= 2 * U) return;
  const int u = b >> 1;
  const Read rd{pack2 + static_cast<int64_t>(u) * (L / 4),
                vmask + static_cast<int64_t>(u) * (L / 8), lengths[u], (b & 1) != 0};
  int4* out = reinterpret_cast<int4*>(hits) + static_cast<int64_t>(b) * H;
  const int32_t pw = f.pw;
  const int32_t length = rd.len;
  int32_t rem = length, nh = 0;
  while (rem >= mhl) {
    // ---- START at prefix length rem: the pw-mer ending at rem - 1 ----
    int32_t tv = 0, kmer = 0;
    while (tv < pw) {
      const int32_t c = rd.code(rem - 1 - tv);
      if (c == 255) break;
      kmer |= c << (2 * (pw - 1 - tv));
      ++tv;
    }
    int32_t fsp = 1, flen = 0;
    if (tv >= pw) ftab_entry(f, kmer, &fsp, &flen);
    const bool ftab_ok = tv >= pw && flen > 0 && rem >= pw;
    int32_t fin_l, fin_sp, fin_ep;
    if (!ftab_ok) {
      fin_l = rem < pw ? 0 : (tv < pw ? tv : pw - 1);
      fin_sp = 1;
      fin_ep = 0;
    } else if (rem <= pw) {
      fin_l = pw;
      fin_sp = fsp;
      fin_ep = fsp + flen - 1;
    } else {
      // ---- EXTEND one char at a time until it fails or covers rem ----
      int32_t sp = fsp, ep = fsp + flen - 1, l = pw;
      while (true) {
        const int32_t c = rd.code(rem - l - 1);
        int32_t nsp = 1, nep = 0;
        if (c != 255) backward_extend(f, c, sp, ep, &nsp, &nep);
        if (c == 255 || nsp > nep) {   // failed: the chain is [sp, ep] at l
          fin_l = l;
          fin_sp = sp;
          fin_ep = ep;
          break;
        }
        ++l;
        sp = nsp;
        ep = nep;
        if (l >= rem) {
          fin_l = l;
          fin_sp = sp;
          fin_ep = ep;
          break;
        }
      }
    }
    // hits beyond H are dropped, but the lane keeps walking
    if (fin_l >= mhl && fin_sp <= fin_ep && nh < H)
      out[nh++] = make_int4(fin_sp, fin_ep, fin_l, length - rem);
    rem -= fin_l + 1;
  }
  for (int m = nh; m < H; ++m) out[m] = make_int4(0, 0, 0, 0);
  nhits[b] = nh;
}

}  // namespace

extern "C" int chain_search_launch(const FMView* f, const uint8_t* pack2,
                                   const uint8_t* vmask, const int32_t* lengths, int U,
                                   int L, int mhl, int H, int32_t* hits, int32_t* nhits,
                                   cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (2 * U + threads - 1) / threads;
  chain_search_kernel<<<blocks, threads, 0, stream>>>(*f, pack2, vmask, lengths, U, L,
                                                      mhl, H, hits, nhits);
  return static_cast<int>(cudaGetLastError());
}
