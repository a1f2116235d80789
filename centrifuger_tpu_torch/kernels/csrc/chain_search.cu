// chain_search: semi-maximal exact-match chains per lane (kernels K1 and K6),
// with the 2-bit read decode fused in (K4).
//
// Replaces centrifuger_tpu/fm/device.py DeviceFM._chain_search_lazyftab_impl
// and _chain_search_ftab_impl (with _precompute_read_tables and
// backward_extend) and centrifuger_tpu/classify/device_engine.py
// decode_packed_dna + _rc_lanes.  The two JAX programs differ only in how the
// START outcomes reach their lockstep loop: one packed int32 word while
// code_bits * pw + 9 <= 31, separate eager tables beyond (wide ftabs: 12 or
// more nucleotide ftab chars).  This kernel rebuilds the pw-mer at each START
// from the codes into a 64-bit key, clipped to the table, so it has no pack
// limit and serves both.
//
// Bound on this card.  A lane is a chain of dependent EXTEND steps (about 80
// for a 100-code lane, 19,000 for a 20 kbp read), each two ranks at random
// rows: one 512-byte wide row each on the plain layouts, three 84-byte rows
// on the run-block layout, an indicator group and two stream blocks on the
// generic one.  The bytes
// a batch moves bound it at about 0.26 ms (plain, 32,768 lanes); a step's
// memory latency (L2 or HBM, hundreds of cycles), paid once a step for as
// many steps as the longest lane has, bounds it from the other side.  When
// one thread scanned each rank's row word by word, a step cost about as many
// memory rounds as the row has words, and that set the time whatever the
// lane count.
//
// Design.  A lane runs its START/EXTEND state machine to completion, with no
// lockstep, on Lanes<Layout> threads (fm_device.cuh).  On the plain layouts
// (whole and sharded, int32 and int64) that is a whole warp: all 32 threads
// run the same state, and each EXTEND step issues the sp row's and the ep
// row's 16-byte loads together (one a thread a row), counts its own 4 words
// and sums them with one warp reduction (group_rank, rank_plain.cuh): one
// memory round a step, and the ep row is not counted where sp == ep.  A warp
// a lane also keeps lanes whose chains differ from sharing a warp, whose
// diverged groups would issue one after another: of 4, 8, 16 and 32 threads
// a lane, 32 ran the main batch and the long reads fastest (PERF.md, "Group
// size").  On the run-block and generic layouts a warp runs a lane too
// (MegaLanes, GenericLanes): a step is two memory rounds, the sp and ep
// indicator rows or groups, then the four stream rows or blocks they decide
// (rank_runblock.cuh's group section); a warp ran the run-block and the
// protein chain faster than a half-warp (PERF.md, findings, "A warp against a
// half-warp").  Blocks of 128 threads hold 4 lanes.  The warp's thread 0
// writes the hits.  The code source is a template parameter:
//   PackedDna  lane 2u reads read u forward, lane 2u + 1 its reverse
//              complement as 3 - code[len - 1 - i], straight from pack2/vmask
//   CodeLanes  ready-made uint8 code lanes (protein: six frames a read; the
//              non-fused engine's strand lanes, reads of any length)
// With an int64 index (kernel K9, the int64 `ftab2` of fm/device.py:282-293)
// sp, ep and the hits are int64 and the ftab pair is one 16-byte load; read
// positions stay 32-bit.
#include "fm_device.cuh"

namespace {

struct PackedDna {
  const uint8_t* pack2;     // [U, L / 4] 4 codes per byte, little-endian
  const uint8_t* vmask;     // [U, L / 8] validity bit per base, little-endian
  const int32_t* lengths;   // [U]
  int L;
  struct Lane {
    const uint8_t* pack2;
    const uint8_t* vmask;
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
  __device__ __forceinline__ Lane lane(int b) const {
    const int u = b >> 1;
    return Lane{pack2 + static_cast<int64_t>(u) * (L / 4),
                vmask + static_cast<int64_t>(u) * (L / 8), lengths[u], (b & 1) != 0};
  }
};

constexpr int CHAIN_THREADS = 128;   // a multiple of the warp: groups never straddle warps

template <class Layout, class Reads>
__global__ void __launch_bounds__(CHAIN_THREADS)
    chain_search_kernel(FMView f, Reads reads, int B, int mhl, int H,
                        typename Layout::Idx* __restrict__ hits, int32_t* __restrict__ nhits) {
  using Idx = typename Layout::Idx;
  using L = Lanes<Layout>;
  const int b = static_cast<int>((blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) /
                                 L::G);
  if (b >= B) return;   // the whole group: b is the group's
  const typename L::Group g = L::Group::here();
  const typename Reads::Lane rd = reads.lane(b);
  const int64_t out = static_cast<int64_t>(b) * H;   // this lane's first hit
  const int32_t pw = f.pw;
  const int32_t length = rd.len;
  int32_t rem = length, nh = 0;
  while (rem >= mhl) {
    // ---- START at prefix length rem: the pw-mer ending at rem - 1 ----
    uint64_t kmer;
    const int32_t tv = start_kmer(f, rd, rem, &kmer);
    Idx fsp = 1, flen = 0;
    if (tv >= pw) ftab_entry(f, kmer, &fsp, &flen);
    const bool ftab_ok = tv >= pw && flen > 0 && rem >= pw;
    int32_t fin_l;
    Idx fin_sp, fin_ep;
    if (!ftab_ok) {
      // 0 below pw, the valid run for an invalid char in the window, pw - 1
      // for an empty range
      fin_l = rem < pw ? 0 : (tv < pw ? tv : pw - 1);
      fin_sp = 1;
      fin_ep = 0;
    } else if (rem <= pw) {
      fin_l = pw;
      fin_sp = fsp;
      fin_ep = fsp + flen - 1;
    } else {
      // ---- EXTEND one char at a time until it fails or covers rem ----
      Idx sp = fsp, ep = fsp + flen - 1;
      int32_t l = pw;
      while (true) {
        const int32_t c = rd.code(rem - l - 1);
        Idx nsp = 1, nep = 0;
        if (c != 255) L::backward_extend(f, g, c, sp, ep, &nsp, &nep);
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
    if (fin_l >= mhl && fin_sp <= fin_ep && nh < H) {
      if (g.t == 0) store_hit<Idx>(hits, out + nh, fin_sp, fin_ep, fin_l, length - rem);
      ++nh;
    }
    rem -= fin_l + 1;
  }
  for (int m = nh + g.t; m < H; m += L::G) store_hit<Idx>(hits, out + m, 0, 0, 0, 0);
  if (g.t == 0) nhits[b] = nh;
}

template <class Reads>
int launch(const FMView* f, const Reads& reads, int B, int mhl, int H, void* hits,
           int32_t* nhits, cudaStream_t stream) {
  CFR_DISPATCH_LAYOUT(
      f, const int64_t threads = static_cast<int64_t>(B) * Lanes<Layout>::G;
      chain_search_kernel<Layout, Reads>
      <<<static_cast<unsigned>((threads + CHAIN_THREADS - 1) / CHAIN_THREADS), CHAIN_THREADS, 0,
         stream>>>(*f, reads, B, mhl, H, static_cast<typename Layout::Idx*>(hits), nhits));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int chain_search_launch(const FMView* f, const uint8_t* pack2,
                                   const uint8_t* vmask, const int32_t* lengths, int U,
                                   int L, int mhl, int H, void* hits, int32_t* nhits,
                                   cudaStream_t stream) {
  return launch(f, PackedDna{pack2, vmask, lengths, L}, 2 * U, mhl, H, hits, nhits, stream);
}

extern "C" int chain_search_lanes_launch(const FMView* f, const uint8_t* codes,
                                         const int32_t* lengths, int B, int L, int mhl,
                                         int H, void* hits, int32_t* nhits,
                                         cudaStream_t stream) {
  return launch(f, CodeLanes{codes, lengths, L}, B, mhl, H, hits, nhits, stream);
}
