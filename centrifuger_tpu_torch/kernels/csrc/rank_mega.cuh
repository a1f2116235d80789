// Rank layout "runblock" (kernel K8): rank and symbol from the [R, 21] uint32
// mega-table of the run-block BWT in three 84-byte row fetches: the indicator
// row, then the literal row and the run row.
//
// Replaces centrifuger_tpu/fm/device.py DeviceFM._runblock_rank_sym over
// centrifuger_tpu/fm/device_fused.py build_mega_table; plain twin
// TorchFM._runblock_rank_sym.
//
//   indicator row  [cum, prev_word, w0..w7, 0...]     256 block-type bits
//   stream row     [occ_A..occ_T, prev_word, w0..w15] 256 2-bit symbols
//
// The prev_word column serves the bit / symbol at in_row < 0, where the rank
// row is the next one.  Bound: three 84-byte fetches at random rows, the
// indicator row and then the two stream rows it decides: two rounds of
// latency.  The TPU version stacks the two stream fetches into one [2M]
// gather round.  Two ways to rank here:
//   mega_rank_sym        one thread, word by word (up to 8 dependent loads of
//                        the indicator row, then up to 16 of each stream
//                        row).  Only rank_probe's one-thread modes (0-2)
//                        run it.
//   mega_group_pair / mega_group_lf_rank
//                        a warp (RankGroup; rank_runblock.cuh's group section):
//                        both ranks of a BackwardExtend step, or an LF step's
//                        symbol and rank, in two rounds: the two indicator
//                        rows, then the four stream rows (or two), each
//                        thread at most three 4-byte loads, all issued
//                        before any is used.  MegaLanes (fm_device.cuh), so
//                        every kernel built on Lanes<Layout>.
#pragma once
#include "fm_view.cuh"
#include "rank_runblock.cuh"

#define MEGA_WORDS 21

// (rank_inclusive(c, spos), symbol at spos) from the stream row of spos's
// rank; spos >= -1, and -1 gives rank 0.
__device__ __forceinline__ int32_t mega_stream_rank_sym(const uint32_t* stream, int32_t c,
                                                        int32_t spos, int32_t* sym) {
  const int32_t pos1 = spos + 1;
  const uint32_t* row = stream + static_cast<int64_t>(pos1 >> 8) * MEGA_WORDS;
  const int32_t upto = pos1 & 255, full = upto >> 4, tail = upto & 15;
  const uint32_t pat = static_cast<uint32_t>(c) * 0x55555555u;
  int32_t cnt = static_cast<int32_t>(__ldg(row + c));
  for (int32_t j = 0; j < full; ++j) {
    uint32_t x = ~(__ldg(row + 5 + j) ^ pat);
    cnt += __popc(x & (x >> 1) & 0x55555555u);
  }
  if (tail) {
    uint32_t x = ~(__ldg(row + 5 + full) ^ pat);
    cnt += __popc(x & (x >> 1) & 0x55555555u & ((1u << (2 * tail)) - 1u));
  }
  const int32_t in_row = spos - ((pos1 >> 8) << 8);
  const uint32_t sw = in_row < 0 ? __ldg(row + 4) : __ldg(row + 5 + (in_row >> 4));
  *sym = static_cast<int32_t>((sw >> ((spos & 15) * 2)) & 3u);
  return spos < 0 ? 0 : cnt;
}

// BWT rank_inclusive(c, pos) and the symbol at pos; pos = -1 gives rank 0.
__device__ __forceinline__ int32_t mega_rank_sym(const FMView& f, int32_t c, int32_t pos,
                                                 int32_t* sym) {
  const uint32_t* mega = reinterpret_cast<const uint32_t*>(f.mega);
  const int32_t b = f.b;
  const int32_t posc = max(pos, 0), bi = posc / b, inb = posc % b;
  // the indicator row: blocks of bi's type up to bi, and bi's type bit
  const int32_t ipos1 = bi + 1;
  const uint32_t* irow = mega + static_cast<int64_t>(ipos1 >> 8) * MEGA_WORDS;
  const int32_t within = ipos1 & 255, ifull = within >> 5, itail = within & 31;
  int32_t r1 = static_cast<int32_t>(__ldg(irow));
  for (int32_t j = 0; j < ifull; ++j) r1 += __popc(__ldg(irow + 2 + j));
  if (itail) r1 += __popc(__ldg(irow + 2 + ifull) & ((1u << itail) - 1u));
  const int32_t iin_row = bi - ((ipos1 >> 8) << 8);
  const uint32_t iw = iin_row < 0 ? __ldg(irow + 1) : __ldg(irow + 2 + (iin_row >> 5));
  const int32_t typ = static_cast<int32_t>((iw >> (bi & 31)) & 1u);
  const int32_t ranki = f.b_lt_n ? (typ == 1 ? r1 : bi + 1 - r1) : 1;
  const int32_t other = bi + 1 - ranki;
  const bool is_lit = typ == 0;
  // the literal row and the run row
  const int32_t lit_pos = is_lit ? (ranki - 1) * b + inb : other * b - 1;
  const int32_t run_pos = is_lit ? other - 1 : ranki - 1;
  int32_t lit_sym, run_sym;
  const int32_t lit_rank = mega_stream_rank_sym(
      mega + static_cast<int64_t>(f.m_lit) * MEGA_WORDS, c, lit_pos, &lit_sym);
  const int32_t run_rank = mega_stream_rank_sym(
      mega + static_cast<int64_t>(f.m_run) * MEGA_WORDS, c, run_pos, &run_sym);
  const int32_t run_part = run_sym == c ? (run_rank - 1) * b + inb + 1 : run_rank * b;
  if (sym) *sym = is_lit ? lit_sym : run_sym;
  if (pos < 0) return 0;
  return is_lit ? lit_rank + run_rank * b : run_part + lit_rank;
}

// ------------------------------------------------------------ group rank
// The mega-table's side of the group ranks of rank_runblock.cuh: the same
// two rounds over 84-byte rows, a stream row being a 2-bit block whose occ
// entries are its words 0..3 and whose prev_word, word 4, is the word before
// its data words.

__device__ __forceinline__ IndSide<int32_t> mega_ind(const FMView& f, int32_t bi, bool need) {
  const int32_t ipos1 = bi + 1;
  const uint32_t* irow = reinterpret_cast<const uint32_t*>(f.mega) +
                         static_cast<int64_t>(ipos1 >> 8) * MEGA_WORDS;
  return IndSide<int32_t>{irow + 2, reinterpret_cast<const int32_t*>(irow), ipos1 & 255, bi & 31,
                          need};
}

// mega_stream_rank_sym's row of spos in the stream whose first row is m.
__device__ __forceinline__ Probe<int32_t> mega_probe(const FMView& f, int32_t m, int32_t spos,
                                                     bool count, bool sym) {
  const uint32_t* row = reinterpret_cast<const uint32_t*>(f.mega) +
                        static_cast<int64_t>(m + ((spos + 1) >> 8)) * MEGA_WORDS;
  return Probe<int32_t>{row + 5, reinterpret_cast<const int32_t*>(row), (spos + 1) & 255,
                        count && spos >= 0, sym};
}

// mega_rank_sym's rank from its stream ranks and the run row's symbol.
__device__ __forceinline__ int32_t mega_rank(const RbPos<int32_t>& s, int32_t b, int32_t c,
                                             int32_t lit_r, int32_t run_r, int32_t run_sym) {
  const int32_t run_part = run_sym == c ? (run_r - 1) * b + s.inb + 1 : run_r * b;
  return s.is_lit ? lit_r + run_r * b : run_part + lit_r;
}

// mega_rank_sym(c, pa) where need_a (else 0), mega_rank_sym(c, pb) where
// count_b (else 0), and the symbol at pb where !count_b: the two ranks of a
// BackwardExtend step.  pb >= 0, and pa >= 0 where need_a.
__device__ __forceinline__ void mega_group_pair(const FMView& f, const RankGroup& g, int32_t c,
                                                int32_t pa, bool need_a, int32_t pb,
                                                bool count_b, int32_t* ra, int32_t* rb,
                                                int32_t* sym_b) {
  const int32_t b = f.b;
  int32_t bi0, inb0, bi1, inb1;
  block_of(f, max(pa, 0), &bi0, &inb0);
  block_of(f, pb, &bi1, &inb1);
  const IndPair<int32_t> ip = ind_pair(g, mega_ind(f, bi0, need_a), mega_ind(f, bi1, true));
  const RbPos<int32_t> A = rb_pos(f, bi0, inb0, ip.r1[0], ip.typ[0]);
  const RbPos<int32_t> B = rb_pos(f, bi1, inb1, ip.r1[1], ip.typ[1]);
  // probe p = 2 h + s: rank h's literal (s = 0) or run (s = 1) row; the run
  // row's symbol is run_part's, the main row's the symbol at ep
  const bool h = g.t >= 16, s = (g.t >> 3) & 1;
  const Probe<int32_t> mine = mega_probe(
      f, s ? f.m_run : f.m_lit, h ? (s ? B.run : B.lit) : (s ? A.run : A.lit),
      h ? count_b : need_a,
      h ? (s ? !B.is_lit : !count_b && B.is_lit) : (s && need_a && !A.is_lit));
  StreamRound<int32_t, 2, false> r;
  r.load(g, mine, c, mine, mine, f.sigma);
  const uint32_t cnt = r.counts(g, c);
  const int32_t run_sym_a = need_a && !A.is_lit ? r.sym(1, (A.run + 1) & 255) : 0;
  const int32_t run_sym_b = !B.is_lit ? r.sym(3, (B.run + 1) & 255) : 0;
  *ra = need_a ? mega_rank(A, b, c, A.lit >= 0 ? r.rank(0, cnt) : 0,
                           A.run >= 0 ? r.rank(1, cnt) : 0, run_sym_a)
               : 0;
  *rb = count_b ? mega_rank(B, b, c, B.lit >= 0 ? r.rank(2, cnt) : 0,
                            B.run >= 0 ? r.rank(3, cnt) : 0, run_sym_b)
                : 0;
  *sym_b = B.is_lit ? (!count_b ? r.sym(2, (B.lit + 1) & 255) : 0) : run_sym_b;
}

// (the symbol at p, mega_rank_sym of that symbol at p): an LF step's, from
// one fetch of the three rows (MegaLayout::lf fetches them twice).
__device__ __forceinline__ int32_t mega_group_lf_rank(const FMView& f, const RankGroup& g,
                                                      int32_t p, int32_t* sym) {
  const int32_t b = f.b;
  int32_t bi, inb;
  block_of(f, p, &bi, &inb);
  const IndSide<int32_t> s = mega_ind(f, bi, true);
  const IndPair<int32_t> ip =
      ind_pair(g, s, IndSide<int32_t>{s.w, s.cum, s.within, s.bit, false});
  const RbPos<int32_t> A = rb_pos(f, bi, inb, ip.r1[0], ip.typ[0]);
  const Probe<int32_t> l = mega_probe(f, f.m_lit, A.lit, true, A.is_lit);
  const Probe<int32_t> u = mega_probe(f, f.m_run, A.run, true, !A.is_lit);
  const int p2 = g.t >> 3;   // probes 0 and 1; 2 and 3 are off
  const Probe<int32_t> mine = mega_probe(f, p2 == 0 ? f.m_lit : f.m_run,
                                         p2 == 0 ? A.lit : A.run, p2 < 2,
                                         p2 < 2 && (p2 == 0) == A.is_lit);
  StreamRound<int32_t, 2, false> r;
  r.load(g, mine, -1, l, u, f.sigma);
  const int32_t c = A.is_lit ? r.sym(0, l.rem) : r.sym(1, u.rem);
  const uint32_t cnt = r.counts(g, c);
  const int32_t lit_r = l.count ? r.rank_lf(0, l, c, cnt) : 0;
  const int32_t run_r = u.count ? r.rank_lf(1, u, c, cnt) : 0;
  *sym = c;
  return mega_rank(A, b, c, lit_r, run_r, c);
}
