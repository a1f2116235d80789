// Rank layout "generic" (kernel K7): rank and access over the run-block BWT as
// it is stored, an indicator bitvector plus a literal and a run stream of 2, 4
// or 8 bits a symbol (protein: sigma 21, 8 bits).
//
// Replaces centrifuger_tpu/fm/device.py DevicePacked, DeviceBitvector,
// DeviceFM.bwt_rank / _lit_rank / _run_rank / bwt_access / rank and the
// non-fast branches of backward_extend and lf; plain twins TorchPacked,
// TorchBitvector and TorchFM.bwt_rank / bwt_access / rank.
//
//   bitvector  words [ngrp, 8] uint32 (one zero group appended), cum [ngrp]
//   stream     words [nblk, 256 / per_word] uint32, occ [nblk, sigma]
//
// Templates over the index type Idx (int32_t, or int64_t for kernel K9): the
// positions, cum and occ take it; word and symbol arithmetic stays 32-bit.
//
// Bound: a rank is the indicator group (its bit and its count), then the
// block's stream and the other stream's cross term: two dependent rounds of
// fetches at random rows, latency and bytes, no arithmetic to speak of.
// Two ways to rank:
//   bwt_rank / bwt_access   one thread, word by word (up to 63 dependent
//                           loads of a 256-symbol block at 8 bits, and the
//                           indicator read again for the symbol).  Only
//                           rank_probe's one-thread modes (0-2) run it.
//   GenericLanes (the group section below, with MegaLanes of rank_mega.cuh)
//                           a warp: every kernel built on Lanes<Layout>.
// The values equal the batched versions', clips included.
#pragma once
#include "fm_view.cuh"
#include "rank_plain.cuh"

#define RANK_WORDS 8

template <class T>
__device__ __forceinline__ T tmin(T a, T b) { return a < b ? a : b; }
template <class T>
__device__ __forceinline__ T tmax(T a, T b) { return a < b ? b : a; }

template <class Idx>
__device__ __forceinline__ int32_t bv_access(const uint32_t* words, Idx idx) {
  return static_cast<int32_t>((__ldg(words + (idx >> 5)) >> (idx & 31)) & 1u);
}

// Ones in bits [0..idx].
template <class Idx>
__device__ __forceinline__ Idx bv_rank1_inclusive(const uint32_t* words, const void* cum,
                                                  Idx idx) {
  const Idx pos1 = idx + 1, wi = pos1 >> 5, grp = wi / RANK_WORDS;
  Idx cnt = tab<Idx>(cum, grp);
  for (Idx j = grp * RANK_WORDS; j < wi; ++j) cnt += __popc(__ldg(words + j));
  const int32_t tail = static_cast<int32_t>(pos1 & 31);
  if (tail) cnt += __popc(__ldg(words + wi) & ((1u << tail) - 1u));
  return cnt;
}

// The low bit of every W-bit slot of w that equals c.
template <int W>
__device__ __forceinline__ uint32_t swar_match(uint32_t w, uint32_t c) {
  if (W == 2) {
    const uint32_t x = ~(w ^ (c * 0x55555555u));
    return x & (x >> 1) & 0x55555555u;
  }
  if (W == 4) {
    uint32_t x = ~(w ^ (c * 0x11111111u));
    x &= x >> 1;
    x &= x >> 2;
    return x & 0x11111111u;
  }
  const uint32_t x = w ^ (c * 0x01010101u);
  uint32_t z = x | (x >> 4);
  z |= z >> 2;
  z |= z >> 1;
  return ~z & 0x01010101u;
}

// Count of c in symbols [0..idx] of a packed stream; idx in range.
template <int W, class Idx>
__device__ __forceinline__ Idx packed_rank_inclusive(const uint32_t* words, const void* occ,
                                                     int32_t sigma, int32_t c, Idx idx) {
  constexpr int PER = 32 / W, WPB = 256 / PER;
  const Idx pos1 = idx + 1, blk = pos1 >> 8;
  const int32_t rem = static_cast<int32_t>(pos1 & 255);
  const uint32_t* w = words + static_cast<int64_t>(blk) * WPB;
  Idx cnt = tab<Idx>(occ, static_cast<int64_t>(blk) * sigma + c);
  const int32_t full = rem / PER, tail = rem % PER;
  for (int32_t j = 0; j < full; ++j) cnt += __popc(swar_match<W>(__ldg(w + j), c));
  if (tail) cnt += __popc(swar_match<W>(__ldg(w + full), c) & ((1u << (tail * W)) - 1u));
  return cnt;
}

template <int W, class Idx>
__device__ __forceinline__ int32_t packed_access(const uint32_t* words, Idx idx) {
  constexpr int PER = 32 / W;
  return static_cast<int32_t>((__ldg(words + idx / PER) >> ((idx % PER) * W)) &
                              ((1u << W) - 1u));
}

template <class Idx>
__device__ __forceinline__ Idx stream_rank(const FMView& f, const int32_t* words,
                                           const void* occ, int32_t c, Idx idx) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(words);
  switch (f.width) {
    case 2: return packed_rank_inclusive<2>(w, occ, f.sigma, c, idx);
    case 4: return packed_rank_inclusive<4>(w, occ, f.sigma, c, idx);
    default: return packed_rank_inclusive<8>(w, occ, f.sigma, c, idx);
  }
}

template <class Idx>
__device__ __forceinline__ int32_t stream_access(const FMView& f, const int32_t* words,
                                                 Idx idx) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(words);
  switch (f.width) {
    case 2: return packed_access<2>(w, idx);
    case 4: return packed_access<4>(w, idx);
    default: return packed_access<8>(w, idx);
  }
}

// lit.rank_inclusive with the empty-stream and pos < 0 guards; pos is clipped
// to the stream.
template <class Idx>
__device__ __forceinline__ Idx lit_rank(const FMView& f, int32_t c, Idx pos) {
  if (f.lit_n == 0 || pos < 0) return 0;
  return stream_rank(f, f.lit_words, f.lit_occ, c, tmin(pos, static_cast<Idx>(f.lit_n - 1)));
}

template <class Idx>
__device__ __forceinline__ Idx run_rank(const FMView& f, int32_t c, Idx pos) {
  if (f.run_n == 0 || pos < 0) return 0;
  return stream_rank(f, f.run_words, f.run_occ, c, tmin(pos, static_cast<Idx>(f.run_n - 1)));
}

// Sequence_RunBlock::Rank: count of c in BWT[0..idx], idx in [0, n - 1].
template <class Idx>
__device__ __forceinline__ Idx bwt_rank(const FMView& f, int32_t c, Idx idx) {
  const uint32_t* ind = reinterpret_cast<const uint32_t*>(f.ind_words);
  const Idx b = f.b, bi = idx / b, inb = idx % b;
  const int32_t typ = bv_access(ind, bi);
  Idx ranki = 1;
  if (f.b_lt_n) {
    const Idx r1 = bv_rank1_inclusive(ind, f.ind_cum, bi);
    ranki = typ == 1 ? r1 : bi + 1 - r1;
  }
  const Idx other = bi + 1 - ranki;
  Idx ret, cross;
  if (typ == 0) {
    ret = lit_rank(f, c, (ranki - 1) * b + inb);
    cross = run_rank(f, c, other - 1) * b;
  } else {
    ret = 0;
    if (f.run_n) {
      const Idx rb = run_rank(f, c, ranki - 1);
      const bool in_run = stream_access(f, f.run_words,
                                        tmin(tmax(ranki - 1, Idx(0)),
                                             static_cast<Idx>(f.run_n - 1))) == c;
      ret = in_run ? (rb - 1) * b + inb + 1 : rb * b;
    }
    cross = lit_rank(f, c, other * b - 1);
  }
  return ret + (other == 0 ? 0 : cross);
}

// Sequence_RunBlock::Access: the BWT symbol at idx in [0, n - 1].
template <class Idx>
__device__ __forceinline__ int32_t bwt_access(const FMView& f, Idx idx) {
  const uint32_t* ind = reinterpret_cast<const uint32_t*>(f.ind_words);
  const Idx b = f.b, bi = idx / b;
  const Idx r1 = bv_rank1_inclusive(ind, f.ind_cum, bi);
  if (bv_access(ind, bi) == 0) {
    if (f.lit_n == 0) return 0;
    return stream_access(f, f.lit_words,
                         tmin(tmax(idx - b * r1, Idx(0)), static_cast<Idx>(f.lit_n - 1)));
  }
  if (f.run_n == 0) return 0;
  const Idx r0 = bi + 1 - r1;
  return stream_access(f, f.run_words,
                       tmin(tmax((idx - b * r0) / b, Idx(0)), static_cast<Idx>(f.run_n - 1)));
}

// FMIndex::Rank with the displaced-last-char correction.
template <class Idx>
__device__ __forceinline__ Idx fm_rank(const FMView& f, int32_t c, Idx p, bool inclusive) {
  const bool last = c == f.last_chr;
  const Idx fi = static_cast<Idx>(f.first_isa);
  if (inclusive) return bwt_rank(f, c, p) + ((last && p < fi) ? 1 : 0);
  return (p > 0 ? bwt_rank(f, c, p - 1) : 0) + ((last && p <= fi) ? 1 : 0);
}

// ------------------------------------------------------------ group ranks
// Both run-block layouts (this one and the mega-table, rank_mega.cuh) rank
// with a warp (RankGroup, rank_plain.cuh) that runs one lane of a kernel
// built on Lanes<Layout> (fm_device.cuh).  Every thread computes the same
// lane state, so control flow is uniform in the warp and each *_sync call
// has all 32 threads.  A rank, or the two of a BackwardExtend step (sp - 1
// and ep), takes two memory rounds:
//
//   round 1  the indicator (ind_pair).  For each rank h the 8 words that
//            hold bits up to bi (the mega-table's indicator row, or the
//            generic bitvector's 8-word group) and the count of ones before
//            them.  Thread 16 h + k: k < 8 loads word k where one of its bits
//            lies below bi + 1, k = 8 the count, k = 9 the word before the 8
//            (it holds bi's type bit where bi + 1 starts them).  The two
//            ranks' popcounts are below 256 each: one reduction sums both,
//            a byte each; the count and the type word come by shuffle.
//   round 2  the streams (StreamRound).  For each rank the literal and the
//            run stream's 256-symbol block that holds its position, a
//            "probe": probe p = 2 h + s (s = 0 literal, 1 run) is threads
//            8 p .. 8 p + 7, and thread 8 p + k holds words [k W, k W + W)
//            of the block (W bits a symbol, so a block is 8 W words): one
//            8- or 16-byte load, or two, on the generic streams, two 4-byte
//            loads on the mega-table, whose 84-byte rows are only 4-byte
//            aligned.  A thread loads only where it holds a word that the
//            count or the symbol needs, and works out the address of its
//            own probe only.  Thread 8 p also loads the occ entry of c,
//            thread 8 p + 1 the word before the block (the symbol of a
//            position that ends a block).  An LF step does not know c
//            before the symbol: there thread t < sigma loads occ entry t of
//            both of its probes, and the count of the symbol is taken from
//            the same words once the symbol is known.  The counts are below
//            256 a probe: one reduction sums all four, a byte each.
//
// The symbol costs no round of its own, because bwt_access reads the very
// position that the rank of the block's own stream counts to:
//   literal block  idx - b r1 = (bi - r1) b + inb = (r0 - 1) b + inb, where
//                  r0 = bi + 1 - r1 = ranki: the literal rank's position;
//   run block      (idx - b r0) / b = (b (r1 - 1) + inb) / b = r1 - 1 =
//                  ranki - 1: the run rank's position;
//   one block      (b_lt_n false) bi = 0, ranki = 1 and r1 is the type bit,
//                  so the two are idx and 0 again;
// and both clip to the stream's end as the ranks do.  The symbol at pos lies
// in the block of pos + 1 unless pos + 1 starts a block; then it is the
// word before the block (which the mega-table keeps in its row: prev_word).
//
// Every load lies inside its buffer: a probe's block is the one whose occ
// entry the one-thread rank reads (the streams are padded to whole blocks,
// TorchPacked), the indicator's 8 words are the group whose count it reads
// (TorchBitvector appends a zero group; a mega row is read whole), and the
// word before a block or a group is read only where the position is past
// the first one.

// The low nb bits, nb in [0, 32].
__device__ __forceinline__ uint32_t low_bits(int32_t nb) {
  return nb >= 32 ? 0xFFFFFFFFu : (1u << nb) - 1u;
}

// v of the warp's thread src (64-bit values as two shuffles).
template <class T>
__device__ __forceinline__ T warp_from(T v, int src) {
  if constexpr (sizeof(T) == 8)
    return static_cast<T>(__shfl_sync(WARP_ALL, static_cast<long long>(v), src));
  else
    return __shfl_sync(WARP_ALL, v, src);
}

// (pos / b, pos % b) for pos >= 0: a shift where the run-block size is a
// power of two (the block sizes the index build tries first), else a 32-bit
// divide where pos fits 32 bits; the branch is the same in every thread.
template <class Idx>
__device__ __forceinline__ void block_of(const FMView& f, Idx pos, Idx* bi, Idx* inb) {
  const uint32_t b = static_cast<uint32_t>(f.b);
  if ((b & (b - 1u)) == 0u) {
    *bi = pos >> (__ffs(b) - 1);
    *inb = pos & static_cast<Idx>(b - 1u);
  } else if (sizeof(Idx) == 4 || (static_cast<uint64_t>(pos) >> 32) == 0) {
    const uint32_t p = static_cast<uint32_t>(pos);
    *bi = static_cast<Idx>(p / b);
    *inb = static_cast<Idx>(p % b);
  } else {
    *bi = pos / static_cast<Idx>(b);
    *inb = pos % static_cast<Idx>(b);
  }
}

// One rank's indicator words (round 1).
template <class Idx>
struct IndSide {
  const uint32_t* w;   // the 8 words that hold bit bi; w[-1] the word before
  const Idx* cum;      // *cum: the ones before w[0]
  int32_t within;      // bits of w[0..7] below bi + 1 (bi + 1 = 256 j + within)
  int32_t bit;         // bi & 31
  bool need;
};

template <class Idx>
struct IndPair {
  Idx r1[2];        // ones in bits [0..bi]
  int32_t typ[2];   // bit bi: 1 a run block, 0 a literal block
};

template <class Idx>
__device__ __forceinline__ IndPair<Idx> ind_pair(const RankGroup& g, const IndSide<Idx>& s0,
                                                 const IndSide<Idx>& s1) {
  const bool h = g.t >= 16;
  const int k = g.t & 15;
  const uint32_t* iw = h ? s1.w : s0.w;
  const int32_t within = h ? s1.within : s0.within;
  uint32_t w = 0u;
  Idx cum = 0;
  if (h ? s1.need : s0.need) {
    if (k < 8 && 32 * k < within) w = __ldg(iw + k);
    if (k == 8) cum = tab<Idx>(h ? s1.cum : s0.cum, 0);
    if (k == 9 && within == 0) w = __ldg(iw - 1);
  }
  const uint32_t cnt =
      k < 8 ? static_cast<uint32_t>(__popc(w & low_bits(min(max(within - 32 * k, 0), 32)))) : 0u;
  const uint32_t packed = __reduce_add_sync(WARP_ALL, cnt << (h ? 8 : 0));
  IndPair<Idx> r{{0, 0}, {0, 0}};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const IndSide<Idx>& s = j ? s1 : s0;
    if (!s.need) continue;   // the same in every thread
    r.r1[j] = warp_from(cum, 16 * j + 8) + static_cast<Idx>((packed >> (8 * j)) & 255u);
    const uint32_t tw = warp_from(w, 16 * j + (s.within == 0 ? 9 : (s.within - 1) >> 5));
    r.typ[j] = static_cast<int32_t>((tw >> s.bit) & 1u);
  }
  return r;
}

// A rank's positions in the two streams, from its indicator (bwt_rank's and
// mega_rank_sym's arithmetic).
template <class Idx>
struct RbPos {
  Idx inb, other;
  Idx lit, run;   // the literal / the run stream's position
  bool is_lit;
};

template <class Idx>
__device__ __forceinline__ RbPos<Idx> rb_pos(const FMView& f, Idx bi, Idx inb, Idx r1,
                                             int32_t typ) {
  const Idx b = f.b;
  const Idx ranki = f.b_lt_n ? (typ == 1 ? r1 : bi + 1 - r1) : Idx(1);
  const Idx other = bi + 1 - ranki;
  const bool is_lit = typ == 0;
  return RbPos<Idx>{inb, other, is_lit ? (ranki - 1) * b + inb : other * b - 1,
                    is_lit ? other - 1 : ranki - 1, is_lit};
}

// One stream rank of round 2.
template <class Idx>
struct Probe {
  const uint32_t* w;   // the data words of the block of pos + 1; w[-1] the word before
  const Idx* occ;      // that block's occ: occ[c] the count of c before it
  int32_t rem;         // symbols of the block before pos + 1: (pos + 1) & 255
  bool count;          // the rank is wanted (else it is 0)
  bool sym;            // the symbol at pos is wanted
};

// The W words at src, where `on`: one 8-byte or one or two 16-byte loads
// (VEC: src is aligned so), else 4-byte loads.
template <int W, bool VEC>
__device__ __forceinline__ void load_words(uint32_t (&d)[W], const uint32_t* src, bool on) {
#pragma unroll
  for (int j = 0; j < W; ++j) d[j] = 0u;
  if (!on) return;
  if constexpr (VEC && W == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
    d[0] = v.x;
    d[1] = v.y;
  } else if constexpr (VEC) {
#pragma unroll
    for (int j = 0; j < W; j += 4) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(src) + j / 4);
      d[j] = v.x;
      d[j + 1] = v.y;
      d[j + 2] = v.z;
      d[j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) d[j] = __ldg(src + j);
  }
}

// Word i of d, i the same in every thread (a chain of selects: no local memory).
template <int W>
__device__ __forceinline__ uint32_t word_at(const uint32_t (&d)[W], int i) {
  uint32_t v = d[0];
#pragma unroll
  for (int j = 1; j < W; ++j) v = i == j ? d[j] : v;
  return v;
}

template <class Idx, int W, bool VEC>
struct StreamRound {
  static constexpr int PER = 32 / W;   // symbols a word
  uint32_t w[W];   // words [k W, k W + W) of the block of the thread's probe p
  Idx occ0;        // thread 8 p: probe p's occ of c; LF: thread t, occ entry t of probe 0
  Idx occ1;        // LF: thread t, occ entry t of probe 1
  uint32_t prev;   // thread 8 p + 1: the word before probe p's block
  int32_t rem;     // the thread's probe's rem and count flag
  bool count;

  // q: the thread's probe (p = t >> 3).  c >= 0: the occ entry of c; c < 0
  // (an LF step): entries t < sigma of o0 and o1, probes 0 and 1's occ
  // (where they count).
  __device__ __forceinline__ void load(const RankGroup& g, const Probe<Idx>& q, int32_t c,
                                       const Probe<Idx>& q0, const Probe<Idx>& q1,
                                       int32_t sigma) {
    const int k = g.t & 7;
    const int32_t words = q.count ? (q.rem + PER - 1) / PER : 0;   // the count reads
    const int32_t sw = q.sym && q.rem > 0 ? (q.rem - 1) / PER : -1;  // the symbol's word
    rem = q.rem;
    count = q.count;
    load_words<W, VEC>(w, q.w + k * W, k * W < words || (sw >= 0 && sw / W == k));
    prev = k == 1 && q.sym && q.rem == 0 ? __ldg(q.w - 1) : 0u;
    if (c >= 0) {
      occ0 = k == 0 && q.count ? tab<Idx>(q.occ, c) : Idx(0);
      occ1 = 0;
    } else {
      occ0 = g.t < sigma && q0.count ? tab<Idx>(q0.occ, g.t) : Idx(0);
      occ1 = g.t < sigma && q1.count ? tab<Idx>(q1.occ, g.t) : Idx(0);
    }
  }

  // The symbol at probe p's position (its rem r); p and r the same in every
  // thread.
  __device__ __forceinline__ int32_t sym(int p, int32_t r) const {
    uint32_t sw;
    if (r == 0) {
      sw = warp_from(prev, 8 * p + 1);
    } else {
      const int32_t j = (r - 1) / PER;   // the word of the block
      sw = warp_from(word_at(w, j % W), 8 * p + j / W);
    }
    const int32_t slot = ((r + 255) & 255) % PER;   // pos & 255 is r - 1 mod 256
    return static_cast<int32_t>((sw >> (slot * W)) & ((1u << W) - 1u));
  }

  // Each probe's count of c below its rem, byte p of the result.
  __device__ __forceinline__ uint32_t counts(const RankGroup& g, int32_t c) const {
    const int k = g.t & 7;
    uint32_t cnt = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const int32_t keep = min(max(rem - PER * (k * W + j), 0), PER);
      cnt += __popc(swar_match<W>(w[j], static_cast<uint32_t>(c)) & low_bits(keep * W));
    }
    return __reduce_add_sync(WARP_ALL, count ? cnt << (8 * (g.t >> 3)) : 0u);
  }

  // Probe p's rank: its occ entry of the c given to load, and its count.
  __device__ __forceinline__ Idx rank(int p, uint32_t cnt) const {
    return warp_from(occ0, 8 * p) + static_cast<Idx>((cnt >> (8 * p)) & 255u);
  }

  // LF: probe p's (0 or 1) rank of c, q the probe; c the same in every thread.
  __device__ __forceinline__ Idx rank_lf(int p, const Probe<Idx>& q, int32_t c,
                                         uint32_t cnt) const {
    // alphabets past 32 symbols: one more load
    const Idx o = c >= 32 ? tab<Idx>(q.occ, c) : warp_from(p ? occ1 : occ0, c);
    return o + static_cast<Idx>((cnt >> (8 * p)) & 255u);
  }
};

// The generic layout's indicator words of bi.
template <class Idx>
__device__ __forceinline__ IndSide<Idx> gen_ind(const FMView& f, Idx bi, bool need) {
  const Idx pos1 = bi + 1, grp = pos1 >> 8;
  return IndSide<Idx>{
      reinterpret_cast<const uint32_t*>(f.ind_words) + static_cast<int64_t>(grp) * RANK_WORDS,
      static_cast<const Idx*>(f.ind_cum) + grp, static_cast<int32_t>(pos1 & 255),
      static_cast<int32_t>(bi & 31), need};
}

// lit_rank / run_rank's probe: the guards (an empty stream, pos < 0) and
// the clip to the stream's end.
template <class Idx, int W>
__device__ __forceinline__ Probe<Idx> gen_probe(const FMView& f, bool lit, Idx pos, bool count,
                                                bool sym) {
  const Idx n = static_cast<Idx>(lit ? f.lit_n : f.run_n);
  const bool on = n > 0 && pos >= 0;
  const Idx q = tmin(pos, n - 1);
  const Idx blk = (q + 1) >> 8;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(lit ? f.lit_words : f.run_words);
  const Idx* occ = static_cast<const Idx*>(lit ? f.lit_occ : f.run_occ);
  return Probe<Idx>{words + static_cast<int64_t>(blk) * (8 * W),
                    occ + static_cast<int64_t>(blk) * f.sigma,
                    static_cast<int32_t>((q + 1) & 255), on && count, on && sym};
}

// bwt_rank from its stream ranks (0 where not counted) and the run stream's
// symbol at the run rank's position.
template <class Idx>
__device__ __forceinline__ Idx gen_rank(const FMView& f, const RbPos<Idx>& s, int32_t c,
                                        Idx lit_r, Idx run_r, int32_t run_sym) {
  const Idx b = f.b;
  if (s.is_lit) return lit_r + (s.other == 0 ? Idx(0) : run_r * b);
  const Idx ret = f.run_n ? (run_sym == c ? (run_r - 1) * b + s.inb + 1 : run_r * b) : Idx(0);
  return ret + (s.other == 0 ? Idx(0) : lit_r);
}

// bwt_rank(c, pa) where need_a (else 0), bwt_rank(c, pb) where count_b (else
// 0), and bwt_access(pb) where !count_b: the two ranks of a BackwardExtend
// step.  pb >= 0, and pa >= 0 where need_a.
template <class Idx, int W>
__device__ __forceinline__ void generic_group_pair(const FMView& f, const RankGroup& g,
                                                   int32_t c, Idx pa, bool need_a, Idx pb,
                                                   bool count_b, Idx* ra, Idx* rb,
                                                   int32_t* sym_b) {
  Idx bi0, inb0, bi1, inb1;
  block_of(f, tmax(pa, Idx(0)), &bi0, &inb0);
  block_of(f, pb, &bi1, &inb1);
  const IndPair<Idx> ip = ind_pair(g, gen_ind(f, bi0, need_a), gen_ind(f, bi1, true));
  const RbPos<Idx> A = rb_pos(f, bi0, inb0, ip.r1[0], ip.typ[0]);
  const RbPos<Idx> B = rb_pos(f, bi1, inb1, ip.r1[1], ip.typ[1]);
  // probe p = 2 h + s: rank h's literal (s = 0) or run (s = 1) stream; the
  // run stream's symbol is in_run's, the main stream's the symbol at ep.
  // Every thread needs each probe's flags and rem; it loads from its own.
  const Probe<Idx> la = gen_probe<Idx, W>(f, true, A.lit, need_a, false);
  const Probe<Idx> ra_ = gen_probe<Idx, W>(f, false, A.run, need_a, need_a && !A.is_lit);
  const Probe<Idx> lb = gen_probe<Idx, W>(f, true, B.lit, count_b, !count_b && B.is_lit);
  const Probe<Idx> rb_ = gen_probe<Idx, W>(f, false, B.run, count_b, !B.is_lit);
  const bool h = g.t >= 16, s = (g.t >> 3) & 1;
  const Probe<Idx> mine = gen_probe<Idx, W>(
      f, !s, h ? (s ? B.run : B.lit) : (s ? A.run : A.lit), h ? count_b : need_a,
      h ? (s ? !B.is_lit : !count_b && B.is_lit) : (s && need_a && !A.is_lit));
  StreamRound<Idx, W, true> r;
  r.load(g, mine, c, mine, mine, f.sigma);
  const uint32_t cnt = r.counts(g, c);
  const int32_t run_sym_a = ra_.sym ? r.sym(1, ra_.rem) : 0;
  const int32_t run_sym_b = rb_.sym ? r.sym(3, rb_.rem) : 0;
  *ra = need_a ? gen_rank(f, A, c, la.count ? r.rank(0, cnt) : Idx(0),
                          ra_.count ? r.rank(1, cnt) : Idx(0), run_sym_a)
               : Idx(0);
  *rb = count_b ? gen_rank(f, B, c, lb.count ? r.rank(2, cnt) : Idx(0),
                           rb_.count ? r.rank(3, cnt) : Idx(0), run_sym_b)
                : Idx(0);
  *sym_b = B.is_lit ? (lb.sym ? r.sym(2, lb.rem) : 0) : run_sym_b;
}

// (bwt_access(p), bwt_rank(bwt_access(p), p)): an LF step's symbol and rank.
template <class Idx, int W>
__device__ __forceinline__ Idx generic_group_lf_rank(const FMView& f, const RankGroup& g, Idx p,
                                                     int32_t* sym) {
  Idx bi, inb;
  block_of(f, p, &bi, &inb);
  const IndSide<Idx> s = gen_ind(f, bi, true);
  const IndPair<Idx> ip = ind_pair(g, s, IndSide<Idx>{s.w, s.cum, s.within, s.bit, false});
  const RbPos<Idx> A = rb_pos(f, bi, inb, ip.r1[0], ip.typ[0]);
  const Probe<Idx> l = gen_probe<Idx, W>(f, true, A.lit, true, A.is_lit);
  const Probe<Idx> u = gen_probe<Idx, W>(f, false, A.run, true, !A.is_lit);
  const int p2 = g.t >> 3;   // probes 0 and 1; 2 and 3 are off
  const Probe<Idx> mine = gen_probe<Idx, W>(f, p2 == 0, p2 == 0 ? A.lit : A.run, p2 < 2,
                                            p2 < 2 && (p2 == 0) == A.is_lit);
  StreamRound<Idx, W, true> r;
  r.load(g, mine, -1, l, u, f.sigma);
  const int32_t c = A.is_lit ? (l.sym ? r.sym(0, l.rem) : 0) : (u.sym ? r.sym(1, u.rem) : 0);
  const uint32_t cnt = r.counts(g, c);
  *sym = c;
  // a run block's symbol is the run stream's: in_run holds
  return gen_rank(f, A, c, l.count ? r.rank_lf(0, l, c, cnt) : Idx(0),
                  u.count ? r.rank_lf(1, u, c, cnt) : Idx(0), c);
}
