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
// Bound: a rank is up to five dependent fetches (indicator bit and count, the
// block's stream, the other stream's cross term), each followed by a serial
// SWAR + popc loop over up to 64 words of a 256-symbol block at 8 bits: bytes
// and latency, no arithmetic to speak of.  One thread does a whole rank and
// evaluates only the branch its block type takes; the values equal the
// batched versions', clips included.
#pragma once
#include "fm_view.cuh"

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
