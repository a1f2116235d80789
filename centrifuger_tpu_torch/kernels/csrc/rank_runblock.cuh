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
// Bound: a rank is up to five dependent fetches (indicator bit and count, the
// block's stream, the other stream's cross term), each followed by a serial
// SWAR + popc loop over up to 64 words of a 256-symbol block at 8 bits: bytes
// and latency, no arithmetic to speak of.  One thread does a whole rank and
// evaluates only the branch its block type takes; the values equal the
// batched versions', clips included.
#pragma once
#include "fm_view.cuh"

#define RANK_WORDS 8

__device__ __forceinline__ int32_t bv_access(const uint32_t* words, int32_t idx) {
  return static_cast<int32_t>((__ldg(words + (idx >> 5)) >> (idx & 31)) & 1u);
}

// Ones in bits [0..idx].
__device__ __forceinline__ int32_t bv_rank1_inclusive(const uint32_t* words,
                                                      const int32_t* cum, int32_t idx) {
  const int32_t pos1 = idx + 1, wi = pos1 >> 5, grp = wi / RANK_WORDS;
  int32_t cnt = __ldg(cum + grp);
  for (int32_t j = grp * RANK_WORDS; j < wi; ++j) cnt += __popc(__ldg(words + j));
  const int32_t tail = pos1 & 31;
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
template <int W>
__device__ __forceinline__ int32_t packed_rank_inclusive(const uint32_t* words,
                                                         const int32_t* occ, int32_t sigma,
                                                         int32_t c, int32_t idx) {
  constexpr int PER = 32 / W, WPB = 256 / PER;
  const int32_t pos1 = idx + 1, blk = pos1 >> 8, rem = pos1 & 255;
  const uint32_t* w = words + static_cast<int64_t>(blk) * WPB;
  int32_t cnt = __ldg(occ + static_cast<int64_t>(blk) * sigma + c);
  const int32_t full = rem / PER, tail = rem % PER;
  for (int32_t j = 0; j < full; ++j) cnt += __popc(swar_match<W>(__ldg(w + j), c));
  if (tail) cnt += __popc(swar_match<W>(__ldg(w + full), c) & ((1u << (tail * W)) - 1u));
  return cnt;
}

template <int W>
__device__ __forceinline__ int32_t packed_access(const uint32_t* words, int32_t idx) {
  constexpr int PER = 32 / W;
  return static_cast<int32_t>((__ldg(words + idx / PER) >> ((idx % PER) * W)) &
                              ((1u << W) - 1u));
}

__device__ __forceinline__ int32_t stream_rank(const FMView& f, const int32_t* words,
                                               const int32_t* occ, int32_t c, int32_t idx) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(words);
  switch (f.width) {
    case 2: return packed_rank_inclusive<2>(w, occ, f.sigma, c, idx);
    case 4: return packed_rank_inclusive<4>(w, occ, f.sigma, c, idx);
    default: return packed_rank_inclusive<8>(w, occ, f.sigma, c, idx);
  }
}

__device__ __forceinline__ int32_t stream_access(const FMView& f, const int32_t* words,
                                                 int32_t idx) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(words);
  switch (f.width) {
    case 2: return packed_access<2>(w, idx);
    case 4: return packed_access<4>(w, idx);
    default: return packed_access<8>(w, idx);
  }
}

// lit.rank_inclusive with the empty-stream and pos < 0 guards; pos is clipped
// to the stream.
__device__ __forceinline__ int32_t lit_rank(const FMView& f, int32_t c, int32_t pos) {
  if (f.lit_n == 0 || pos < 0) return 0;
  return stream_rank(f, f.lit_words, f.lit_occ, c, min(pos, f.lit_n - 1));
}

__device__ __forceinline__ int32_t run_rank(const FMView& f, int32_t c, int32_t pos) {
  if (f.run_n == 0 || pos < 0) return 0;
  return stream_rank(f, f.run_words, f.run_occ, c, min(pos, f.run_n - 1));
}

// Sequence_RunBlock::Rank: count of c in BWT[0..idx], idx in [0, n - 1].
__device__ __forceinline__ int32_t bwt_rank(const FMView& f, int32_t c, int32_t idx) {
  const uint32_t* ind = reinterpret_cast<const uint32_t*>(f.ind_words);
  const int32_t b = f.b, bi = idx / b, inb = idx % b;
  const int32_t typ = bv_access(ind, bi);
  int32_t ranki = 1;
  if (f.b_lt_n) {
    const int32_t r1 = bv_rank1_inclusive(ind, f.ind_cum, bi);
    ranki = typ == 1 ? r1 : bi + 1 - r1;
  }
  const int32_t other = bi + 1 - ranki;
  int32_t ret, cross;
  if (typ == 0) {
    ret = lit_rank(f, c, (ranki - 1) * b + inb);
    cross = run_rank(f, c, other - 1) * b;
  } else {
    ret = 0;
    if (f.run_n) {
      const int32_t rb = run_rank(f, c, ranki - 1);
      const bool in_run =
          stream_access(f, f.run_words, min(max(ranki - 1, 0), f.run_n - 1)) == c;
      ret = in_run ? (rb - 1) * b + inb + 1 : rb * b;
    }
    cross = lit_rank(f, c, other * b - 1);
  }
  return ret + (other == 0 ? 0 : cross);
}

// Sequence_RunBlock::Access: the BWT symbol at idx in [0, n - 1].
__device__ __forceinline__ int32_t bwt_access(const FMView& f, int32_t idx) {
  const uint32_t* ind = reinterpret_cast<const uint32_t*>(f.ind_words);
  const int32_t b = f.b, bi = idx / b;
  const int32_t r1 = bv_rank1_inclusive(ind, f.ind_cum, bi);
  if (bv_access(ind, bi) == 0) {
    if (f.lit_n == 0) return 0;
    return stream_access(f, f.lit_words, min(max(idx - b * r1, 0), f.lit_n - 1));
  }
  if (f.run_n == 0) return 0;
  const int32_t r0 = bi + 1 - r1;
  return stream_access(f, f.run_words, min(max((idx - b * r0) / b, 0), f.run_n - 1));
}

// FMIndex::Rank with the displaced-last-char correction.
__device__ __forceinline__ int32_t fm_rank(const FMView& f, int32_t c, int32_t p,
                                           bool inclusive) {
  const bool last = c == f.last_chr;
  if (inclusive) return bwt_rank(f, c, p) + ((last && p < f.first_isa) ? 1 : 0);
  return (p > 0 ? bwt_rank(f, c, p - 1) : 0) + ((last && p <= f.first_isa) ? 1 : 0);
}
