// Rank layout "plain": 512-byte wide rank rows of 128 uint32 words covering
// 1920 BWT symbols each,
//   [occ_A, occ_C, occ_G, occ_T, occ_hi, prev_word, w0..w119, pad, pad]
// where w_i holds 16 2-bit symbols (little-endian) and prev_word is the
// previous row's w119, so the symbol at pos comes from the same row as the
// rank at pos even when (pos + 1) % 1920 == 0.  Value-identical to
// TorchFM._plain_rank_sym / _plain_lf and to
// centrifuger_tpu/fm/device.py DeviceFM._plain_rank_sym / _plain_lf.
#pragma once
#include "fm_view.cuh"

#define WIDE_BLOCK 1920
#define WIDE_WORDS 128
#define WIDE_OFF 6
#define WIDE_PREV 5

__device__ __forceinline__ const uint32_t* wide_row(const FMView& f, int32_t pos) {
  // pos >= -1; row (pos + 1) / 1920 holds the occ before slot (pos + 1)
  return reinterpret_cast<const uint32_t*>(f.rows) +
         static_cast<int64_t>((pos + 1) / WIDE_BLOCK) * WIDE_WORDS;
}

// Occurrences of c in the first `upto` (< 1920) symbol slots of a row.
__device__ __forceinline__ int32_t wide_prefix_count(const uint32_t* row, uint32_t c,
                                                     int32_t upto) {
  const uint32_t pat = c * 0x55555555u;
  const int32_t full = upto >> 4, tail = upto & 15;
  int32_t cnt = 0;
  for (int32_t j = 0; j < full; ++j) {
    uint32_t x = ~(__ldg(row + WIDE_OFF + j) ^ pat);
    cnt += __popc(x & (x >> 1) & 0x55555555u);
  }
  if (tail) {
    uint32_t x = ~(__ldg(row + WIDE_OFF + full) ^ pat);
    cnt += __popc(x & (x >> 1) & 0x55555555u & ((1u << (2 * tail)) - 1u));
  }
  return cnt;
}

__device__ __forceinline__ int32_t wide_sym(const uint32_t* row, int32_t pos) {
  const int32_t in_row = pos - ((pos + 1) / WIDE_BLOCK) * WIDE_BLOCK;
  const uint32_t w = in_row < 0 ? __ldg(row + WIDE_PREV)
                                : __ldg(row + WIDE_OFF + (in_row >> 4));
  return static_cast<int32_t>((w >> ((pos & 15) * 2)) & 3u);
}

// BWT rank_inclusive(c, pos) and, when asked, the symbol at pos; pos = -1
// gives rank 0.
__device__ __forceinline__ int32_t plain_rank_sym(const FMView& f, int32_t c, int32_t pos,
                                                  int32_t* sym) {
  const uint32_t* row = wide_row(f, pos);
  if (sym) *sym = wide_sym(row, pos);
  if (pos < 0) return 0;
  return static_cast<int32_t>(__ldg(row + c)) +
         wide_prefix_count(row, c, (pos + 1) % WIDE_BLOCK);
}

// LF-mapping of row p >= 0 from one wide row.
__device__ __forceinline__ int32_t plain_lf(const FMView& f, int32_t p) {
  const uint32_t* row = wide_row(f, p);
  const int32_t sym = wide_sym(row, p);
  const int32_t rank = static_cast<int32_t>(__ldg(row + sym)) +
                       wide_prefix_count(row, sym, (p + 1) % WIDE_BLOCK);
  const int32_t corr = (sym == f.last_chr && p < f.first_isa) ? 1 : 0;
  return __ldg(f.psum + sym) + rank + corr - 1;
}
