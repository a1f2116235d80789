// Rank layout "plain": 512-byte wide rank rows of 128 uint32 words covering
// 1920 BWT symbols each,
//   [occ_A, occ_C, occ_G, occ_T, occ_hi, prev_word, w0..w119, pad, pad]
// where w_i holds 16 2-bit symbols (little-endian) and prev_word is the
// previous row's w119, so the symbol at pos comes from the same row as the
// rank at pos even when (pos + 1) % 1920 == 0.  Value-identical to
// TorchFM._plain_rank_sym / _plain_lf and to
// centrifuger_tpu/fm/device.py DeviceFM._plain_rank_sym / _plain_lf.
//
// Templates over the index type Idx (int32_t, or int64_t for kernel K9,
// DeviceFM._wide_occ :487-499): an int64 occ is the lo word plus bits 32..39
// from byte c of occ_hi.  Row ids stay 32-bit (n / 1920 < 2^31): only the
// occ sum and the psum offset are 64-bit.
#pragma once
#include "fm_view.cuh"

#define WIDE_BLOCK 1920
#define WIDE_WORDS 128
#define WIDE_HI 4
#define WIDE_OFF 6
#define WIDE_PREV 5

// The wide row that holds pos's rank (pos >= -1; row (pos + 1) / 1920 holds
// the occ before slot pos + 1), from the whole table.
struct WholeRows {
  template <class Idx>
  static __device__ __forceinline__ const uint32_t* row(const FMView& f, Idx pos) {
    const int32_t r = static_cast<int32_t>((pos + 1) / WIDE_BLOCK);
    return reinterpret_cast<const uint32_t*>(f.rows) + static_cast<int64_t>(r) * WIDE_WORDS;
  }
};

// ... from its owner shard (kernel K10, _ShardedFMView._plain_rows_fetch of
// centrifuger_tpu/parallel/sharded.py): one 8-byte load of the shard's
// address from the D-entry table, which stays in L1, and a 32-bit divide.
// The row id and rps_rows are below 2^31 (n / 1920 + 1 rows).
struct ShardedRows {
  template <class Idx>
  static __device__ __forceinline__ const uint32_t* row(const FMView& f, Idx pos) {
    const uint32_t r = static_cast<uint32_t>((pos + 1) / WIDE_BLOCK);
    const uint32_t rps = static_cast<uint32_t>(f.rps_rows);
    const uint32_t* shard =
        reinterpret_cast<const uint32_t*>(__ldg(f.rows_shards + r / rps));
    return shard + static_cast<int64_t>(r % rps) * WIDE_WORDS;
  }
};

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

template <class Idx>
__device__ __forceinline__ int32_t wide_sym(const uint32_t* row, Idx pos) {
  const int32_t in_row = static_cast<int32_t>(pos - ((pos + 1) / WIDE_BLOCK) * WIDE_BLOCK);
  const uint32_t w = in_row < 0 ? __ldg(row + WIDE_PREV)
                                : __ldg(row + WIDE_OFF + (in_row >> 4));
  return static_cast<int32_t>((w >> ((pos & 15) * 2)) & 3u);
}

// The occ checkpoint of c from a wide row.
template <class Idx>
__device__ __forceinline__ Idx wide_occ(const uint32_t* row, int32_t c) {
  const uint32_t lo = __ldg(row + c);
  if constexpr (sizeof(Idx) == 8)
    return static_cast<Idx>(lo) |
           (static_cast<Idx>((__ldg(row + WIDE_HI) >> (8 * c)) & 0xFFu) << 32);
  else
    return static_cast<Idx>(lo);
}

// BWT rank_inclusive(c, pos) and, when asked, the symbol at pos; pos = -1
// gives rank 0.  Rows is WholeRows or ShardedRows.
template <class Idx, class Rows = WholeRows>
__device__ __forceinline__ Idx plain_rank_sym(const FMView& f, int32_t c, Idx pos, int32_t* sym) {
  const uint32_t* row = Rows::row(f, pos);
  if (sym) *sym = wide_sym(row, pos);
  if (pos < 0) return 0;
  return wide_occ<Idx>(row, c) +
         wide_prefix_count(row, c, static_cast<int32_t>((pos + 1) % WIDE_BLOCK));
}

// LF-mapping of row p >= 0 from one wide row.
template <class Idx, class Rows = WholeRows>
__device__ __forceinline__ Idx plain_lf(const FMView& f, Idx p) {
  const uint32_t* row = Rows::row(f, p);
  const int32_t sym = wide_sym(row, p);
  const Idx rank = wide_occ<Idx>(row, sym) +
                   wide_prefix_count(row, sym, static_cast<int32_t>((p + 1) % WIDE_BLOCK));
  const Idx corr = (sym == f.last_chr && p < static_cast<Idx>(f.first_isa)) ? 1 : 0;
  return tab<Idx>(f.psum, sym) + rank + corr - 1;
}
