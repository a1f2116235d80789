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
//
// Two ways to rank from a row.  On this card a rank costs one row fetch from
// L2 or HBM, a few hundred cycles of latency; the arithmetic (a masked 2-bit
// SWAR popc a word) is small.  So what bounds a chain of dependent ranks is
// how many memory rounds a rank takes, and then the instructions a step
// issues.
//   plain_rank_sym / plain_lf   one thread reads the words it needs one by one
//                               (up to 121 loads, each used before the next
//                               is known to be needed).  Only rank_probe's
//                               one-thread modes (0-2), which measure it,
//                               rank this way: the other kernels use the
//                               group on the plain layouts (the run-block
//                               and generic layouts have a group of their
//                               own, rank_runblock.cuh).
//   group_rank / group_lf       a warp (RankGroup): thread t holds words
//                               [4 t, 4 t + 4) as one 16-byte load, all issued
//                               before any is used, so a rank is one memory
//                               round; the counts are summed with one warp
//                               reduction and the occ, hi, prev and symbol
//                               words are shuffled from the thread that loaded
//                               them.  K1, K5, and K2's and K3's LF walks
//                               use it.
//                               Rows must be 16-byte aligned (the launch path
//                               checks it).
#pragma once
#include "fm_view.cuh"

#define WIDE_BLOCK 1920
#define WIDE_WORDS 128
#define WIDE_DATA 120
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

// ------------------------------------------------------------ group rank

// A warp runs one lane on the plain layouts.  Thread t of the warp holds
// words [4 t, 4 t + 4) of a row, one 16-byte load.  Every thread computes the
// same lane state, so control flow is uniform in the warp and each *_sync
// call below has all 32 threads.
constexpr unsigned WARP_ALL = 0xFFFFFFFFu;

struct RankGroup {
  int t;   // this thread's lane in the warp
  static __device__ __forceinline__ RankGroup here() {
    return RankGroup{static_cast<int>(threadIdx.x & 31u)};
  }
};

// Words [4 t, 4 t + 4) of one wide row, held by thread t.
struct RowSlice {
  uint4 q;
  // word i of the four: a chain of selects for a run-time i (no local memory)
  __device__ __forceinline__ uint32_t word(int i) const {
    return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
  }
};

// Symbol slots of pos's row that come before pos + 1 (pos >= -1).
template <class Idx>
__device__ __forceinline__ int32_t wide_upto(Idx pos) {
  return static_cast<int32_t>((pos + 1) % WIDE_BLOCK);
}

// Row words a rank with `upto` slots reads: the header (occ, hi, prev) and
// ceil(upto / 16) data words.
__device__ __forceinline__ int32_t wide_words_needed(int32_t upto) {
  return WIDE_OFF + ((upto + 15) >> 4);
}

// Thread t's slice of `row`: one 16-byte load, made only where it holds a
// word the rank needs (else it reads 0), so the bytes read are those
// TorchFM._row_words counts, rounded up to 16.
__device__ __forceinline__ RowSlice load_slice(const uint32_t* row, int t, int32_t upto) {
  RowSlice s{make_uint4(0u, 0u, 0u, 0u)};
  if (4 * t < wide_words_needed(upto)) s.q = __ldg(reinterpret_cast<const uint4*>(row) + t);
  return s;
}

// Occurrences of c among the first `upto` symbol slots in thread t's words:
// data word j = 4 t + i - WIDE_OFF keeps its first clamp(upto - 16j, 0, 16)
// slots; header and pad words keep none.
__device__ __forceinline__ uint32_t slice_count(const RowSlice& s, int t, uint32_t c,
                                                int32_t upto) {
  if (4 * t >= wide_words_needed(upto)) return 0;
  const uint32_t pat = c * 0x55555555u;
  const int32_t left = upto - 16 * (4 * t - WIDE_OFF);   // slots from this thread's word 0
  uint32_t cnt = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int32_t j = 4 * t + i - WIDE_OFF;
    const int32_t nb = 2 * min(max(left - 16 * i, 0), 16);
    const uint32_t keep = static_cast<uint32_t>(j) >= WIDE_DATA ? 0u
                          : nb >= 32 ? 0x55555555u : ((1u << nb) - 1u) & 0x55555555u;
    const uint32_t x = ~(s.word(i) ^ pat);
    cnt += __popc(x & (x >> 1) & keep);
  }
  return cnt;
}

// The symbol at pos from the warp's slices of pos's row: data word
// (upto - 1) / 16, or prev_word where upto == 0, from the thread holding it.
template <class Idx>
__device__ __forceinline__ int32_t group_sym(const RowSlice& s, Idx pos, int32_t upto) {
  const int32_t w = upto == 0 ? WIDE_PREV : WIDE_OFF + ((upto - 1) >> 4);
  const uint32_t sw = __shfl_sync(WARP_ALL, s.word(w & 3), w >> 2);
  return static_cast<int32_t>((sw >> ((pos & 15) * 2)) & 3u);
}

// BWT rank_inclusive(c, pos) from the warp's slices of pos's row; pos = -1
// gives 0.  Every thread of the warp returns it.
template <class Idx>
__device__ __forceinline__ Idx group_rank(const RankGroup& g, const RowSlice& s, int32_t c,
                                          Idx pos, int32_t upto) {
  const uint32_t cnt = __reduce_add_sync(WARP_ALL, slice_count(s, g.t, c, upto));
  // occ_A..occ_T are words 0..3 (thread 0), occ_hi word 4 (thread 1)
  Idx occ = __shfl_sync(WARP_ALL, s.word(c), 0);
  if constexpr (sizeof(Idx) == 8)
    occ |= static_cast<Idx>((__shfl_sync(WARP_ALL, s.word(WIDE_HI & 3), WIDE_HI >> 2) >>
                             (8 * c)) & 0xFFu)
           << 32;
  return pos < 0 ? Idx(0) : occ + static_cast<Idx>(cnt);
}

// LF-mapping of row p >= 0: one slice of one row, the symbol from it, then
// the rank of that symbol.
template <class Idx, class Rows>
__device__ __forceinline__ Idx group_lf(const FMView& f, const RankGroup& g, Idx p) {
  const int32_t upto = wide_upto(p);
  const RowSlice s = load_slice(Rows::row(f, p), g.t, upto);
  const int32_t sym = group_sym(s, p, upto);
  const Idx rank = group_rank<Idx>(g, s, sym, p, upto);
  const Idx corr = (sym == f.last_chr && p < static_cast<Idx>(f.first_isa)) ? 1 : 0;
  return tab<Idx>(f.psum, sym) + rank + corr - 1;
}
