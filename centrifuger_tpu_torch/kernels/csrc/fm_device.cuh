// Shared __device__ functions of the FM-index kernels: wide-row rank and
// symbol, BackwardExtend, LF and the single-row SA resolve.
//
// Index layout (centrifuger_tpu_torch/fm/device.py, TorchFM): 512-byte wide
// rank rows of 128 uint32 words covering 1920 BWT symbols each,
//   [occ_A, occ_C, occ_G, occ_T, occ_hi, prev_word, w0..w119, pad, pad]
// where w_i holds 16 2-bit symbols (little-endian) and prev_word is the
// previous row's w119, so the symbol at pos comes from the same row as the
// rank at pos even when (pos + 1) % 1920 == 0.  All positions are int32
// (n < 2^31 - 8).  Each function is value-identical to its plain twin in
// TorchFM and to centrifuger_tpu.fm.device.DeviceFM.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#define WIDE_BLOCK 1920
#define WIDE_WORDS 128
#define WIDE_OFF 6
#define WIDE_PREV 5

struct FMView {              // mirrored by kernels/__init__.py:FMView
  const int32_t* rows;       // [n / 1920 + 1, 128], uint32 bits
  const int32_t* ftab;       // [2 * 4^pw] interleaved (start, len)
  const int32_t* psum;       // [5]
  const int32_t* sampled_sa; // [n / sample_rate + 1]
  const int32_t* sel_rows;   // [n_sel] sorted, or null
  const int32_t* sel_vals;   // [n_sel], or null
  const int32_t* rowmap;     // [n], or null
  int32_t n, first_isa, last_chr, sample_rate, adjusted_sa0, pw;
  int32_t n_sel;
};

extern "C" const char* cfr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

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

// BWT rank_inclusive(c, pos); pos = -1 gives 0.
__device__ __forceinline__ int32_t rank_at(const FMView& f, int32_t c, int32_t pos,
                                           int32_t* sym) {
  const uint32_t* row = wide_row(f, pos);
  if (sym) *sym = wide_sym(row, pos);
  if (pos < 0) return 0;
  return static_cast<int32_t>(__ldg(row + c)) +
         wide_prefix_count(row, c, (pos + 1) % WIDE_BLOCK);
}

// FMIndex::BackwardExtend with the displaced-last-char corrections.
__device__ __forceinline__ void backward_extend(const FMView& f, int32_t c, int32_t sp,
                                                int32_t ep, int32_t* nsp, int32_t* nep) {
  const int32_t off = __ldg(f.psum + c);
  int32_t sym_ep;
  const int32_t r_sp = rank_at(f, c, sp - 1, nullptr);
  const int32_t r_ep = rank_at(f, c, ep, &sym_ep);
  const bool last = c == f.last_chr;
  const int32_t s = off + r_sp + ((last && sp <= f.first_isa) ? 1 : 0);
  *nsp = s;
  if (sp == ep)
    *nep = s + (sym_ep == c ? 0 : -1);
  else
    *nep = off + r_ep + ((last && ep < f.first_isa) ? 1 : 0) - 1;
}

// LF-mapping of row p >= 0 from one wide row.
__device__ __forceinline__ int32_t lf(const FMView& f, int32_t p) {
  const uint32_t* row = wide_row(f, p);
  const int32_t sym = wide_sym(row, p);
  const int32_t rank = static_cast<int32_t>(__ldg(row + sym)) +
                       wide_prefix_count(row, sym, (p + 1) % WIDE_BLOCK);
  const int32_t corr = (sym == f.last_chr && p < f.first_isa) ? 1 : 0;
  return __ldg(f.psum + sym) + rank + corr - 1;
}

// Index of `row` in sel_rows, or -1 (binary search over the sorted table).
__device__ __forceinline__ int32_t sel_find(const FMView& f, int32_t row) {
  int32_t lo = 0, hi = f.n_sel;
  while (lo < hi) {
    const int32_t mid = (lo + hi) >> 1;
    if (__ldg(f.sel_rows + mid) < row) lo = mid + 1; else hi = mid;
  }
  return (lo < f.n_sel && __ldg(f.sel_rows + lo) == row) ? lo : -1;
}

// SA row -> stored value (BackwardToSampledSA): one rowmap load, or the LF
// walk to a first-ISA, sampled or selected row, then that row's value.
__device__ __forceinline__ int32_t resolve_one(const FMView& f, int32_t row) {
  if (f.rowmap) return __ldg(f.rowmap + min(max(row, 0), f.n - 1));
  int32_t cur = row;
  while (true) {
    if (cur == f.first_isa) return f.adjusted_sa0;
    if (cur % f.sample_rate == 0) return __ldg(f.sampled_sa + cur / f.sample_rate);
    if (f.n_sel) {
      const int32_t k = sel_find(f, cur);
      if (k >= 0) return __ldg(f.sel_vals + k);
    }
    cur = lf(f, cur);
  }
}

// ftab lookup of a packed pw-mer: (start, len).
__device__ __forceinline__ void ftab_entry(const FMView& f, int32_t kmer, int32_t* start,
                                           int32_t* len) {
  const int2 e = __ldg(reinterpret_cast<const int2*>(f.ftab) + kmer);
  *start = e.x;
  *len = e.y;
}
