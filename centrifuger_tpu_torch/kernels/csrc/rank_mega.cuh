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
// row is the next one.  Bound: three dependent 84-byte fetches at random rows
// (latency); the indicator row decides both stream rows, so only those two
// overlap.  The TPU version stacks the two stream fetches into one [2M]
// gather round; here they are two independent loads of one thread.
#pragma once
#include "fm_view.cuh"

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
