// The index as the kernels see it: device pointers and scalars of TorchFM
// (centrifuger_tpu_torch/fm/device.py).  A layout's tables are null where the
// index was loaded with another layout.  Table words are uint32 bits behind
// int32 pointers; the position, rank and count tables (`const void*` below)
// hold the index type, int32_t or int64_t as idx64 says (kernel K9), and the
// kernels read them through tab<Idx>.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#define LAYOUT_PLAIN 0
#define LAYOUT_RUNBLOCK 1
#define LAYOUT_GENERIC 2

struct FMView {                   // mirrored by kernels/__init__.py:FMView
  const int32_t* rows;            // plain: [n / 1920 + 1, 128] wide rank rows
  const int32_t* mega;            // runblock (int32 only): [R, 21] indicator, lit, run rows
  const int32_t* ind_words;       // generic: indicator bits, [ngrp, 8]
  const void* ind_cum;            // generic: ones before each 8-word group
  const int32_t* lit_words;       // generic: literal stream, [nblk, 256 / per_word]
  const void* lit_occ;            // generic: [nblk, sigma]
  const int32_t* run_words;       // generic: run stream
  const void* run_occ;
  const void* ftab;               // [2 * ftab_size] interleaved (start, len)
  const void* psum;               // [sigma + 1]
  const void* sampled_sa;         // [n / sample_rate + 1]
  const void* sel_rows;           // [n_sel] sorted, or null
  const void* sel_vals;           // [n_sel], or null
  const void* end_marker_sa;      // [n_end], or null
  const int32_t* rowmap;          // [n] int32 (n < 2^31 wherever there is one), or null
  int64_t ftab_size;              // 2^(code_bits * pw)
  int64_t n, first_isa, adjusted_sa0;
  int64_t lit_n, run_n;           // stream lengths
  int32_t layout, idx64, last_chr, sample_rate, pw, code_bits, sigma;
  int32_t n_sel, n_end;
  int32_t b, b_lt_n;              // run-block size; 0 when one block covers the BWT
  int32_t width;                  // generic: bits a symbol in the streams (2, 4, 8)
  int32_t m_lit, m_run;           // runblock: first literal / run row of mega
};

// Element i of a table of the index type.
template <class Idx>
__device__ __forceinline__ Idx tab(const void* t, int64_t i) {
  if constexpr (sizeof(Idx) == 8)
    return static_cast<Idx>(__ldg(static_cast<const long long*>(t) + i));
  else
    return __ldg(static_cast<const int32_t*>(t) + i);
}

extern "C" const char* cfr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
