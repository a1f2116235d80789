// The index as the kernels see it: device pointers and scalars of TorchFM
// (centrifuger_tpu_torch/fm/device.py).  A layout's tables are null where the
// index was loaded with another layout.  Table words are uint32 bits behind
// int32 pointers; the position, rank and count tables (`const void*` below)
// hold the index type, int32_t or int64_t as idx64 says (kernel K9), and the
// kernels read them through tab<Idx>.
//
// LAYOUT_PLAIN_SHARDED (kernel K10, centrifuger_tpu/parallel/sharded.py) is
// the plain layout with its three big tables row-sharded: `rows`, `rowmap`
// and `sampled_sa` are null, and row r of such a table lives in shard
// r / rps at row r % rps.  The *_shards fields are device arrays of n_shards
// addresses on the launching device; a shard may lie on another card, read
// over NVLink with peer access on.  The small tables stay whole, one copy on
// each card that holds shards.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#define LAYOUT_PLAIN 0
#define LAYOUT_RUNBLOCK 1
#define LAYOUT_GENERIC 2
#define LAYOUT_PLAIN_SHARDED 3

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
  // sharded plain layout (K10); null / 0 elsewhere
  const long long* rows_shards;   // [n_shards] addresses of [rps_rows, 128] int32 shards
  const long long* rowmap_shards; // [n_shards] addresses of [rps_map] int32 shards
  const long long* sampled_shards;  // [n_shards] addresses of [rps_sa] Idx shards
  int64_t rps_map, rps_sa;        // rows a shard of the rowmap / the sampled SA
  int32_t rps_rows, n_shards;     // wide rows a shard; shards a table
  int32_t has_rowmap;             // the index has a rowmap (whole or sharded)
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

// Lets kernels running on `device` read memory of `peer` (the shards a
// sharded index keeps there).  *can_access is cudaDeviceCanAccessPeer's
// answer; peer access is enabled only where it is 1.  Returns the CUDA error;
// an access enabled before is no error.
extern "C" int cfr_enable_peer_access(int device, int peer, int* can_access) {
  cudaError_t e = cudaDeviceCanAccessPeer(can_access, device, peer);
  if (e != cudaSuccess || !*can_access) return static_cast<int>(e);
  int prev = 0;
  e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaSetDevice(device);
  if (e == cudaSuccess) {
    e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();   // clear the error the call recorded
      e = cudaSuccess;
    }
  }
  const cudaError_t r = cudaSetDevice(prev);
  return static_cast<int>(e != cudaSuccess ? e : r);
}
