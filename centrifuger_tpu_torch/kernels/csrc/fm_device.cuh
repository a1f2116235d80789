// Shared __device__ functions of the FM-index kernels.  Every index access of
// chain_search.cu, resolve_rows.cu, finalize_units.cu, prefix_search.cu and
// rank_probe.cu goes through a rank layout: a struct with
//
//   Idx                         the index type, int32_t or int64_t
//   rank_sym(f, c, pos, &sym)   BWT rank_inclusive(c, pos) and the symbol at
//                               pos; pos >= -1, and -1 gives rank 0
//   backward_extend(f, c, sp, ep, &nsp, &nep)   FMIndex::BackwardExtend
//   lf(f, p)                    the LF-mapping of row p >= 0
//   has_rowmap(f)               the index has a rowmap
//   rowmap_at(f, i)             rowmap[i], 0 <= i < n
//   sampled_at(f, i)            sampled_sa[i]
//
// PlainLayout<Idx> (rank_plain.cuh), MegaLayout (rank_mega.cuh, int32 only)
// and GenericLayout<Idx> (rank_runblock.cuh) give the same values on the same
// index, and so does ShardedPlainLayout<Idx>, the plain layout whose wide
// rows, rowmap and sampled SA are row-sharded (kernel K10); the kernels are
// templates over the layout and CFR_DISPATCH_LAYOUT picks the instantiation
// from FMView::layout and FMView::idx64.  The int64
// instantiations are kernel K9 (centrifuger_tpu/fm/device.py DeviceFM's
// idtype switch, :215-231): positions, ranks and the index tables in 64 bits,
// symbols, read positions and table words in 32.  Each function is
// value-identical to its plain twin in TorchFM and to
// centrifuger_tpu.fm.device.DeviceFM.
#pragma once
#include "fm_view.cuh"
#include "rank_mega.cuh"
#include "rank_plain.cuh"
#include "rank_runblock.cuh"

// BackwardExtend's result from the two ranks (sp - 1 and ep) and the symbol
// at ep, with the displaced-last-char corrections; the sp == ep shortcut
// reads the symbol of the same row fetch.
template <class Idx>
__device__ __forceinline__ void extend_from_ranks(const FMView& f, int32_t c, Idx sp, Idx ep,
                                                  Idx r_sp, Idx r_ep, int32_t sym_ep, Idx* nsp,
                                                  Idx* nep) {
  const Idx off = tab<Idx>(f.psum, c);
  const Idx fi = static_cast<Idx>(f.first_isa);
  const bool last = c == f.last_chr;
  const Idx s = off + r_sp + ((last && sp <= fi) ? 1 : 0);
  *nsp = s;
  if (sp == ep)
    *nep = s + (sym_ep == c ? 0 : -1);
  else
    *nep = off + r_ep + ((last && ep < fi) ? 1 : 0) - 1;
}

// BackwardExtend from a layout's rank_sym.
template <class Layout>
__device__ __forceinline__ void extend_by_rank_sym(const FMView& f, int32_t c,
                                                   typename Layout::Idx sp,
                                                   typename Layout::Idx ep,
                                                   typename Layout::Idx* nsp,
                                                   typename Layout::Idx* nep) {
  using Idx = typename Layout::Idx;
  int32_t sym_ep;
  const Idx r_sp = Layout::rank_sym(f, c, sp - 1, nullptr);
  const Idx r_ep = Layout::rank_sym(f, c, ep, &sym_ep);
  extend_from_ranks<Idx>(f, c, sp, ep, r_sp, r_ep, sym_ep, nsp, nep);
}

// The rowmap and the sampled SA read from the whole tables: the table access
// of every layout but the sharded one.
template <class Idx>
struct WholeTables {
  static __device__ __forceinline__ bool has_rowmap(const FMView& f) {
    return f.rowmap != nullptr;
  }
  static __device__ __forceinline__ Idx rowmap_at(const FMView& f, Idx i) {
    return __ldg(f.rowmap + i);
  }
  static __device__ __forceinline__ Idx sampled_at(const FMView& f, Idx i) {
    return tab<Idx>(f.sampled_sa, i);
  }
};

template <class Idx_>
struct PlainLayout : WholeTables<Idx_> {
  using Idx = Idx_;
  static __device__ __forceinline__ Idx rank_sym(const FMView& f, int32_t c, Idx pos,
                                                 int32_t* sym) {
    return plain_rank_sym<Idx>(f, c, pos, sym);
  }
  static __device__ __forceinline__ void backward_extend(const FMView& f, int32_t c, Idx sp,
                                                         Idx ep, Idx* nsp, Idx* nep) {
    extend_by_rank_sym<PlainLayout>(f, c, sp, ep, nsp, nep);
  }
  static __device__ __forceinline__ Idx lf(const FMView& f, Idx p) { return plain_lf<Idx>(f, p); }
};

// The mega-table's row math is 32-bit: int32 indexes only (DeviceFM.fast).
struct MegaLayout : WholeTables<int32_t> {
  using Idx = int32_t;
  static __device__ __forceinline__ int32_t rank_sym(const FMView& f, int32_t c, int32_t pos,
                                                     int32_t* sym) {
    return mega_rank_sym(f, c, pos, sym);
  }
  static __device__ __forceinline__ void backward_extend(const FMView& f, int32_t c,
                                                         int32_t sp, int32_t ep, int32_t* nsp,
                                                         int32_t* nep) {
    extend_by_rank_sym<MegaLayout>(f, c, sp, ep, nsp, nep);
  }
  // two rank calls: the symbol first (the rank of a dummy c is discarded)
  static __device__ __forceinline__ int32_t lf(const FMView& f, int32_t p) {
    int32_t sym;
    mega_rank_sym(f, 0, p, &sym);
    const int32_t r = mega_rank_sym(f, sym, p, nullptr);
    const int32_t corr = (sym == f.last_chr && p < f.first_isa) ? 1 : 0;
    return tab<int32_t>(f.psum, sym) + r + corr - 1;
  }
};

template <class Idx_>
struct GenericLayout : WholeTables<Idx_> {
  using Idx = Idx_;
  static __device__ __forceinline__ Idx rank_sym(const FMView& f, int32_t c, Idx pos,
                                                 int32_t* sym) {
    if (sym) *sym = bwt_access(f, tmax(pos, Idx(0)));
    return pos < 0 ? 0 : bwt_rank(f, c, pos);
  }
  static __device__ __forceinline__ void backward_extend(const FMView& f, int32_t c, Idx sp,
                                                         Idx ep, Idx* nsp, Idx* nep) {
    const Idx off = tab<Idx>(f.psum, c);
    const Idx s = off + fm_rank(f, c, sp, false);
    *nsp = s;
    if (sp == ep)
      *nep = s + (bwt_access(f, ep) == c ? 0 : -1);
    else
      *nep = off + fm_rank(f, c, ep, true) - 1;
  }
  static __device__ __forceinline__ Idx lf(const FMView& f, Idx p) {
    const int32_t c = bwt_access(f, p);
    return tab<Idx>(f.psum, c) + fm_rank(f, c, p, true) - 1;
  }
};

// Kernel K10: the plain layout with every read of a sharded table routed to
// its owner shard (centrifuger_tpu/parallel/sharded.py _ShardedFMView:
// _plain_rows_fetch, _rowmap_fetch, _sampled_sa_fetch).  Row r of a table
// lives at shards[r / rps] + r % rps: one load of the shard's address (the
// D-entry table stays in L1), a divide and a remainder.  Each lane runs to
// completion on its own warp (Lanes<Layout>), so the JAX program's lockstep
// termination (_loop_any) has no counterpart.  The rowmap index is clamped
// to [0, n - 1] by rowmap_value before it is routed, so no pad row of the
// last shard is read.
template <class Idx_>
struct ShardedPlainLayout {
  using Idx = Idx_;
  static __device__ __forceinline__ Idx rank_sym(const FMView& f, int32_t c, Idx pos,
                                                 int32_t* sym) {
    return plain_rank_sym<Idx, ShardedRows>(f, c, pos, sym);
  }
  static __device__ __forceinline__ void backward_extend(const FMView& f, int32_t c, Idx sp,
                                                         Idx ep, Idx* nsp, Idx* nep) {
    extend_by_rank_sym<ShardedPlainLayout>(f, c, sp, ep, nsp, nep);
  }
  static __device__ __forceinline__ Idx lf(const FMView& f, Idx p) {
    return plain_lf<Idx, ShardedRows>(f, p);
  }
  static __device__ __forceinline__ bool has_rowmap(const FMView& f) {
    return f.has_rowmap != 0;
  }
  static __device__ __forceinline__ Idx rowmap_at(const FMView& f, Idx i) {
    const int64_t j = i;
    return __ldg(reinterpret_cast<const int32_t*>(__ldg(f.rowmap_shards + j / f.rps_map)) +
                 j % f.rps_map);
  }
  static __device__ __forceinline__ Idx sampled_at(const FMView& f, Idx i) {
    const int64_t j = i;
    return tab<Idx>(reinterpret_cast<const void*>(__ldg(f.sampled_shards + j / f.rps_sa)),
                    j % f.rps_sa);
  }
};

// Runs the statement with `Layout` naming the rank layout of the index and
// `Layout::Idx` its index type: plain x {int32, int64}, mega x int32 and
// generic x {int32, int64}, and sharded plain x {int32, int64}.  Returns
// cudaErrorInvalidValue from the enclosing launch function for any other pair
// (TorchFM and ShardedIndex make none).
#define CFR_DISPATCH_LAYOUT(f, ...)                                                   \
  do {                                                                                \
    if ((f)->idx64) {                                                                 \
      switch ((f)->layout) {                                                          \
        case LAYOUT_PLAIN: { using Layout = PlainLayout<int64_t>; __VA_ARGS__; break; }   \
        case LAYOUT_GENERIC: { using Layout = GenericLayout<int64_t>; __VA_ARGS__; break; } \
        case LAYOUT_PLAIN_SHARDED: {                                                  \
          using Layout = ShardedPlainLayout<int64_t>; __VA_ARGS__; break; }           \
        default: return static_cast<int>(cudaErrorInvalidValue);                      \
      }                                                                               \
    } else {                                                                          \
      switch ((f)->layout) {                                                          \
        case LAYOUT_PLAIN: { using Layout = PlainLayout<int32_t>; __VA_ARGS__; break; }   \
        case LAYOUT_RUNBLOCK: { using Layout = MegaLayout; __VA_ARGS__; break; }      \
        case LAYOUT_GENERIC: { using Layout = GenericLayout<int32_t>; __VA_ARGS__; break; } \
        case LAYOUT_PLAIN_SHARDED: {                                                  \
          using Layout = ShardedPlainLayout<int32_t>; __VA_ARGS__; break; }           \
        default: return static_cast<int>(cudaErrorInvalidValue);                      \
      }                                                                               \
    }                                                                                 \
  } while (0)

// Index of `row` in sel_rows, or -1 (binary search over the sorted table).
template <class Idx>
__device__ __forceinline__ int32_t sel_find(const FMView& f, Idx row) {
  int32_t lo = 0, hi = f.n_sel;
  while (lo < hi) {
    const int32_t mid = (lo + hi) >> 1;
    if (tab<Idx>(f.sel_rows, mid) < row) lo = mid + 1; else hi = mid;
  }
  return (lo < f.n_sel && tab<Idx>(f.sel_rows, lo) == row) ? lo : -1;
}

// ---------------------------------------------------------- lane groups
// How a kernel that runs each lane to completion spreads a lane over
// threads.  Lanes<Layout> is a warp on every layout: GroupLanes on the two
// plain layouts (one memory round a step, each thread one 16-byte load of
// each wide row: RankGroup, rank_plain.cuh), MegaLanes on the run-block
// layout and GenericLanes on the generic one (two rounds a step, the
// indicator and then the streams: rank_runblock.cuh).
// chain_search, prefix_search and the LF walks of resolve_rows and
// finalize_units run on Lanes<Layout>; SoloLanes (one thread) is the rowmap
// branch of resolve_rows, which ranks nothing, and rank_probe's modes 0-2
// call the layouts' one-thread code directly, a thread a query.

struct Solo {
  int t;   // always 0: the thread is its lane's leader
  static __device__ __forceinline__ Solo here() { return Solo{0}; }
};

template <class Layout>
struct SoloLanes {
  using Idx = typename Layout::Idx;
  using Group = Solo;
  static constexpr int G = 1;
  static __device__ __forceinline__ void backward_extend(const FMView& f, const Solo&, int32_t c,
                                                         Idx sp, Idx ep, Idx* nsp, Idx* nep) {
    Layout::backward_extend(f, c, sp, ep, nsp, nep);
  }
  static __device__ __forceinline__ Idx lf(const FMView& f, const Solo&, Idx p) {
    return Layout::lf(f, p);
  }
};

template <class Idx_, class Rows>
struct GroupLanes {
  using Idx = Idx_;
  using Group = RankGroup;
  static constexpr int G = 32;   // a warp
  // both rows' loads are issued before either rank is summed: one memory
  // round a step
  static __device__ __forceinline__ void backward_extend(const FMView& f, const Group& g,
                                                         int32_t c, Idx sp, Idx ep, Idx* nsp,
                                                         Idx* nep) {
    const Idx p0 = sp - 1;
    const int32_t u0 = wide_upto(p0), u1 = wide_upto(ep);
    const RowSlice s0 = load_slice(Rows::row(f, p0), g.t, u0);
    const RowSlice s1 = load_slice(Rows::row(f, ep), g.t, u1);
    const Idx r_sp = group_rank<Idx>(g, s0, c, p0, u0);
    // sp == ep (most steps once a chain is unique) needs only the symbol at
    // ep: extend_from_ranks' shortcut
    const Idx r_ep = sp == ep ? Idx(0) : group_rank<Idx>(g, s1, c, ep, u1);
    extend_from_ranks<Idx>(f, c, sp, ep, r_sp, r_ep, group_sym(s1, ep, u1), nsp, nep);
  }
  static __device__ __forceinline__ Idx lf(const FMView& f, const Group& g, Idx p) {
    return group_lf<Idx, Rows>(f, g, p);
  }
};

// The rank of sp - 1 is 0 where sp == 0, and the ep count is skipped where
// sp == ep (only the symbol at ep is needed): extend_from_ranks' shortcut.
// A warp a lane ran the run-block and the protein chain faster than a
// half-warp (PERF.md, findings, "A warp against a half-warp").
struct MegaLanes {
  using Idx = int32_t;
  using Group = RankGroup;
  static constexpr int G = 32;   // a warp
  static __device__ __forceinline__ void backward_extend(const FMView& f, const Group& g,
                                                         int32_t c, int32_t sp, int32_t ep,
                                                         int32_t* nsp, int32_t* nep) {
    int32_t r_sp, r_ep, sym_ep;
    mega_group_pair(f, g, c, sp - 1, sp > 0, ep, sp != ep, &r_sp, &r_ep, &sym_ep);
    extend_from_ranks<int32_t>(f, c, sp, ep, r_sp, r_ep, sym_ep, nsp, nep);
  }
  static __device__ __forceinline__ int32_t lf(const FMView& f, const Group& g, int32_t p) {
    int32_t sym;
    const int32_t r = mega_group_lf_rank(f, g, p, &sym);
    const int32_t corr = (sym == f.last_chr && p < f.first_isa) ? 1 : 0;
    return tab<int32_t>(f.psum, sym) + r + corr - 1;
  }
};

// The stream width is a run-time field of the index: each step picks the
// W-bit instantiation (the branch is the same in every thread).
template <class Idx_>
struct GenericLanes {
  using Idx = Idx_;
  using Group = RankGroup;
  static constexpr int G = 32;   // a warp
  static __device__ __forceinline__ void backward_extend(const FMView& f, const Group& g,
                                                         int32_t c, Idx sp, Idx ep, Idx* nsp,
                                                         Idx* nep) {
    Idx r_sp, r_ep;
    int32_t sym_ep;
    const bool need_a = sp > 0, count_b = sp != ep;
    switch (f.width) {
      case 2: generic_group_pair<Idx, 2>(f, g, c, sp - 1, need_a, ep, count_b, &r_sp, &r_ep,
                                         &sym_ep); break;
      case 4: generic_group_pair<Idx, 4>(f, g, c, sp - 1, need_a, ep, count_b, &r_sp, &r_ep,
                                         &sym_ep); break;
      default: generic_group_pair<Idx, 8>(f, g, c, sp - 1, need_a, ep, count_b, &r_sp, &r_ep,
                                          &sym_ep);
    }
    extend_from_ranks<Idx>(f, c, sp, ep, r_sp, r_ep, sym_ep, nsp, nep);
  }
  static __device__ __forceinline__ Idx lf(const FMView& f, const Group& g, Idx p) {
    int32_t sym;
    Idx r;
    switch (f.width) {
      case 2: r = generic_group_lf_rank<Idx, 2>(f, g, p, &sym); break;
      case 4: r = generic_group_lf_rank<Idx, 4>(f, g, p, &sym); break;
      default: r = generic_group_lf_rank<Idx, 8>(f, g, p, &sym);
    }
    const Idx corr = (sym == f.last_chr && p < static_cast<Idx>(f.first_isa)) ? 1 : 0;
    return tab<Idx>(f.psum, sym) + r + corr - 1;
  }
};

template <class Layout>
struct LanesOf;
template <class Idx>
struct LanesOf<PlainLayout<Idx>> {
  using type = GroupLanes<Idx, WholeRows>;
};
template <class Idx>
struct LanesOf<ShardedPlainLayout<Idx>> {
  using type = GroupLanes<Idx, ShardedRows>;
};
template <>
struct LanesOf<MegaLayout> {
  using type = MegaLanes;
};
template <class Idx>
struct LanesOf<GenericLayout<Idx>> {
  using type = GenericLanes<Idx>;
};
template <class Layout>
using Lanes = typename LanesOf<Layout>::type;

// The LF walk of BackwardToSampledSA: from `row` to a first-ISA, sampled,
// selected or (where the index has no selected rows) end-marker row, then
// that row's value.  lf(p) is one LF step of the lane's group.
template <class Layout, class Lf>
__device__ __forceinline__ typename Layout::Idx lf_walk(const FMView& f, typename Layout::Idx row,
                                                        Lf lf) {
  using Idx = typename Layout::Idx;
  const Idx fi = static_cast<Idx>(f.first_isa);
  Idx cur = row;
  while (true) {
    if (cur == fi) return static_cast<Idx>(f.adjusted_sa0);
    if (cur % f.sample_rate == 0) return Layout::sampled_at(f, cur / f.sample_rate);
    if (f.n_sel) {
      const int32_t k = sel_find(f, cur);
      if (k >= 0) return tab<Idx>(f.sel_vals, k);
    } else if (cur < f.n_end) {
      return tab<Idx>(f.end_marker_sa, cur);
    }
    cur = lf(cur);
  }
}

// The rowmap entry of `row` (the index has a rowmap), row clamped to [0, n).
template <class Layout>
__device__ __forceinline__ typename Layout::Idx rowmap_value(const FMView& f,
                                                             typename Layout::Idx row) {
  using Idx = typename Layout::Idx;
  return Layout::rowmap_at(f, tmin(tmax(row, Idx(0)), static_cast<Idx>(f.n - 1)));
}

// The pw-mer that ends at position `end - 1` of a code sequence, read back to
// front: returns the length of the valid run ending there, capped at pw; the
// packed k-mer (code j of the window at bits code_bits * j) is complete when
// that is pw.  The key is 64 bits wide, so code_bits * pw may pass 31.
template <class Codes>
__device__ __forceinline__ int32_t start_kmer(const FMView& f, const Codes& codes,
                                              int32_t end, uint64_t* kmer) {
  int32_t tv = 0;
  uint64_t k = 0;
  while (tv < f.pw) {
    const int32_t c = codes.code(end - 1 - tv);
    if (c == 255) break;
    k |= static_cast<uint64_t>(c) << (f.code_bits * (f.pw - 1 - tv));
    ++tv;
  }
  *kmer = k;
  return tv;
}

// ftab lookup of a packed pw-mer, the key clipped to the table: (start, len),
// one 8-byte (int32) or 16-byte (int64) load of the interleaved pair.
template <class Idx>
__device__ __forceinline__ void ftab_entry(const FMView& f, uint64_t kmer, Idx* start, Idx* len) {
  const int64_t k = kmer < static_cast<uint64_t>(f.ftab_size) ? static_cast<int64_t>(kmer)
                                                              : f.ftab_size - 1;
  if constexpr (sizeof(Idx) == 8) {
    const longlong2 e = __ldg(reinterpret_cast<const longlong2*>(f.ftab) + k);
    *start = e.x;
    *len = e.y;
  } else {
    const int2 e = __ldg(reinterpret_cast<const int2*>(f.ftab) + k);
    *start = e.x;
    *len = e.y;
  }
}

// One chain hit (sp, ep, l, off) in the index type: the hits tensors are
// [B, H, 4] of Idx, 16 bytes a hit with int32 and 32 with int64.
template <class Idx>
struct Hit {
  Idx sp, ep;
  int32_t l, off;
};

template <class Idx>
__device__ __forceinline__ Hit<Idx> load_hit(const Idx* hits, int64_t i) {
  if constexpr (sizeof(Idx) == 8) {
    const longlong2* p = reinterpret_cast<const longlong2*>(hits) + 2 * i;
    const longlong2 a = p[0], b = p[1];
    return Hit<Idx>{a.x, a.y, static_cast<int32_t>(b.x), static_cast<int32_t>(b.y)};
  } else {
    const int4 e = reinterpret_cast<const int4*>(hits)[i];
    return Hit<Idx>{e.x, e.y, e.z, e.w};
  }
}

template <class Idx>
__device__ __forceinline__ void store_hit(Idx* hits, int64_t i, Idx sp, Idx ep, int32_t l,
                                          int32_t off) {
  if constexpr (sizeof(Idx) == 8) {
    longlong2* p = reinterpret_cast<longlong2*>(hits) + 2 * i;
    p[0] = make_longlong2(sp, ep);
    p[1] = make_longlong2(l, off);
  } else {
    reinterpret_cast<int4*>(hits)[i] = make_int4(sp, ep, l, off);
  }
}

// uint8 code lanes [B, L], 255 invalid.
struct CodeLanes {
  const uint8_t* codes;
  const int32_t* lengths;
  int L;
  struct Lane {
    const uint8_t* cd;
    int32_t len;
    __device__ __forceinline__ int32_t code(int32_t i) const {
      return (i < 0 || i >= len) ? 255 : cd[i];
    }
  };
  __device__ __forceinline__ Lane lane(int b) const {
    return Lane{codes + static_cast<int64_t>(b) * L, lengths[b]};
  }
};
