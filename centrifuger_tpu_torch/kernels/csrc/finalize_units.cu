// finalize_units: per-unit classification from the strand lanes' chains,
// kernel K3, with the expanded rows' SA resolve (K2) inline.
//
// Replaces the finalize part of centrifuger_tpu/classify/device_engine.py
// fused_classify (:206-461): strand scores sum (l - adj)^2 and strand choice
// (adj 15; on the protein path adj 5 and, before it, the choice of one of three
// frames per read and strand, with no boundary adjustment), the unit's hit
// table, row expansion with the k * hitk bidirectional
// striding, merge-chain ids, the (k, sid, hit) sort of the unit's rows,
// segmented chain / record sums, best / second / hitlen, deduplicated best
// seqids and the flags; one packed row [5 + k_out] per unit.
//
// Bound on this card: small and compute-light.  A unit reads its lanes'
// nhits and hits once (16 bytes a hit, 32 with int64) and resolves at most
// W = 8 rows (one rowmap load each, or an LF walk); the device time is the
// latency of the few dependent memory rounds a unit takes, not the bytes.
//
// Design: one warp a unit, WARPS units a block, the unit's chain lanes read
// by the whole warp.
//   staging     thread r < lpu (2 nr lanes, 6 nr on the protein path) loads
//               lane r's nhits; a warp scan gives each lane's first hit in
//               the lane-major list of the unit's hits, and the warp loads
//               that list 32 hits a round, one 16-byte hit (load_hit) a
//               thread, so no hit is read twice from global memory.  Each
//               lane's first W hits are kept in shared memory: no expanded
//               row comes from a later one.
//   scores      each round adds sum (l - adj)^2 of its hits with l >= mhl to
//               the lanes it covers, one warp reduction a lane; thread r
//               keeps lane r's score, and the strand (protein: frame, then
//               strand) choice reads them by shuffle, with the JAX program's
//               tie rules.
//   expansion   thread t takes the t-th present hit of the chosen slots in
//               slot-major order (t < W); a warp exclusive scan of the hits'
//               hit_counts gives each its first row, and it writes its rows
//               below W, with their (s, k, l), to shared memory.  The scan's
//               sum and the number of present hits give FLAG_ROW_OVERFLOW;
//               mixStrand is whether hits of both k are present.
//   resolve     with a rowmap, threads 0..W-1 load one entry each; without
//               one, the warp walks the rows one after another (lf_walk over
//               Lanes<Layout>::lf: one memory round an LF step on the plain
//               layouts, two on the run-block and generic ones).
//   merge ids   each hit thread reads the previous hit's fields by shuffle;
//               a ballot of the hits that start a chain gives each its id.
//   lane 0      the (k, sid, hit) sort of the <= W rows, the record sums,
//               best / second / hitlen, the best-seqid dedup and the packed
//               row, in registers.
// Every *_sync call is made by all 32 threads: the choices they depend on
// are the same in every thread.  A template over the rank layout (the inline
// resolve) and its index type: the hits' sp / ep, the expanded rows and the
// striding are int64 on an int64 index (kernel K9); the resolved sequence
// ids and the packed rows are int32, as in the JAX program.
#include "fm_device.cuh"

namespace {

constexpr int W = 8;               // per-unit row budget (U_CAP)
constexpr int WARPS = 4;           // units per block
constexpr int LPU_MAX = 12;        // chain lanes a unit: 2 nr, or 6 nr on the protein path

// striding of one hit: rows to resolve (at most me + 1 where it strides)
// and the forward-pass count
template <class Idx>
__device__ __forceinline__ void hit_counts(Idx sp, Idx ep, int32_t me, int32_t* cnt, Idx* step,
                                           Idx* cf, bool* simple) {
  const Idx rng = ep - sp + 1;
  *simple = rng <= me;
  *step = tmax((rng + me - 1) / me, Idx(1));
  *cf = (rng + *step - 1) / *step;
  const Idx cb = tmin((ep - sp) / *step + 1, tmax(Idx(1), me - *cf));
  *cnt = static_cast<int32_t>(*simple ? rng : *cf + cb);
}

__device__ __forceinline__ int32_t warp_inclusive_sum(int32_t v, int t) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t u = __shfl_up_sync(WARP_ALL, v, d);
    if (t >= d) v += u;
  }
  return v;
}

// One unit's shared memory.
template <class Idx>
struct UnitTile {
  Hit<Idx> hit[LPU_MAX][W];   // the first W hits of each chain lane
  Idx rows[W];                // the expanded rows
  int32_t seq[W];             // their sequence ids; 0 from nvalid on
  int32_t s[W], k[W], l[W];   // each row's hit (slot * H + m), its k and l
  int32_t chain[W];           // each row's merge-chain id
};

template <class Layout>
__global__ void __launch_bounds__(WARPS * 32)
    finalize_units_kernel(FMView f, const typename Layout::Idx* __restrict__ hits,
                          const int32_t* __restrict__ nhits, int Q, int nr, int H, int mhl,
                          int me, int k_out, int protein, int32_t* __restrict__ packed) {
  using Idx = typename Layout::Idx;
  const int adj = protein ? 5 : 15;   // _scoreHitLenAdjust
  __shared__ UnitTile<Idx> tiles[WARPS];
  const int wid = threadIdx.x >> 5, ln = threadIdx.x & 31;
  const int q = blockIdx.x * WARPS + wid;
  if (q >= Q) return;   // the whole warp
  UnitTile<Idx>& u = tiles[wid];
  const int lpu = (protein ? 6 : 2) * nr;
  const int64_t lane0 = static_cast<int64_t>(lpu) * q;

  // ---- staging and lane scores
  const int32_t my_nh = ln < lpu ? nhits[lane0 + ln] : 0;
  const int32_t cum = warp_inclusive_sum(my_nh, ln);   // hits of lanes 0..ln
  int32_t cum_of[LPU_MAX];
#pragma unroll
  for (int r = 0; r < LPU_MAX; ++r) cum_of[r] = __shfl_sync(WARP_ALL, cum, r);
  const int32_t C = __shfl_sync(WARP_ALL, cum, 31);
  int32_t my_score = 0;   // thread r < lpu: lane r's score
  for (int32_t c0 = 0; c0 < C; c0 += 32) {
    const int32_t i = c0 + ln;   // this thread's hit in the unit's lane-major list
    int r = 0;
    int32_t first = 0;
#pragma unroll
    for (int k = 0; k < LPU_MAX; ++k)
      if (cum_of[k] <= i) {
        r = k + 1;
        first = cum_of[k];
      }
    int32_t sq = 0;
    if (i < C) {
      const int32_t m = i - first;
      const Hit<Idx> e = load_hit(hits, (lane0 + r) * H + m);
      if (e.l >= mhl) sq = (e.l - adj) * (e.l - adj);
      if (m < W) u.hit[r][m] = e;
    }
    const int r_lo = __shfl_sync(WARP_ALL, r, 0);
    const int r_hi = __shfl_sync(WARP_ALL, r, min(31, C - 1 - c0));
    for (int k = r_lo; k <= r_hi; ++k) {
      const int32_t s = __reduce_add_sync(WARP_ALL, r == k ? sq : 0);
      if (ln == k) my_score += s;
    }
  }

  // ---- strand choice (protein: the frame of each read and strand first)
  int f1, r1, f2 = -1, r2 = -1;
  bool adjust = false;
  if (protein) {
    // of lanes g0, +1, +2 the one with the largest nhits * score; the best
    // starts at 0 and only a strictly larger value replaces it, so ties keep
    // the earlier frame
    const int32_t my_q = my_nh * my_score;
    const auto chosen = [&](int g0) {
      int32_t best = 0;
      int tag = 0;
      for (int fr = 0; fr < 3; ++fr) {
        const int32_t v = __shfl_sync(WARP_ALL, my_q, g0 + fr);
        if (v > best) {
          best = v;
          tag = fr;
        }
      }
      return g0 + tag;
    };
    f1 = chosen(0);
    r1 = chosen(3);
    if (nr == 2) {
      f2 = chosen(6);
      r2 = chosen(9);
    }
  } else {
    f1 = 0;
    r1 = 1;
    if (nr == 2) {
      f2 = 2;
      r2 = 3;
    }
    bool hit_in[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) hit_in[r] = __shfl_sync(WARP_ALL, my_nh, r) > 0;
    adjust = (hit_in[0] && hit_in[1]) || (nr == 2 && hit_in[2] && hit_in[3]);
  }
  int32_t plus = __shfl_sync(WARP_ALL, my_score, f1);
  int32_t minus = __shfl_sync(WARP_ALL, my_score, r1);
  if (nr == 2) {
    plus += __shfl_sync(WARP_ALL, my_score, r2);
    minus += __shfl_sync(WARP_ALL, my_score, f2);
  }
  const bool tp = plus >= minus, tm = minus >= plus;
  // slots in the host finalizer's order: plus lanes (f1, r2), then minus
  // lanes (r1, f2); k = 1 1 0 0 (single-end: f1, r1; k = 1 0)
  const int slot_lane[4] = {tp ? f1 : -1, nr == 2 ? (tp ? r2 : -1) : (tm ? r1 : -1),
                            nr == 2 && tm ? r1 : -1, nr == 2 && tm ? f2 : -1};
  const int slot_k[4] = {1, nr == 2 ? 1 : 0, 0, 0};
  int32_t slot_n[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int32_t n = __shfl_sync(WARP_ALL, my_nh, max(slot_lane[s], 0));
    slot_n[s] = slot_lane[s] < 0 ? 0 : n;
  }

  // ---- row expansion: thread ln takes the ln-th present hit, slot-major
  int32_t P = 0, m = 0;
  int my_slot = 0, my_lane = 0, k = 0;
  bool any_k1 = false, any_k0 = false;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if (ln >= P && ln < P + slot_n[s]) {
      my_slot = s;
      my_lane = slot_lane[s];
      k = slot_k[s];
      m = ln - P;
    }
    P += slot_n[s];
    any_k1 |= slot_n[s] > 0 && slot_k[s] == 1;
    any_k0 |= slot_n[s] > 0 && slot_k[s] == 0;
  }
  // mixStrand: two consecutive present hits differ in k; k falls along the
  // slots, so that is hits of both k being present
  const bool mix = any_k1 && any_k0;
  const bool own = ln < min(P, W);
  __syncwarp();   // the staged hits
  Hit<Idx> e{0, 0, 0, 0};
  int32_t cnt = 0;
  Idx step = 1, cf = 0;
  bool simple = true;
  if (own) {
    e = u.hit[my_lane][m];
    hit_counts(e.sp, e.ep, me, &cnt, &step, &cf, &simple);
  }
  const int32_t incl = warp_inclusive_sum(cnt, ln);
  const int32_t first_row = incl - cnt;
  // the first W present hits hold every row below W, and a unit with more
  // than W present hits (one row or more each) passes W
  const int32_t total = __shfl_sync(WARP_ALL, incl, 31);
  const bool overflow = P > W || total > W;
  const int nvalid = min(total, W);
  const int32_t row_end = own ? min(incl, W) : 0;
  for (int32_t j = first_row; j < row_end; ++j) {
    const Idx pos = j - first_row;
    u.rows[j] = simple ? e.sp + pos : (pos < cf ? e.sp + pos * step : e.ep - (pos - cf) * step);
    u.s[j] = my_slot * H + m;
    u.k[j] = k;
    u.l[j] = e.l;
  }
  __syncwarp();

  // ---- resolve the rows
  if (Layout::has_rowmap(f)) {
    if (ln < W)
      u.seq[ln] = ln < nvalid ? static_cast<int32_t>(rowmap_value<Layout>(f, u.rows[ln])) : 0;
  } else {
    const typename Lanes<Layout>::Group g = Lanes<Layout>::Group::here();
    for (int j = 0; j < nvalid; ++j) {
      const Idx v = lf_walk<Layout>(f, u.rows[j],
                                    [&](Idx p) { return Lanes<Layout>::lf(f, g, p); });
      if (ln == 0) u.seq[j] = static_cast<int32_t>(v);
    }
    if (ln >= nvalid && ln < W) u.seq[ln] = 0;
  }
  __syncwarp();

  // ---- merge-chain ids of the hits that own rows
  {
    const int32_t sid = u.seq[min(first_row, W - 1)];
    const int uniq = own && e.ep == e.sp;
    const int32_t end = e.off + e.l;
    const int p_uniq = __shfl_up_sync(WARP_ALL, uniq, 1);
    const int p_k = __shfl_up_sync(WARP_ALL, k, 1);
    const int32_t p_end = __shfl_up_sync(WARP_ALL, end, 1);
    const int32_t p_sid = __shfl_up_sync(WARP_ALL, sid, 1);
    const bool merge = own && ln > 0 && !mix && uniq && p_uniq && k == p_k &&
                       p_end + 1 == e.off && sid == p_sid;
    const unsigned heads = __ballot_sync(WARP_ALL, own && !merge);
    const int32_t chain = __popc(heads & (WARP_ALL >> (31 - ln)));
    for (int32_t j = first_row; j < row_end; ++j) u.chain[j] = chain;
  }
  __syncwarp();
  if (ln != 0) return;

  const int32_t* seq = u.seq;
  // sort the valid rows by (k, sid, hit); equal keys are the same hit
  int32_t ka[W], kb[W], kc[W], kl[W], kch[W];
  for (int j = 0; j < nvalid; ++j) {
    int32_t a = u.k[j], b = seq[j], c = u.s[j], l = u.l[j], ch = u.chain[j];
    int t = j;
    while (t > 0 && (ka[t - 1] > a || (ka[t - 1] == a && (kb[t - 1] > b ||
                                       (kb[t - 1] == b && kc[t - 1] > c))))) {
      ka[t] = ka[t - 1]; kb[t] = kb[t - 1]; kc[t] = kc[t - 1];
      kl[t] = kl[t - 1]; kch[t] = kch[t - 1];
      --t;
    }
    ka[t] = a; kb[t] = b; kc[t] = c; kl[t] = l; kch[t] = ch;
  }
  // segmented sums: chains within records within the sorted rows
  int32_t best = -1, nbest = 0, hitlen = 0, rest = 0;
  int32_t rec_sid[W], rec_k[W], rec_score[W];
  int nrec = 0;
  int32_t chain_lsum = 0, rec_sum = 0, rec_len = 0;
  for (int j = 0; j < nvalid; ++j) {
    const bool rb = j == 0 || ka[j] != ka[j - 1] || kb[j] != kb[j - 1];
    const bool cb = rb || kch[j] != kch[j - 1];
    const bool pair_first = rb || kc[j] != kc[j - 1];
    const int32_t wl = pair_first ? kl[j] : 0;
    if (cb) chain_lsum = 0;
    if (rb) { rec_sum = 0; rec_len = 0; }
    chain_lsum += wl;
    rec_len += wl;
    const bool last = j == nvalid - 1;
    const bool next_rb = !last && (ka[j + 1] != ka[j] || kb[j + 1] != kb[j]);
    const bool next_cb = !last && (next_rb || kch[j + 1] != kch[j]);
    if ((last || next_cb) && chain_lsum >= mhl)
      rec_sum += (chain_lsum - adj) * (chain_lsum - adj);
    if (last || next_rb) {
      rec_sid[nrec] = kb[j];
      rec_k[nrec] = ka[j];
      rec_score[nrec] = rec_sum;
      if (rec_sum > best) {
        if (best > rest) rest = best;
        best = rec_sum;
        nbest = 1;
        hitlen = rec_len;
      } else if (rec_sum == best) {
        ++nbest;
      } else if (rec_sum > rest) {
        rest = rec_sum;
      }
      ++nrec;
    }
  }
  // best seqids: one per sid (its smallest k), ordered by (k, sid)
  int32_t ek[W], es[W];
  int ne = 0;
  for (int r = 0; r < nrec; ++r) {
    if (rec_score[r] != best) continue;
    int32_t kmin = rec_k[r];
    bool first = true;
    for (int o = 0; o < nrec; ++o) {
      if (rec_score[o] != best || rec_sid[o] != rec_sid[r]) continue;
      if (o < r && rec_k[o] <= rec_k[r]) first = false;
      if (o > r && rec_k[o] < rec_k[r]) first = false;
      kmin = min(kmin, rec_k[o]);
    }
    if (!first) continue;
    int t = ne++;
    while (t > 0 && (ek[t - 1] > kmin || (ek[t - 1] == kmin && es[t - 1] > rec_sid[r]))) {
      ek[t] = ek[t - 1]; es[t] = es[t - 1];
      --t;
    }
    ek[t] = kmin;
    es[t] = rec_sid[r];
  }
  const int32_t score = max(best, 0);
  int32_t* out = packed + (int64_t)q * (5 + k_out);
  out[0] = score;
  out[1] = nbest >= 2 ? score : rest;
  out[2] = hitlen;
  out[3] = ne;
  out[4] = (adjust ? 1 : 0) | (overflow ? 2 : 0);
  for (int j = 0; j < k_out; ++j) out[5 + j] = j < ne && j < W ? es[j] : 0;
}

}  // namespace

extern "C" int finalize_units_launch(const FMView* f, const void* hits,
                                     const int32_t* nhits, int Q, int nr, int H, int mhl,
                                     int me, int k_out, int protein, int32_t* packed,
                                     cudaStream_t stream) {
  const int blocks = (Q + WARPS - 1) / WARPS;
  CFR_DISPATCH_LAYOUT(f, finalize_units_kernel<Layout><<<blocks, WARPS * 32, 0, stream>>>(
      *f, static_cast<const typename Layout::Idx*>(hits), nhits, Q, nr, H, mhl, me, k_out,
      protein, packed));
  return static_cast<int>(cudaGetLastError());
}
