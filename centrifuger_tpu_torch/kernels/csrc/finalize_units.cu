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
// Bound: small and compute-light; the only large-table traffic is resolving
// at most W = 8 rows per unit (one rowmap load each, or an LF walk).
// Design: one warp per unit.  Lane 0 walks the unit's present hits in order
// (there are at most 4 * H, read straight from the chain output), writes the
// first W expanded rows to shared memory, lanes 0..W-1 resolve them in
// parallel, and lane 0 finishes the unit on the W rows in registers.  A
// template over the rank layout (the inline resolve's LF walk) and its index
// type: the hits' sp / ep, the expanded rows and the striding are int64 on an
// int64 index (kernel K9); the resolved sequence ids and the packed rows are
// int32, as in the JAX program.
#include "fm_device.cuh"

namespace {

constexpr int W = 8;               // per-unit row budget (U_CAP)
constexpr int WARPS = 4;           // units per block

struct Slots {
  int n;          // 2 single-end, 4 paired
  int lane[4];    // chain lane of each slot, -1 when the strand lost
  int k[4];       // strand record index: plus = 1, minus = 0
};

template <class Idx>
__device__ int32_t lane_score(const Idx* hits, const int32_t* nhits, int lane, int H, int mhl,
                              int adj) {
  int32_t s = 0;
  for (int m = 0; m < nhits[lane]; ++m) {
    const int32_t l = load_hit(hits, (int64_t)lane * H + m).l;
    if (l >= mhl) s += (l - adj) * (l - adj);
  }
  return s;
}

// The protein path's frame choice for one read and strand: of lanes lane0,
// +1, +2 the one with the largest nhits * score; the best starts at 0 and
// only a strictly larger value replaces it, so ties keep the earlier frame.
template <class Idx>
__device__ int chosen_frame(const Idx* hits, const int32_t* nhits, int lane0, int H, int mhl,
                            int adj) {
  int32_t best = 0;
  int tag = 0;
  for (int fr = 0; fr < 3; ++fr) {
    const int32_t sc = nhits[lane0 + fr] * lane_score(hits, nhits, lane0 + fr, H, mhl, adj);
    if (sc > best) {
      best = sc;
      tag = fr;
    }
  }
  return lane0 + tag;
}

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

template <class Layout>
__global__ void finalize_units_kernel(FMView f, const typename Layout::Idx* __restrict__ hits,
                                      const int32_t* __restrict__ nhits, int Q, int nr, int H,
                                      int mhl, int me, int k_out, int protein,
                                      int32_t* __restrict__ packed) {
  using Idx = typename Layout::Idx;
  const int adj = protein ? 5 : 15;   // _scoreHitLenAdjust
  __shared__ Idx s_rows[WARPS][W];
  __shared__ int32_t s_seq[WARPS][W];
  __shared__ int32_t s_nvalid[WARPS];
  const int wid = threadIdx.x >> 5, ln = threadIdx.x & 31;
  const int q = blockIdx.x * WARPS + wid;
  const bool live_unit = q < Q;

  Slots sl;
  bool adjust = false;
  int32_t total = 0;
  bool mix = false;
  // expanded rows (valid ones): hit index s, its k, l
  int32_t r_s[W], r_k[W], r_l[W];
  if (ln == 0 && live_unit) {
    int f1, r1, f2 = -1, r2 = -1;
    if (protein) {
      // lanes of a read: fwd frames 0..2, then rc frames 0..2
      const int base = 6 * nr * q;
      f1 = chosen_frame(hits, nhits, base, H, mhl, adj);
      r1 = chosen_frame(hits, nhits, base + 3, H, mhl, adj);
      if (nr == 2) {
        f2 = chosen_frame(hits, nhits, base + 6, H, mhl, adj);
        r2 = chosen_frame(hits, nhits, base + 9, H, mhl, adj);
      }
    } else {
      f1 = 2 * nr * q;
      r1 = f1 + 1;
      if (nr == 2) {
        f2 = f1 + 2;
        r2 = f1 + 3;
      }
      adjust = (nhits[f1] > 0 && nhits[r1] > 0) ||
               (nr == 2 && nhits[f2] > 0 && nhits[r2] > 0);
    }
    int32_t plus = lane_score(hits, nhits, f1, H, mhl, adj);
    int32_t minus = lane_score(hits, nhits, r1, H, mhl, adj);
    if (nr == 2) {
      plus += lane_score(hits, nhits, r2, H, mhl, adj);
      minus += lane_score(hits, nhits, f2, H, mhl, adj);
    }
    const bool tp = plus >= minus, tm = minus >= plus;
    if (nr == 2) {
      sl = Slots{4, {tp ? f1 : -1, tp ? r2 : -1, tm ? r1 : -1, tm ? f2 : -1}, {1, 1, 0, 0}};
    } else {
      sl = Slots{2, {tp ? f1 : -1, tm ? r1 : -1, -1, -1}, {1, 0, 0, 0}};
    }
    // pass 1 over present hits in slot-major order: row expansion + mix
    int prev_k = -1;
    for (int i = 0; i < sl.n; ++i) {
      if (sl.lane[i] < 0) continue;
      const int nh = nhits[sl.lane[i]];
      for (int m = 0; m < nh; ++m) {
        const Hit<Idx> e = load_hit(hits, (int64_t)sl.lane[i] * H + m);
        int32_t cnt;
        Idx step, cf;
        bool simple;
        hit_counts(e.sp, e.ep, me, &cnt, &step, &cf, &simple);
        if (prev_k >= 0 && prev_k != sl.k[i]) mix = true;
        prev_k = sl.k[i];
        for (int32_t j = total; j < min(total + cnt, W); ++j) {
          const Idx pos = j - total;
          s_rows[wid][j] = simple ? e.sp + pos
                           : (pos < cf ? e.sp + pos * step : e.ep - (pos - cf) * step);
          r_s[j] = i * H + m;
          r_k[j] = sl.k[i];
          r_l[j] = e.l;
        }
        total += cnt;
      }
    }
    s_nvalid[wid] = min(total, W);
  }
  __syncwarp();
  if (live_unit && ln < W)
    s_seq[wid][ln] = ln < s_nvalid[wid]
                         ? static_cast<int32_t>(resolve_one<Layout>(f, s_rows[wid][ln]))
                         : 0;
  __syncwarp();
  if (ln != 0 || !live_unit) return;

  const int nvalid = s_nvalid[wid];
  const int32_t* seq = s_seq[wid];
  // pass 2: merge-chain ids of the hits that own rows
  int32_t r_chain[W];
  {
    int32_t run = 0, chain = 0;
    bool have_prev = false, prev_uniq = false;
    int prev_k = 0;
    int32_t prev_end = 0, prev_sid = 0;
    for (int i = 0; i < sl.n; ++i) {
      if (sl.lane[i] < 0) continue;
      const int nh = nhits[sl.lane[i]];
      for (int m = 0; m < nh; ++m) {
        const Hit<Idx> e = load_hit(hits, (int64_t)sl.lane[i] * H + m);
        int32_t cnt;
        Idx step, cf;
        bool simple;
        hit_counts(e.sp, e.ep, me, &cnt, &step, &cf, &simple);
        const bool uniq = e.ep == e.sp;
        const int32_t sid = seq[min(run, W - 1)];
        const bool merge = have_prev && !mix && uniq && prev_uniq && sl.k[i] == prev_k &&
                           prev_end + 1 == e.off && sid == prev_sid;
        if (!merge) ++chain;
        for (int32_t j = run; j < min(run + cnt, W); ++j) r_chain[j] = chain;
        run += cnt;
        have_prev = true;
        prev_uniq = uniq;
        prev_k = sl.k[i];
        prev_end = e.off + e.l;
        prev_sid = sid;
      }
    }
  }
  // sort the valid rows by (k, sid, hit); equal keys are the same hit
  int32_t ka[W], kb[W], kc[W], kl[W], kch[W];
  for (int j = 0; j < nvalid; ++j) {
    int32_t a = r_k[j], b = seq[j], c = r_s[j], l = r_l[j], ch = r_chain[j];
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
  out[4] = (adjust ? 1 : 0) | (total > W ? 2 : 0);
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
