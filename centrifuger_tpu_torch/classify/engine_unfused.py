"""The non-fused classification engine on the card (PyTorch).

Port of centrifuger_tpu.classify.engine_jax.ClassifierJax (`--engine jax`):
  1. every read contributes forward + reverse-complement strand lanes (and the
     mate's), all packed into one [B, L] uint8 batch (vectorized encoding);
  2. one device chain search computes every semi-maximal hit chain
     (chain_search_lanes: K1, or K6 on a wide ftab, over the index's rank
     layout; K7 for protein's six translated frames a read);
  3. reads whose strands both hit (candidates for the reference's hit-boundary
     adjustment, Classifier.hpp:291-389) take the exact path; the rest take
     the vectorized host finalizer (classify/finalize.py) with one batched
     device SA resolve (resolve_rows, K2) for all SA-range rows.  The exact
     path's backward searches and SA resolves are batched on the device too
     (prefix_search, K5, and resolve_rows), as the fused engine does for its
     flagged units; ClassifierJax runs them on the host, one unit at a time.

It has no read-length cap and takes -k 0 and --hitk-factor 0: the fused
engine (classify/engine.py) hands it the batches its program cannot take.
The JAX engine pads batches to power-of-two shape buckets for its compile
cache; nothing here is compiled per shape, so there is no padding.  L keeps
its rounding: it sets the hit capacity H = L // (mhl + 1) + 1, which the
results depend on.

Bit-identical to ClassifierNP and to the reference binary; enforced by the
golden TSV tests.
"""

import threading
from collections import deque

import numpy as np
import torch

from .engine_np import ClassifierNP, ClassifierResult, BWTHit
from .finalize import finalize_units, finalize_prepare
from .translate import translate_frames
from ..fm.device import TorchFM, chain_search_lanes, prefix_search, resolve_rows
from ..spans import span
from ..utils import COMP_TABLE


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def _adjust_candidates(fwd, rc, length):
    """Overapproximate the (which, m) backward searches adjust_hit_boundary
    (Classifier.hpp:291-389) may issue for one read: every (fwd hit, rc hit)
    pair contributes its two candidate prefix lengths, gated only on the
    extension conditions evaluated on the ORIGINAL hit lists.  Rare cascaded
    re-searches miss the cache and fall back to the host search.  Hits are
    (sp, ep, l, off) tuples."""
    out = set()
    for hf in fwd:
        right = length - hf[3] - 1
        left = right - hf[2] + 1
        for hr in rc:
            rc_left = hr[3]
            rc_right = rc_left + hr[2] - 1
            if rc_right > right:
                out.add((0, rc_right + 1))
            if left < rc_left:
                out.add((1, length - left))
    return out


class ClassifierTorchUnfused(ClassifierNP):
    def __init__(self, fm, taxonomy, param, protein=False, dev=None,
                 device="cuda", serve_layout="plain", force_idtype=None):
        super().__init__(fm, taxonomy, param, protein=protein)
        if dev is None:
            with span("load.device_index"):
                dev = TorchFM.from_index(fm, device, serve_layout, force_idtype)
        self.dev = dev
        self.device = self.dev.device
        self.stats = {"fast_units": 0, "slow_units": 0}
        self._stats_lock = threading.Lock()

    def _add_stats(self, seconds=None, names=(), **counts):
        """Add counts, and each stage of `names` ("<name>_s" += seconds[name]),
        to stats under one lock: the fused engine's finish workers add theirs
        from several threads."""
        with self._stats_lock:
            st = self.stats
            for name in names:
                st[name + "_s"] += seconds[name]
            for k, v in counts.items():
                st[k] += v

    # ------------------------------------------------------------- primitives

    def _upload(self, a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _encode_reads(self, raws, floor=32, unit=64):
        """raws (uint8 arrays or bytes) -> (codes [R, L] uint8: row i read i
        encoded, 255 past its end; lens [R] int32; ridx, cidx: each base's
        row and column).  L is the longest read, at least `floor`, rounded up
        to a multiple of `unit`."""
        lens = np.fromiter((len(r) for r in raws), np.int32, len(raws))
        L = _round_up(max(int(lens.max(initial=1)), floor), unit)
        flat = np.concatenate([np.frombuffer(bytes(r), np.uint8) if not
                               isinstance(r, np.ndarray) else r
                               for r in raws]) if len(raws) else \
            np.zeros(0, np.uint8)
        codes = np.full((len(raws), L), 255, np.uint8)
        starts = np.zeros(len(raws) + 1, np.int64)
        np.cumsum(lens, out=starts[1:])
        ridx = np.repeat(np.arange(len(raws)), lens)
        cidx = np.arange(len(flat)) - starts[ridx]
        codes[ridx, cidx] = self.encode[flat]
        return codes, lens, ridx, cidx

    def _encode_lanes(self, raws):
        """Vectorized encode of reads + their revcomps.
        raws: list of uint8 arrays. Returns (codes [2R, L], lengths [2R]):
        lane 2i = forward, lane 2i+1 = revcomp."""
        fwd, lens, ridx, cidx = self._encode_reads(raws)
        # revcomp lanes: complement codes = 3 - code (A<->T, C<->G), reversed
        rc = np.full(fwd.shape, 255, np.uint8)
        rc_codes = np.where(fwd[ridx, cidx] == 255, 255, 3 - fwd[ridx, cidx])
        rc[ridx, lens[ridx] - 1 - cidx] = rc_codes
        codes = np.empty((2 * len(raws), fwd.shape[1]), np.uint8)
        codes[0::2] = fwd
        codes[1::2] = rc
        return codes, np.repeat(lens, 2).astype(np.int32)

    def _pack_reads_protein(self, queries):
        """queries -> (amino-acid code lanes [U * 6, L] uint8 with 255 invalid,
        lane lengths [U * 6] int32, nr, L), U = len(queries) * nr
        (engine_fused._pack_reads_protein).  Per read the lanes are the fwd
        frames 0..2, then the frames 0..2 of the reverse complement
        (TranslatedSearch, Classifier.hpp:451-493); an empty or missing mate
        has six empty lanes.  No padding of the unit count; L rounds to 32."""
        nr = 2 if any(q[1] is not None for q in queries) else 1
        aas = []
        for q in queries:
            for raw in q[:nr]:
                raw = np.zeros(0, np.uint8) if raw is None else raw
                for strand in (raw, COMP_TABLE[raw][::-1]):
                    aas.extend(translate_frames(strand))
        codes, lengths, _, _ = self._encode_reads(aas, floor=16, unit=32)
        return codes, lengths, nr, codes.shape[1]

    def _chain_search_dispatch(self, codes, lengths):
        """Launch the chain search on a [B, L] batch; returns the device
        (hits [B, H, 4], nhits [B]) without waiting for them."""
        L = codes.shape[1]
        mhl = self.param.min_hit_len
        H = max(L // (mhl + 1) + 1, 1)
        return chain_search_lanes(self.dev, self._upload(codes), self._upload(lengths),
                                  mhl, H)

    @staticmethod
    def _pull_hits(out):
        """(sp, ep, l, off, nhits) numpy arrays of a dispatched chain search."""
        hits, nh = out
        h = hits.cpu().numpy()
        return h[:, :, 0], h[:, :, 1], h[:, :, 2], h[:, :, 3], nh.cpu().numpy()

    @staticmethod
    def _lane_hits(sp, ep, hl, off, nh):
        """hits_at(lane) -> [(sp, ep, l, off), ...] over _pull_hits' arrays."""
        def hits_at(lane):
            return [(int(sp[lane, m]), int(ep[lane, m]), int(hl[lane, m]),
                     int(off[lane, m])) for m in range(int(nh[lane]))]
        return hits_at

    def _resolve_dispatch(self, rows):
        """Launch the SA resolve for a flat row array; returns the device
        result, or None for an empty row set."""
        if len(rows) == 0:
            return None
        rows = np.asarray(rows, np.int64 if self.dev.idtype == torch.int64 else np.int32)
        return resolve_rows(self.dev, self._upload(rows), self._upload(np.ones(len(rows), bool)))

    def _resolve_batch_rows(self, rows):
        """One device SA resolve for a flat row array (blocking)."""
        h = self._resolve_dispatch(rows)
        if h is None:
            return np.zeros(0, np.int64)
        return h.cpu().numpy().astype(np.int64)

    # ------------------------------------------------------------ main entry

    def query_batch(self, queries):
        if self.protein:
            return self._query_batch_protein(queries)
        return self._stage_finalize(self._stage_prep(self._stage_dispatch(queries)))

    def query_pipelined(self, batches):
        """Yields one result list per batch, equal to query_batch's, in order
        (engine_jax.ClassifierJax.query_pipelined): up to two chain searches
        in flight on the device while the host runs strand selection and
        finalize prep of the batches before them."""
        qa, qb = deque(), deque()
        for batch in batches:
            if self.protein:
                yield self._query_batch_protein(batch)
                continue
            qa.append(self._stage_dispatch(batch))
            if len(qa) >= 2:
                qb.append(self._stage_prep(qa.popleft()))
            if len(qb) >= 2:
                yield self._stage_finalize(qb.popleft())
        while qa:
            qb.append(self._stage_prep(qa.popleft()))
            if len(qb) >= 2:
                yield self._stage_finalize(qb.popleft())
        while qb:
            yield self._stage_finalize(qb.popleft())

    def _stage_dispatch(self, queries):
        """Stage A: encode strand lanes + chain-search launch."""
        Q = len(queries)
        # strand lanes: [r1 fwd, r1 rc] per query, then [r2 fwd, r2 rc] for
        # paired queries, all in ONE chain-search batch
        raws1 = [q[0] for q in queries]
        raws2 = [q[1] for q in queries if q[1] is not None]
        has_r2 = np.array([q[1] is not None for q in queries], bool)
        codes, lengths = self._encode_lanes(raws1 + raws2)
        return dict(queries=queries, Q=Q, has_r2=has_r2,
                    out=self._chain_search_dispatch(codes, lengths))

    def _stage_prep(self, ctx):
        """Stage B: pull the chains, strand selection, finalize prep, SA
        resolve launch."""
        queries, Q, has_r2 = ctx["queries"], ctx["Q"], ctx["has_r2"]
        hsp, hep, hlv, hoff, nh = self._pull_hits(ctx["out"])
        H = hsp.shape[1]

        r2_lane0 = np.full(Q, -1, np.int64)  # lane index of r2-fwd per query
        r2_lane0[has_r2] = 2 * Q + 2 * np.arange(int(has_r2.sum()))

        # vectorized strand scores per lane
        mask = np.arange(H)[None, :] < nh[:, None]
        mhl = self.param.min_hit_len
        adjv = self.score_adjust
        lane_score = np.where(mask & (hlv >= mhl),
                              (hlv.astype(np.int64) - adjv) ** 2, 0).sum(axis=1)

        lane_f1 = 2 * np.arange(Q)
        lane_r1 = lane_f1 + 1
        lane_f2 = r2_lane0
        lane_r2 = np.where(r2_lane0 >= 0, r2_lane0 + 1, -1)

        def safe(arr, lanes):
            return np.where(lanes >= 0, arr[np.maximum(lanes, 0)], 0)

        sc_plus = lane_score[lane_f1] + safe(lane_score, lane_r2)
        sc_minus = lane_score[lane_r1] + safe(lane_score, lane_f2)

        needs_adjust = (nh[lane_f1] > 0) & (nh[lane_r1] > 0)
        needs_adjust |= np.where(has_r2,
                                 (safe(nh, lane_f2) > 0) & (safe(nh, lane_r2) > 0),
                                 False)

        # per-unit lane sequence [Q, 4]: plus lanes (fwd r1, rc r2) then
        # minus lanes (rc r1, fwd r2); both on tie (Classifier.hpp:542-562)
        take_plus = sc_plus >= sc_minus
        take_minus = sc_minus >= sc_plus
        seq_lane = np.full((Q, 4), -1, np.int64)
        seq_lane[:, 0] = np.where(take_plus, lane_f1, -1)
        seq_lane[:, 1] = np.where(take_plus, lane_r2, -1)
        seq_lane[:, 2] = np.where(take_minus, lane_r1, -1)
        seq_lane[:, 3] = np.where(take_minus, lane_f2, -1)
        seq_lane[needs_adjust] = -1  # adjustment candidates -> exact path
        seq_strand = np.broadcast_to(np.array([1, 1, -1, -1]), (Q, 4))

        flat_lane = seq_lane.reshape(-1)
        valid_slot = flat_lane >= 0
        slot_unit = np.repeat(np.arange(Q), 4)[valid_slot]
        slot_lane = flat_lane[valid_slot]
        slot_strand = seq_strand.reshape(-1)[valid_slot]

        counts = nh[slot_lane]
        hit_slot = np.repeat(np.arange(len(slot_lane)), counts)
        pos = np.arange(int(counts.sum())) - np.repeat(
            np.cumsum(counts) - counts, counts)
        lanes_r = slot_lane[hit_slot]
        flat = dict(
            uid=slot_unit[hit_slot],
            sp=hsp[lanes_r, pos].astype(np.int64),
            ep=hep[lanes_r, pos].astype(np.int64),
            l=hlv[lanes_r, pos].astype(np.int64),
            off=hoff[lanes_r, pos].astype(np.int64),
            strand=slot_strand[hit_slot].astype(np.int64),
        )
        qlens = [len(r1) + (len(r2) if r2 is not None else 0)
                 for r1, r2 in queries]
        rows, cont = finalize_prepare(self, Q, flat, qlens)
        return dict(queries=queries, Q=Q, cont=cont, rows_n=len(rows),
                    handle=self._resolve_dispatch(rows),
                    needs_adjust=needs_adjust, hits=(hsp, hep, hlv, hoff, nh),
                    lanes=np.stack([lane_f1, lane_r1, lane_f2, lane_r2], axis=1))

    def _stage_finalize(self, ctx):
        """Stage C: pull the resolved seqids, finish per-read records, exact
        path for the rare adjustment candidates."""
        queries, Q = ctx["queries"], ctx["Q"]
        handle = ctx["handle"]
        if handle is None:
            seqids = np.zeros(0, np.int64)
        else:
            seqids = handle.cpu().numpy()[:ctx["rows_n"]].astype(np.int64)
        results = ctx["cont"](seqids)

        # the exact path for the rare adjustment candidates: ClassifierJax
        # runs each unit's backward searches and SA resolves on the host; here
        # they go to the device as one prefix_search and one resolve_rows
        # dispatch, as the fused engine's flagged units do (reads of 10^4 bp
        # make the host searches minutes long)
        adj_idx = np.flatnonzero(ctx["needs_adjust"])
        self._add_stats(fast_units=int(Q - len(adj_idx)), slow_units=int(len(adj_idx)))
        if len(adj_idx):
            # v = 4 qi + j: lane j (f1, rc1, f2, rc2) of unit qi
            lane_hits, lanes = self._lane_hits(*ctx["hits"]), ctx["lanes"]
            exact = self._classify_units_batch(self._fallback_unit_hits_dna(
                queries, adj_idx, lambda v: lane_hits(lanes[v // 4, v % 4]), 2))
            for qi, res in exact.items():
                results[qi] = res
        return results

    def _query_batch_protein(self, queries):
        """Batched translated search: the six frame lanes of every mate
        (_pack_reads_protein) in one chain search, the frame and strand
        choice (_translated_choice) on the host, vectorized finalize."""
        if not queries:
            return []
        codes, lengths, nr, _ = self._pack_reads_protein(queries)
        hits_at = self._lane_hits(*self._pull_hits(self._chain_search_dispatch(codes, lengths)))
        units = []
        for qi, (r1, r2) in enumerate(queries):
            chosen = self._translated_choice(hits_at, 6 * nr * qi, r2 is not None and nr == 2)
            h = np.array([h for h, _ in chosen], np.int64).reshape(-1, 4)
            hd = dict(sp=h[:, 0], ep=h[:, 1], l=h[:, 2], off=h[:, 3],
                      strand=np.array([s for _, s in chosen], np.int64))
            ql = len(r1) + (len(r2) if r2 is not None else 0)
            units.append(dict(hits=hd, query_length=ql))
        return finalize_units(self, units, self._resolve_batch_rows)

    def _translated_choice(self, hits_at, lane0, mate2):
        """TranslatedSearch's frame and strand choice for one unit
        (Classifier.hpp:451-493) -> [(hit, strand), ...].  hits_at(lane) gives
        a lane's chain; lanes lane0 + 0..5 are read 1's forward and reverse
        complement frames, + 6..11 (where mate2) read 2's.  A strand keeps
        its frame of most count x score, the earlier on a tie; read 2's
        reverse-complement frames join plus, its forward frames minus.  The
        higher-scoring strand wins, both on a tie, plus first."""
        def best_frame(l0):
            frames = [hits_at(l0 + f) for f in range(3)]
            scores = [len(fh) * sum(self.hit_score(h[2]) for h in fh) for fh in frames]
            return frames[scores.index(max(scores))]

        plus, minus = best_frame(lane0), best_frame(lane0 + 3)
        if mate2:
            plus = plus + best_frame(lane0 + 9)
            minus = minus + best_frame(lane0 + 6)
        sc_p = sum(self.hit_score(h[2]) for h in plus)
        sc_m = sum(self.hit_score(h[2]) for h in minus)
        return ([(h, 1) for h in plus] if sc_p >= sc_m else []) + \
            ([(h, -1) for h in minus] if sc_m >= sc_p else [])

    def _adjusted_unit_hits(self, r1, r2, c1f, c1r, c2f, c2r, f1, rc1, f2, rc2,
                            search1=None, search2=None):
        """SearchForwardAndReverse tail for one unit, reusing the device
        chains: boundary adjustment + strand selection.  Returns the chosen
        hits list (Classifier.hpp:291-389, 554-562).  search1/search2
        optionally serve the adjustment's backward searches from a batched
        device dispatch (the fused engine's flagged units)."""
        strand_hits = [[BWTHit(*h, 0) for h in rc1], [BWTHit(*h, 0) for h in f1]]
        self.adjust_hit_boundary(c1f[:len(r1)], c1r[:len(r1)], len(r1),
                                 strand_hits, search=search1)
        if r2 is not None:
            r2_strand = [[BWTHit(*h, 0) for h in rc2], [BWTHit(*h, 0) for h in f2]]
            self.adjust_hit_boundary(c2f[:len(r2)], c2r[:len(r2)], len(r2),
                                     r2_strand, search=search2)
            for k in range(2):
                strand_hits[k].extend(r2_strand[1 - k])
        strand_score = [0, 0]
        for k in range(2):
            for h in strand_hits[k]:
                h.strand = 2 * k - 1
            strand_score[k] = self.hits_score(strand_hits[k])
        if strand_score[1] > strand_score[0]:
            return strand_hits[1]
        if strand_score[0] > strand_score[1]:
            return strand_hits[0]
        return strand_hits[1] + strand_hits[0]

    # ------------------------------------- batched exact path (device searches)

    def _batched_prefix_search(self, lane_codes, lane_ms):
        """ONE device dispatch of longest-suffix backward searches (K5);
        returns [(l, sp, ep), ...] aligned with the inputs."""
        n = len(lane_codes)
        if n == 0:
            return []
        codes = np.full((n, max(len(c) for c in lane_codes)), 255, np.uint8)
        for i, c in enumerate(lane_codes):
            codes[i, :len(c)] = c
        ms = np.asarray(lane_ms, np.int32)
        l, sp, ep = prefix_search(self.dev, self._upload(codes), self._upload(ms))
        lse = torch.stack([l, sp, ep]).cpu().numpy()
        return [(int(lse[0, i]), int(lse[1, i]), int(lse[2, i])) for i in range(n)]

    def _fallback_unit_hits_dna(self, queries, fb_idx, hits_at, nr):
        """Flagged units: batched boundary adjustment + strand choice.
        Returns [(qi, hits, qlen), ...]."""
        units = []
        lane_codes, lane_ms, lane_key = [], [], []
        for qi in fb_idx:
            qi = int(qi)
            r1, r2 = queries[qi]
            base = 2 * nr * qi
            f1, rc1 = hits_at(base), hits_at(base + 1)
            c1f = self.encode[r1]
            c1r = self.encode[COMP_TABLE[r1][::-1]]
            if r2 is not None and nr == 2:
                f2, rc2 = hits_at(base + 2), hits_at(base + 3)
                c2f = self.encode[r2]
                c2r = self.encode[COMP_TABLE[r2][::-1]]
            else:
                r2 = None
                f2 = rc2 = c2f = c2r = None
            ui = len(units)
            units.append(dict(qi=qi, r1=r1, r2=r2, c=(c1f, c1r, c2f, c2r),
                              h=(f1, rc1, f2, rc2), caches=({}, {})))
            reads = [(0, f1, rc1, c1f, c1r, len(r1))]
            if f2 is not None:
                reads.append((1, f2, rc2, c2f, c2r, len(r2)))
            for ri, fw, rc, cf, cr, ln in reads:
                if not fw or not rc:
                    continue
                for which, m in _adjust_candidates(fw, rc, ln):
                    lane_codes.append(cf if which == 0 else cr)
                    lane_ms.append(m)
                    lane_key.append((ui, ri, which, m))

        for (ui, ri, which, m), r in zip(
                lane_key, self._batched_prefix_search(lane_codes, lane_ms)):
            units[ui]["caches"][ri][(which, m)] = r

        res = []
        for u in units:
            c1f, c1r, c2f, c2r = u["c"]
            f1, rc1, f2, rc2 = u["h"]

            def mk_search(ri, cf, cr, cache=u["caches"]):
                def search(which, m):
                    r = cache[ri].get((which, m))
                    if r is None:   # cascaded re-search (rare): host path
                        r = self.backward_search(cf if which == 0 else cr, m)
                    return r
                return search

            hs = self._adjusted_unit_hits(
                u["r1"], u["r2"], c1f, c1r, c2f, c2r, f1, rc1, f2, rc2,
                search1=mk_search(0, c1f, c1r),
                search2=(mk_search(1, c2f, c2r) if u["r2"] is not None
                         else None))
            qlen = len(u["r1"]) + (len(u["r2"]) if u["r2"] is not None else 0)
            res.append((u["qi"], hs, qlen))
        return res

    def _classify_units_batch(self, unit_hits):
        """Collect every SA row across the units, resolve them in ONE device
        dispatch, then run the exact host score aggregation per unit."""
        mhl = self.param.min_hit_len
        row_parts, spans_all = [], []
        off = 0
        for qi, hs, qlen in unit_hits:
            spans = []
            for h in hs:
                if h.l < mhl:
                    spans.append(None)
                    continue
                rows = self.rows_for_hit(h)
                spans.append((off, off + len(rows)))
                off += len(rows)
                row_parts.append(rows)
            spans_all.append(spans)
        all_rows = np.concatenate(row_parts) if row_parts else np.zeros(0, np.int64)
        resolved_flat = self._resolve_batch_rows(all_rows)
        fb = {}
        empty = np.zeros(0, np.int64)
        for (qi, hs, qlen), spans in zip(unit_hits, spans_all):
            resolved = [resolved_flat[s[0]:s[1]] if s is not None else empty
                        for s in spans]
            res = ClassifierResult()
            self.classify_from_hits(hs, res, resolved=resolved)
            res.query_length = qlen
            fb[qi] = res
        return fb
