# Port copy of centrifuger_tpu.classify.finalize (host code, no accelerator).
"""Vectorized host finalizer: batch scoring + best-hit selection with NO
per-read Python loops for the common case.

Replicates GetClassificationFromHits (reference Classifier.hpp:571-802)
semantics over whole batches using sort/segment reductions:
  * per-hit SA-range row expansion + one device LF-walk resolution
  * per-(read, strand, seqid) score aggregation including the
    adjacent-unique-hit merge chains (Classifier.hpp:659-671: a run of
    consecutive single-row hits on the same seqid separated by exactly one
    base re-scores as one long hit)
  * best / second-best / best-hit-length with the reference's exact
    iteration-order tie rules (strand k ascending, seqid ascending)

Reads that trigger the rare paths (hit-boundary adjustment, oversized SA
ranges needing strided resolution is handled here; taxonomy reduction for
multi-best reads calls into Taxonomy per read) fall back to the exact scalar
engine — bit-identical either way.
"""

import numpy as np

from .engine_np import ClassifierResult


def _segment_starts(keys_sorted_cols):
    """Boolean array marking the first row of each group in lexsorted keys."""
    n = len(keys_sorted_cols[0])
    if n == 0:
        return np.zeros(0, dtype=bool)
    start = np.zeros(n, dtype=bool)
    start[0] = True
    for col in keys_sorted_cols:
        start[1:] |= col[1:] != col[:-1]
    return start


def finalize_units(cl, units, resolve_fn):
    """units: list of dicts with keys:
         hits: dict of arrays sp, ep, l, off, strand (int64/int32, len nh)
         query_length: int
       cl: classifier (for params, taxonomy, scoring constants)
       resolve_fn: rows(int64 array) -> seqids (batched device resolver)
    Returns list of ClassifierResult.
    """
    Q = len(units)
    uid = []
    sp = []
    ep = []
    hl = []
    off = []
    strand = []
    for qi, u in enumerate(units):
        h = u["hits"]
        nh = len(h["sp"])
        uid.append(np.full(nh, qi, dtype=np.int64))
        sp.append(h["sp"])
        ep.append(h["ep"])
        hl.append(h["l"])
        off.append(h["off"])
        strand.append(h["strand"])
    flat = dict(
        uid=np.concatenate(uid) if uid else np.zeros(0, np.int64),
        sp=np.concatenate(sp).astype(np.int64) if uid else np.zeros(0, np.int64),
        ep=np.concatenate(ep).astype(np.int64) if uid else np.zeros(0, np.int64),
        l=np.concatenate(hl).astype(np.int64) if uid else np.zeros(0, np.int64),
        off=np.concatenate(off).astype(np.int64) if uid else np.zeros(0, np.int64),
        strand=np.concatenate(strand).astype(np.int64) if uid else np.zeros(0, np.int64),
    )
    qlens = [u["query_length"] for u in units]
    return finalize_flat(cl, Q, flat, qlens, resolve_fn)


def finalize_flat(cl, Q, flat, query_lengths, resolve_fn):
    """Core vectorized finalizer over pre-flattened hit arrays sorted by unit
    (and list order within unit)."""
    rows, cont = finalize_prepare(cl, Q, flat, query_lengths)
    seqids = resolve_fn(rows) if len(rows) else np.zeros(0, np.int64)
    return cont(seqids)


def finalize_prepare(cl, Q, flat, query_lengths):
    """Split finalizer for the pipelined path: does everything up to the
    SA-row expansion, returns (rows, cont) where cont(seqids) finishes the
    per-read records.  `rows` can be resolved by an async device dispatch
    while other batches are in flight (engine_jax.query_pipelined)."""
    param = cl.param
    mhl = param.min_hit_len
    adj = cl.score_adjust
    max_entries = param.max_result * param.max_result_per_hit_factor
    no_cap = param.max_result_per_hit_factor <= 0 or param.max_result <= 0

    uid = flat["uid"]
    sp = flat["sp"]
    ep = flat["ep"]
    hl = flat["l"]
    off = flat["off"]
    strand = flat["strand"]
    NH = len(uid)

    results = [ClassifierResult() for _ in range(Q)]
    for qi in range(Q):
        results[qi].query_length = query_lengths[qi]
    if NH == 0:
        return np.zeros(0, np.int64), lambda seqids: results

    live = hl >= mhl                       # skipped hits contribute nothing
    k = (strand + 1) // 2
    rng_size = ep - sp + 1

    # mixStrand per unit (over the FULL hit list, including skipped hits:
    # reference computes it before the loop, Classifier.hpp:584-591)
    prev_same_unit = np.zeros(NH, dtype=bool)
    prev_same_unit[1:] = uid[1:] == uid[:-1]
    strand_change = np.zeros(NH, dtype=bool)
    strand_change[1:] = strand[1:] != strand[:-1]
    mix = np.zeros(Q, dtype=bool)
    np.logical_or.at(mix, uid[prev_same_unit & strand_change], True)

    # ---- row expansion ----
    simple = live & (no_cap | (rng_size <= max_entries))
    n_rows_simple = np.where(simple, rng_size, 0)
    # strided hits (rare): python expansion
    strided_idx = np.flatnonzero(live & ~simple)
    strided_rows = {}
    for i in strided_idx:
        from .engine_np import BWTHit
        h = BWTHit(int(sp[i]), int(ep[i]), int(hl[i]), int(off[i]), int(strand[i]))
        strided_rows[i] = cl.rows_for_hit(h)
    counts = n_rows_simple.copy()
    for i, r in strided_rows.items():
        counts[i] = len(r)
    total = int(counts.sum())
    starts = np.zeros(NH + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    rows = np.zeros(total, dtype=np.int64)
    # vectorized fill for simple hits: rows = sp[hit] + (pos - start[hit])
    hit_of_row = np.repeat(np.arange(NH), counts)
    pos_in_hit = np.arange(total) - starts[hit_of_row]
    rows = sp[hit_of_row] + pos_in_hit
    for i, r in strided_rows.items():
        rows[starts[i]:starts[i] + len(r)] = r

    def cont(seqids):

        # ---- dedup seqids per hit (localSeqIdHit) ----
        order = np.lexsort((seqids, hit_of_row))
        h_s = hit_of_row[order]
        s_s = seqids[order]
        first = _segment_starts([h_s, s_s])
        pair_hit = h_s[first]                  # hit index per unique (hit, seqid)
        pair_sid = s_s[first]

        # ---- merge-chain detection over the hit list ----
        uniq_hit = live & (rng_size == 1)
        sid_of_uniq = np.zeros(NH, dtype=np.int64)
        one_entry = counts == 1
        sid_of_uniq[one_entry] = seqids[starts[:-1][one_entry]]
        merge_prev = np.zeros(NH, dtype=bool)
        merge_prev[1:] = (prev_same_unit[1:] & (~mix[uid[1:]])
                          & uniq_hit[1:] & uniq_hit[:-1]
                          & (off[:-1] + hl[:-1] + 1 == off[1:])
                          & (sid_of_uniq[1:] == sid_of_uniq[:-1]))
        chain_id = np.cumsum(~merge_prev)      # same id across a merged run

        # ---- contributions ----
        # each unique (hit, seqid) pair contributes to (uid, k, seqid):
        #   hitLength += l[hit]
        #   score: chains aggregate score(sum l) — non-chain pairs are singleton chains
        p_uid = uid[pair_hit]
        p_k = k[pair_hit]
        p_l = hl[pair_hit]
        p_chain = chain_id[pair_hit]

        # chain sums: group pairs by (uid, k, seqid, chain)
        order2 = np.lexsort((p_chain, pair_sid, p_k, p_uid))
        c_uid = p_uid[order2]
        c_k = p_k[order2]
        c_sid = pair_sid[order2]
        c_chain = p_chain[order2]
        c_l = p_l[order2]
        cstart = _segment_starts([c_uid, c_k, c_sid, c_chain])
        seg_idx = np.flatnonzero(cstart)
        chain_lsum = np.add.reduceat(c_l, seg_idx) if len(seg_idx) else np.zeros(0, np.int64)
        chain_score = np.where(chain_lsum >= mhl, (chain_lsum - adj) ** 2, 0)
        g_uid = c_uid[seg_idx]
        g_k = c_k[seg_idx]
        g_sid = c_sid[seg_idx]

        # aggregate per (uid, k, seqid): already sorted by (uid, k, sid, chain) so
        # chains of the same record are adjacent
        rstart = _segment_starts([g_uid, g_k, g_sid])
        r_idx = np.flatnonzero(rstart)
        rec_score = np.add.reduceat(chain_score, r_idx) if len(r_idx) else np.zeros(0, np.int64)
        # hitLength: sum l over pairs grouped the same way
        pair_lsum_sorted = np.add.reduceat(c_l, seg_idx) if len(seg_idx) else np.zeros(0, np.int64)
        rec_hitlen = np.add.reduceat(pair_lsum_sorted, r_idx) if len(r_idx) else np.zeros(0, np.int64)
        rec_uid = g_uid[r_idx]
        rec_k = g_k[r_idx]
        rec_sid = g_sid[r_idx]

        # ---- best / second per unit (iteration order: k asc, seqid asc) ----
        # records are sorted by (uid, k, sid) already; vectorized segment
        # reductions (first-max hitlen, second-largest with multiplicity)
        out_best = np.zeros(Q, dtype=np.int64)
        out_second = np.zeros(Q, dtype=np.int64)
        out_bestlen = np.zeros(Q, dtype=np.int64)
        R = len(rec_uid)
        useg = np.flatnonzero(_segment_starts([rec_uid]))
        if R:
            seg_best = np.maximum.reduceat(rec_score, useg)
            seg_units = rec_uid[useg]
            out_best[seg_units] = seg_best
            is_max = rec_score == out_best[rec_uid]
            ridx = np.arange(R)
            first_max = np.minimum.reduceat(np.where(is_max, ridx, R), useg)
            out_bestlen[seg_units] = rec_hitlen[first_max]
            n_max = np.add.reduceat(is_max.astype(np.int64), useg)
            rest_max = np.maximum.reduceat(np.where(is_max, -1, rec_score), useg)
            out_second[seg_units] = np.maximum(
                np.where(n_max >= 2, seg_best, rest_max), 0)

        # ---- best seqids per unit, in reference iteration order (k asc, sid asc),
        # deduped by seqid keeping the first occurrence (Classifier.hpp:724-738) ----
        is_best = rec_score == out_best[rec_uid]
        results_rows = [[] for _ in range(Q)]
        bo = np.lexsort((rec_sid, rec_k, rec_uid))
        bb_uid = rec_uid[bo]
        bb_sid = rec_sid[bo]
        bb_best = is_best[bo]
        for qi in range(Q):
            results[qi].score = int(out_best[qi])
            results[qi].secondary_score = int(out_second[qi])
            results[qi].hit_length = int(out_bestlen[qi])

        # walk best records grouped by unit (python loop over best rows only —
        # typically ~1 per read)
        best_rows = np.flatnonzero(bb_best)
        tax = cl.tax
        seen = set()
        for ri in best_rows:
            qi = int(bb_uid[ri])
            sid = int(bb_sid[ri])
            key = (qi, sid)
            if key in seen:
                continue
            seen.add(key)
            results_rows[qi].append(sid)

        for qi in range(Q):
            ids = results_rows[qi]
            if not ids:
                continue
            res = results[qi]
            if len(ids) > 1:
                res.secondary_score = res.score
            if len(ids) <= param.max_result or param.max_result <= 0:
                for sid in ids:
                    res.seq_names.append(tax.seq_id_to_name(sid))
                    res.tax_ids.append(tax.orig_tax_id(tax.seq_id_to_tax_id(sid)))
                    if param.output_expanded_result:
                        res.expanded_strings.append("")
            else:
                from ..taxonomy import rank_string
                ctids = [tax.seq_id_to_tax_id(sid) for sid in ids]
                promoted, children = tax.reduce_tax_ids(
                    ctids, param.max_result,
                    want_children=param.output_expanded_result)
                for i, t in enumerate(promoted):
                    res.seq_names.append(rank_string(tax.tax_rank(t)))
                    res.tax_ids.append(tax.orig_tax_id(t))
                    if param.output_expanded_result:
                        if children is not None and len(children) == len(promoted):
                            res.expanded_strings.append(
                                ",".join(str(tax.orig_tax_id(c)) for c in children[i]))
                        else:
                            res.expanded_strings.append("")
        return results

    return rows, cont
