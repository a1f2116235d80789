# Port copy of centrifuger_tpu.classify.engine_np (host code, no accelerator).
"""Exact (bit-identical) classification engine, host-side NumPy/Python.

This is the semantic reference for the framework: a faithful re-implementation
of Classifier<FMseqclass> (reference Classifier.hpp) against which the batched
JAX/XLA engine is tested.  Per-read logic:

  Query (Classifier.hpp:909-920)
   └ SearchForwardAndReverse (:496-569)
      ├ GetHitsFromRead fwd + revcomp (:262-281)
      ├ AdjustHitBoundaryFromStrandHits (:291-389)
      └ strand selection by sum (l-15)^2 score, tie keeps both (:554-562)
   └ GetClassificationFromHits (:571-802)
      ├ SA-range resolution, bidirectional striding past k*hitk entries (:606-652)
      ├ per-(strand,seqid) score map with adjacent-unique-hit merge (:654-694)
      ├ best/second-best, best seqid collection (:696-741)
      └ Taxonomy::ReduceTaxIds when > k best seqids (:743-800)
"""

import numpy as np

from ..fm.index import FMIndexData, infer_min_hit_len
from ..taxonomy import Taxonomy, rank_string
from ..utils import make_encode_table, COMP_TABLE
from .params import ClassifierParam
from .translate import translate_frames


class BWTHit:
    __slots__ = ("sp", "ep", "l", "offset", "strand")

    def __init__(self, sp, ep, l, offset, strand):
        self.sp = sp
        self.ep = ep
        self.l = l
        self.offset = offset
        self.strand = strand


class ClassifierResult:
    __slots__ = ("score", "secondary_score", "hit_length", "query_length",
                 "seq_names", "tax_ids", "expanded_strings")

    def __init__(self):
        self.score = 0
        self.secondary_score = 0
        self.hit_length = 0
        self.query_length = 0
        self.seq_names = []
        self.tax_ids = []
        self.expanded_strings = []


class ClassifierNP:
    def __init__(self, fm: FMIndexData, taxonomy: Taxonomy, param: ClassifierParam,
                 protein=False):
        self.fm = fm
        self.tax = taxonomy
        self.param = param
        self.protein = protein
        self.score_adjust = 5 if protein else 15  # _scoreHitLenAdjust (Classifier.hpp:807,892)
        self.encode = make_encode_table(fm.alphabet)
        if self.param.min_hit_len <= 0:
            self.param.min_hit_len = infer_min_hit_len(fm.n, fm.sigma, protein)

    # ---------------------------------------------------------------- FM search

    def backward_search(self, codes, m):
        """Longest-matching-suffix search of codes[:m] (codes: uint8, 255=not in
        alphabet). Returns (l, sp, ep). FMIndex::BackwardSearch (FMIndex.hpp:487-510)."""
        fm = self.fm
        pw = fm.precompute_width
        if m < pw:
            return 0, 1, 0
        # initial range via ftab (FMIndex.hpp:388-422)
        w = 0
        bits = fm.code_bits
        for i in range(pw):
            c = codes[m - 1 - i]
            if c == 255:
                return i, 1, 0
            w = (w << bits) | int(c)
        ln = int(fm.ftab_len[w])
        if ln == 0:
            return pw - 1, 1, 0
        sp = int(fm.ftab_start[w])
        ep = sp + ln - 1
        l = pw
        while l < m:
            c = codes[m - 1 - l]
            if c == 255:
                break
            nsp, nep = fm.backward_extend(int(c), sp, ep)
            nsp = int(np.asarray(nsp).reshape(-1)[0])
            nep = int(np.asarray(nep).reshape(-1)[0])
            if nsp > nep or nep > fm.n:
                break
            sp, ep = nsp, nep
            l += 1
        return l, sp, ep

    def get_hits(self, codes, length, out_hits):
        """Semi-maximal hit chain; appends to out_hits
        (GetHitsFromRead, Classifier.hpp:262-281)."""
        mhl = self.param.min_hit_len
        remaining = length
        while remaining >= mhl:
            l, sp, ep = self.backward_search(codes, remaining)
            if l >= mhl and sp <= ep:
                out_hits.append(BWTHit(sp, ep, l, length - remaining, 0))
            remaining -= l + 1
        return len(out_hits)

    def adjust_hit_boundary(self, r_codes, rc_codes, length, strand_hits,
                            search=None):
        """AdjustHitBoundaryFromStrandHits (Classifier.hpp:291-389).
        strand_hits[0]: hits on revcomp search, strand_hits[1]: forward.
        `search(which, m)` optionally overrides the per-call backward search
        (which: 0 = forward codes, 1 = revcomp codes) so callers can serve the
        searches from a batched device dispatch (engine_fused)."""
        if not strand_hits[0] or not strand_hits[1]:
            return
        if search is None:
            def search(which, m):
                return self.backward_search(r_codes if which == 0 else rc_codes, m)
        hit_size = [len(strand_hits[0]), len(strand_hits[1])]
        j = hit_size[0] - 1
        need_fix = [False, False]
        for i in range(hit_size[1]):
            right = length - strand_hits[1][i].offset - 1
            left = right - strand_hits[1][i].l + 1
            while j >= 0:
                rc_left = strand_hits[0][j].offset
                rc_right = rc_left + strand_hits[0][j].l - 1
                if rc_left >= right:  # no overlap yet
                    j -= 1
                    continue
                if left >= rc_right:  # already passed
                    break
                if left == rc_left and right == rc_right:
                    break
                if left < rc_left and rc_right < right:
                    break
                if rc_left < left and right < rc_right:
                    break
                if rc_right > right:
                    l, sp, ep = search(0, rc_right + 1)
                    if rc_right - l + 1 == left and sp <= ep:
                        strand_hits[1][i] = BWTHit(sp, ep, l, length - rc_right - 1, 1)
                        need_fix[1] = True
                if left < rc_left:
                    l, sp, ep = search(1, length - left)
                    if left + l - 1 == rc_right and sp <= ep:
                        strand_hits[0][j] = BWTHit(sp, ep, l, left, -1)
                        need_fix[0] = True
                j -= 1
        # trim overlaps introduced by the adjustment (Classifier.hpp:349-388)
        for k in range(2):
            if not need_fix[k]:
                continue
            for i in range(hit_size[k] - 1):
                start_i = strand_hits[k][i].offset
                end_i = start_i + strand_hits[k][i].l - 1
                for jj in range(i + 1, hit_size[k]):
                    start_j = strand_hits[k][jj].offset
                    if start_j > end_i:
                        break
                    end_j = start_j + strand_hits[k][jj].l - 1
                    if strand_hits[k][jj].l >= strand_hits[k][i].l:
                        strand_hits[k][i].l = start_j - start_i
                        break
                    else:
                        if end_j <= end_i:
                            strand_hits[k][jj].l = 0
                        else:
                            strand_hits[k][jj].offset = end_i + 1
                            strand_hits[k][jj].l = end_j - (end_i + 1) + 1
                            break

    # ----------------------------------------------------------------- scoring

    def hit_score(self, l):
        if l < self.param.min_hit_len:
            return 0
        return (l - self.score_adjust) * (l - self.score_adjust)

    def hits_score(self, hits):
        return sum(self.hit_score(h.l) for h in hits)

    # ------------------------------------------------------------ strand logic

    def _strand_hits_for_read(self, raw):
        """Hits for one read on both strands, boundary-adjusted.
        Returns [minus_hits, plus_hits]."""
        length = len(raw)
        rc_raw = COMP_TABLE[raw][::-1]
        strand_hits = [[], []]
        if not self.protein:
            codes = self.encode[raw]
            rc_codes = self.encode[rc_raw]
            self.get_hits(codes, length, strand_hits[1])
            self.get_hits(rc_codes, length, strand_hits[0])
            self.adjust_hit_boundary(codes, rc_codes, length, strand_hits)
        else:
            self._translated_search(raw, strand_hits[1])
            self._translated_search(rc_raw, strand_hits[0])
        return strand_hits

    def _translated_search(self, raw, out_hits):
        """3-frame translated search, keep best-scoring frame
        (TranslatedSearch, Classifier.hpp:451-493)."""
        frames = translate_frames(raw)
        frame_hits = []
        for aa in frames:
            hits = []
            codes = self.encode[aa]
            self.get_hits(codes, len(aa), hits)
            frame_hits.append(hits)
        max_score = 0
        max_tag = 0
        for f in range(3):
            # reference quirk: score is summed once per hit *count* of the whole
            # list (Classifier.hpp:477-480 sums CalculateHitsScore len(hits) times)
            score = len(frame_hits[f]) * self.hits_score(frame_hits[f])
            if score > max_score:
                max_score = score
                max_tag = f
        out_hits.extend(frame_hits[max_tag])
        return len(frame_hits[max_tag])

    def search_forward_reverse(self, raw1, raw2):
        """SearchForwardAndReverse (Classifier.hpp:496-569)."""
        strand_hits = self._strand_hits_for_read(raw1)
        if raw2 is not None:
            r2_strand = self._strand_hits_for_read(raw2)
            for i in range(2):
                strand_hits[i].extend(r2_strand[1 - i])
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

    # ----------------------------------------------------------- classification

    def rows_for_hit(self, h):
        """BWT rows to resolve for one hit: the whole range when small, else a
        bidirectional strided subset (Classifier.hpp:606-652): forward pass over
        the range with stride ceil(size/max_entries), then a backward pass from
        ep sharing the same resolved counter, stopping at max_entries total."""
        param = self.param
        max_entries = param.max_result * param.max_result_per_hit_factor
        range_size = h.ep - h.sp + 1
        if range_size <= max_entries or param.max_result_per_hit_factor <= 0 \
                or param.max_result <= 0:
            return np.arange(h.sp, h.ep + 1, dtype=np.int64)
        step = -(-range_size // max_entries)
        rows_fwd = list(range(h.sp, h.ep + 1, step))
        resolved_cnt = len(rows_fwd)
        rows_bwd = []
        jj = h.ep
        while h.sp <= jj <= h.ep:
            rows_bwd.append(jj)
            resolved_cnt += 1
            if resolved_cnt >= max_entries:
                break
            jj -= step
        return np.array(rows_fwd + rows_bwd, dtype=np.int64)

    def classify_from_hits(self, hits, result, resolved=None):
        """GetClassificationFromHits (Classifier.hpp:571-802).
        resolved: optional list of pre-resolved seqid arrays, one per hit
        (aligned with `hits`), from the batched device resolver."""
        param = self.param
        fm = self.fm
        tax = self.tax
        records = [dict(), dict()]  # per strand k: seqId -> [score, hitLength]
        prev_uniq = [0, 0, 0]       # seqId, score, hitLength

        mix_strand = any(hits[i].strand != hits[i - 1].strand
                         for i in range(1, len(hits)))

        for i, h in enumerate(hits):
            if h.l < param.min_hit_len:
                continue
            score = self.hit_score(h.l)
            k = (h.strand + 1) // 2
            local = {}
            if resolved is not None:
                ids = resolved[i]
            else:
                ids = fm.resolve_rows(self.rows_for_hit(h))
            for sid in ids:
                local[int(sid)] = 1

            for sid in sorted(local):
                rec = records[k].get(sid)
                if (not mix_strand and i > 0 and h.ep == h.sp
                        and hits[i - 1].ep == hits[i - 1].sp
                        and hits[i - 1].strand == h.strand
                        and hits[i - 1].offset + hits[i - 1].l + 1 == h.offset
                        and sid == prev_uniq[0]):
                    # merge adjacent unique hits (Classifier.hpp:659-671)
                    rec[0] -= prev_uniq[1]
                    prev_uniq[2] += h.l
                    prev_uniq[1] = self.hit_score(prev_uniq[2])
                    rec[0] += prev_uniq[1]
                    rec[1] += h.l
                else:
                    if rec is None:
                        records[k][sid] = [score, h.l]
                    else:
                        rec[0] += score
                        rec[1] += h.l
                    if h.ep == h.sp:
                        prev_uniq[0] = sid
                        prev_uniq[1] = score
                        prev_uniq[2] = h.l

        best = 0
        second = 0
        best_hit_len = 0
        for k in range(2):
            for sid in sorted(records[k]):
                sc = records[k][sid][0]
                if sc > best:
                    second = best
                    best = sc
                    best_hit_len = records[k][sid][1]
                elif sc > second:
                    second = sc

        result.score = best
        result.secondary_score = second
        result.hit_length = best_hit_len

        best_seq_ids = []
        used = set()
        for k in range(2):
            for sid in sorted(records[k]):
                if records[k][sid][0] == best and sid not in used:
                    best_seq_ids.append(sid)
                    used.add(sid)

        if len(best_seq_ids) > 1:
            result.secondary_score = best

        if len(best_seq_ids) <= param.max_result or param.max_result <= 0:
            for sid in best_seq_ids:
                result.seq_names.append(tax.seq_id_to_name(sid))
                result.tax_ids.append(tax.orig_tax_id(tax.seq_id_to_tax_id(sid)))
                if param.output_expanded_result:
                    result.expanded_strings.append("")
        else:
            ctids = [tax.seq_id_to_tax_id(sid) for sid in best_seq_ids]
            promoted, children = tax.reduce_tax_ids(
                ctids, param.max_result, want_children=param.output_expanded_result)
            for i, t in enumerate(promoted):
                result.seq_names.append(rank_string(tax.tax_rank(t)))
                result.tax_ids.append(tax.orig_tax_id(t))
                if param.output_expanded_result:
                    if children is not None and len(children) == len(promoted):
                        result.expanded_strings.append(
                            ",".join(str(tax.orig_tax_id(c)) for c in children[i]))
                    else:
                        result.expanded_strings.append("")
        return len(result.tax_ids)

    def query(self, raw1, raw2=None):
        """raw1/raw2: uint8 arrays of read bytes. Returns ClassifierResult."""
        result = ClassifierResult()
        hits = self.search_forward_reverse(raw1, raw2)
        self.classify_from_hits(hits, result)
        result.query_length = len(raw1) + (len(raw2) if raw2 is not None else 0)
        return result

    def query_batch(self, queries):
        """queries: list of (raw1, raw2-or-None). Returns list of ClassifierResult."""
        return [self.query(r1, r2) for r1, r2 in queries]
