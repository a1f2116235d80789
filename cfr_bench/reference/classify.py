"""The plain reference classifier: Centrifuger's per-read rules over the
reference's own index, and the TSV rows they give.

A frozen copy of the port's host engine (classify/engine_np.py, itself
Classifier.hpp's rules: GetHitsFromRead :262-281,
AdjustHitBoundaryFromStrandHits :291-389, TranslatedSearch :451-493,
SearchForwardAndReverse :496-569, GetClassificationFromHits :571-802),
copied and not imported, with its backward searches run for many reads at
once (RefIndex.search).  numpy only.

score_dtype=np.float16 makes the control: the same rules with every score
and score sum held in 16 bits, the step below the 32-bit integers the
configuration states.
"""

import numpy as np

from .index import encode_table

COMP = np.full(256, ord("N"), np.uint8)
for _a, _b in zip(b"ACGT", b"TGCA"):
    COMP[_a] = _b

_CODE = dict(zip(
    [a + b + c for a in "TCAG" for b in "TCAG" for c in "TCAG"],
    "FFLLSSSSYY__CC_WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"))
# codon -> amino acid by first / second / third base class (A, C, G, other as T);
# a stop translates to A, as Classifier.hpp:462-464 replaces it
_CLS = np.full(256, 3, np.int64)
for _i, _c in enumerate(b"ACG"):
    _CLS[_c] = _i
_AA = np.zeros((4, 4, 4), np.uint8)
for _i, _x in enumerate("ACGT"):
    for _j, _y in enumerate("ACGT"):
        for _k, _z in enumerate("ACGT"):
            _aa = _CODE[_x + _y + _z]
            _AA[_i, _j, _k] = ord("A") if _aa == "_" else ord(_aa)


def translate_frames(raw):
    """The three forward frames of a read as amino-acid letters; a codon
    holding an N becomes A (Classifier::DnaToAa, Classifier.hpp:123-232)."""
    cls = _CLS[raw]
    isn = raw == ord("N")
    out = []
    for f in range(3):
        m = max(0, (len(raw) - f) // 3)
        a, b, c = (cls[f + i:f + i + 3 * m:3] for i in range(3))
        n = isn[f:f + 3 * m:3] | isn[f + 1:f + 1 + 3 * m:3] | isn[f + 2:f + 2 + 3 * m:3]
        out.append(np.where(n, np.uint8(ord("A")), _AA[a, b, c]))
    return out


def _int(score):
    """A score as the TSV prints it; a float16 score past 65,504 (the
    control's long reads) is infinite and prints as -1."""
    return int(score) if np.isfinite(score) else -1


def infer_min_hit_len(n, sigma, protein):
    """Classifier::InferMinHitLen (Classifier.hpp:105-121)."""
    mhl = 11 if protein else 23
    space = sigma ** mhl // 2
    while mhl <= 32 and space < 100 * n:
        space *= sigma
        mhl += 1
    return mhl


class RefClassifier:
    def __init__(self, index, tax, k=1, hitk_factor=40, min_hit_len=0, score_dtype=None):
        self.ix = index
        self.tax = tax
        self.k = k
        self.hitk = hitk_factor
        self.protein = index.protein
        self.adj = 5 if self.protein else 15
        self.mhl = min_hit_len if min_hit_len > 0 else \
            infer_min_hit_len(index.n, index.sigma, self.protein)
        self.dtype = score_dtype
        self.enc = encode_table(index.alphabet)

    def hit_score(self, l):
        s = 0 if l < self.mhl else (l - self.adj) * (l - self.adj)
        return s if self.dtype is None else self.dtype(s)

    def hits_score(self, hits):
        total = 0 if self.dtype is None else self.dtype(0)
        for h in hits:
            total += self.hit_score(h[2])
        return total

    # ------------------------------------------------------------- searches

    def _chains(self, flat, start, length):
        """GetHitsFromRead of every lane: [[sp, ep, l, offset, strand], ...]."""
        hits = [[] for _ in range(len(start))]
        rem = length.copy()
        live = rem >= self.mhl
        while live.any():
            idx = np.flatnonzero(live)
            l, sp, ep = self.ix.search(flat, start[idx], rem[idx])
            for j in np.flatnonzero((l >= self.mhl) & (sp <= ep)):
                i = idx[j]
                hits[i].append([int(sp[j]), int(ep[j]), int(l[j]),
                                int(length[i] - rem[i]), 0])
            rem[idx] -= l + 1
            live[idx] = rem[idx] >= self.mhl
        return hits

    def _adjust(self, length, sh, search):
        """AdjustHitBoundaryFromStrandHits (Classifier.hpp:291-389) of one
        read; sh = [revcomp-lane hits, forward-lane hits]."""
        if not sh[0] or not sh[1]:
            return
        size = [len(sh[0]), len(sh[1])]
        j = size[0] - 1
        fix = [False, False]
        for i in range(size[1]):
            right = length - sh[1][i][3] - 1
            left = right - sh[1][i][2] + 1
            while j >= 0:
                rc_left = sh[0][j][3]
                rc_right = rc_left + sh[0][j][2] - 1
                if rc_left >= right:
                    j -= 1
                    continue
                if left >= rc_right:
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
                        sh[1][i] = [sp, ep, l, length - rc_right - 1, 1]
                        fix[1] = True
                if left < rc_left:
                    l, sp, ep = search(1, length - left)
                    if left + l - 1 == rc_right and sp <= ep:
                        sh[0][j] = [sp, ep, l, left, -1]
                        fix[0] = True
                j -= 1
        for s in range(2):
            if not fix[s]:
                continue
            h = sh[s]
            for i in range(size[s] - 1):
                start_i = h[i][3]
                end_i = start_i + h[i][2] - 1
                for jj in range(i + 1, size[s]):
                    start_j = h[jj][3]
                    if start_j > end_i:
                        break
                    end_j = start_j + h[jj][2] - 1
                    if h[jj][2] >= h[i][2]:
                        h[i][2] = start_j - start_i
                        break
                    if end_j <= end_i:
                        h[jj][2] = 0
                    else:
                        h[jj][3] = end_i + 1
                        h[jj][2] = end_j - (end_i + 1) + 1
                        break

    def _best_frame(self, frames):
        """TranslatedSearch's frame choice (Classifier.hpp:451-493): the
        score of a frame is its hit count times its hits' score."""
        best, tag = 0, 0
        for f, fh in enumerate(frames):
            sc = len(fh) * self.hits_score(fh)
            if sc > best:
                best, tag = sc, f
        return frames[tag]

    def _strand_hits(self, reads):
        """[minus, plus] hits of every mate of every read (each read a list
        of ASCII arrays), all lanes searched together."""
        lanes, first = [], []
        for mates in reads:
            first.append(len(lanes))
            for raw in mates:
                rc = COMP[raw][::-1]
                if self.protein:
                    lanes += [self.enc[aa] for s in (raw, rc) for aa in translate_frames(s)]
                else:
                    lanes += [self.enc[raw], self.enc[rc]]
        lens = np.array([len(x) for x in lanes], np.int64)
        start = np.zeros(len(lanes), np.int64)
        np.cumsum(lens[:-1], out=start[1:])
        flat = np.concatenate(lanes + [np.zeros(1, np.uint8)])
        hits = self._chains(flat, start, lens)
        if self.protein:
            return [[[self._best_frame(hits[f + 6 * m + 3:f + 6 * m + 6]),
                      self._best_frame(hits[f + 6 * m:f + 6 * m + 3])]
                     for m in range(len(mates))] for f, mates in zip(first, reads)]
        out = [[[hits[f + 2 * m + 1], hits[f + 2 * m]] for m in range(len(mates))]
               for f, mates in zip(first, reads)]
        # the boundary adjustment's searches depend on no search's result:
        # ask for them all, search once, then adjust
        asked = []
        for f, mates, sh in zip(first, reads, out):
            for m, raw in enumerate(mates):
                lane = f + 2 * m
                self._adjust(len(raw), [[h[:] for h in x] for x in sh[m]],
                             lambda which, mm, lane=lane:
                             asked.append((lane + which, mm)) or (0, 1, 0))
        if asked:
            q = np.array(asked, np.int64)
            l, sp, ep = self.ix.search(flat, start[q[:, 0]], q[:, 1])
            got = {a: (int(l[i]), int(sp[i]), int(ep[i])) for i, a in enumerate(asked)}
            for f, mates, sh in zip(first, reads, out):
                for m, raw in enumerate(mates):
                    lane = f + 2 * m
                    self._adjust(len(raw), sh[m],
                                 lambda which, mm, lane=lane: got[(lane + which, mm)])
        return out

    def _choose(self, per_mate):
        """SearchForwardAndReverse's strand choice over a read's mates."""
        sh = [list(per_mate[0][0]), list(per_mate[0][1])]
        if len(per_mate) > 1:
            for i in range(2):
                sh[i].extend(per_mate[1][1 - i])
        score = [0, 0]
        for s in range(2):
            for h in sh[s]:
                h[4] = 2 * s - 1
            score[s] = self.hits_score(sh[s])
        if score[1] > score[0]:
            return sh[1]
        if score[0] > score[1]:
            return sh[0]
        return sh[1] + sh[0]

    # ------------------------------------------------------- classification

    def rows_for_hit(self, sp, ep):
        """The bidirectionally strided row subset past k * hitk_factor rows
        (Classifier.hpp:606-652)."""
        most = self.k * self.hitk
        size = ep - sp + 1
        if size <= most or self.hitk <= 0 or self.k <= 0:
            return list(range(sp, ep + 1))
        step = -(-size // most)
        rows = list(range(sp, ep + 1, step))
        cnt = len(rows)
        jj = ep
        while sp <= jj <= ep:
            rows.append(jj)
            cnt += 1
            if cnt >= most:
                break
            jj -= step
        return rows

    def _classify(self, hits, ids):
        """GetClassificationFromHits: (score, second, hit length, names,
        taxids)."""
        tax = self.tax
        rec = [dict(), dict()]
        prev = [0, 0, 0]
        mix = any(hits[i][4] != hits[i - 1][4] for i in range(1, len(hits)))
        for i, h in enumerate(hits):
            sp, ep, l, off, strand = h
            if l < self.mhl:
                continue
            score = self.hit_score(l)
            s = (strand + 1) // 2
            for sid in sorted(set(ids[i])):
                r = rec[s].get(sid)
                p = hits[i - 1]
                if (not mix and i > 0 and ep == sp and p[1] == p[0] and p[4] == strand
                        and p[3] + p[2] + 1 == off and sid == prev[0]):
                    r[0] -= prev[1]
                    prev[2] += l
                    prev[1] = self.hit_score(prev[2])
                    r[0] += prev[1]
                    r[1] += l
                else:
                    if r is None:
                        rec[s][sid] = [score, l]
                    else:
                        r[0] += score
                        r[1] += l
                    if ep == sp:
                        prev[:] = [sid, score, l]
        best = second = 0
        best_len = 0
        for s in range(2):
            for sid in sorted(rec[s]):
                sc = rec[s][sid][0]
                if sc > best:
                    second, best, best_len = best, sc, rec[s][sid][1]
                elif sc > second:
                    second = sc
        best_ids = []
        for s in range(2):
            for sid in sorted(rec[s]):
                if rec[s][sid][0] == best and sid not in best_ids:
                    best_ids.append(sid)
        if len(best_ids) > 1:
            second = best
        if len(best_ids) <= self.k or self.k <= 0:
            names = [tax.seq_names[sid] for sid in best_ids]
            taxids = [tax.orig(tax.seq_tax_id(sid)) for sid in best_ids]
        else:
            from .taxonomy import rank_string
            promoted = tax.reduce([tax.seq_tax_id(sid) for sid in best_ids], self.k)
            names = [rank_string(tax.tax_rank(t)) for t in promoted]
            taxids = [tax.orig(t) for t in promoted]
        return _int(best), _int(second), int(best_len), names, taxids

    def rows(self, reads):
        """{read id: its TSV rows} of reads [(id, mate 1, mate 2 or None)],
        ASCII uint8 arrays."""
        mates = [[np.asarray(r1, np.uint8)] + ([] if r2 is None else [np.asarray(r2, np.uint8)])
                 for _, r1, r2 in reads]
        chosen = [self._choose(sh) for sh in self._strand_hits(mates)]
        # every row of every hit resolved at once
        spans, rows = [], []
        for hits in chosen:
            for h in hits:
                rr = self.rows_for_hit(h[0], h[1]) if h[2] >= self.mhl else []
                spans.append(len(rr))
                rows.extend(rr)
        sids = self.ix.row_seq_id(np.array(rows, np.int64)) if rows else np.zeros(0, np.int64)
        out, at, hi = {}, 0, 0
        for (rid, r1, r2), hits in zip(reads, chosen):
            ids = []
            for _ in hits:
                ids.append(sids[at:at + spans[hi]].tolist())
                at += spans[hi]
                hi += 1
            qlen = len(r1) + (len(r2) if r2 is not None else 0)
            best, second, hl, names, taxids = self._classify(hits, ids)
            if not taxids:
                out[rid] = ["%s\tunclassified\t0\t0\t0\t0\t%d\t1" % (rid, qlen)]
            else:
                out[rid] = ["%s\t%s\t%d\t%d\t%d\t%d\t%d\t%d" % (
                    rid, nm, t, best, second, hl, qlen, len(taxids))
                    for nm, t in zip(names, taxids)]
        return out
