# Port copy of centrifuger_tpu.fm.index (host code, no accelerator).
"""FM-index over the run-block BWT: the central serving data structure.

Value-equivalent re-implementation of FMIndex<SeqClass> (reference
compactds/FMIndex.hpp): sentinel-free BWT with the displaced last character at
row firstISA and a +1 rank correction (FMIndex.hpp:352-362), F-column partial
sums, ftab initial-range table (precomputedRange, FMIndex.hpp:388-422), sampled
SA storing *sequence ids* after Builder::TransformSampledSAToSeqId
(reference Builder.hpp:27-71), selected genome-boundary rows, and protein end
markers.  All arrays are flat NumPy (mirrored to device as jnp); queries are
vectorized over batches.
"""

import json
import numpy as np

from .runblock import RunBlockSeq
from ..succinct.bitvector import Bitvector
from ..succinct.packed import PackedSeq
from ..utils import log2ceil


class FMIndexData:
    def __init__(self):
        self.n = 0
        self.alphabet = "ACGT"
        self.sigma = 4
        self.code_bits = 2           # plainAlphabetBits: ftab index encoding width
        self.bwt = None              # RunBlockSeq
        self.psum = None             # int64[sigma+1] F-column partial sums
        self.first_isa = 0
        self.last_chr = 0            # code of text's last char
        self.precompute_width = 10
        self.ftab_start = None       # int64[sigma_pw]
        self.ftab_len = None         # int64[sigma_pw]
        self.sample_rate = 16
        self.sampled_sa = None       # int64[] sequence ids (post-transform)
        self.adjusted_sa0 = 0        # seqid for SA row firstISA
        self.selected_rows = None    # sorted int64[] BWT rows with boundary info
        self.selected_vals = None    # int64[] seqids for those rows
        self.has_end_marker = False
        self.end_marker_sa = None    # int64[] seqids for rows < endMarkerCnt
        self.rowmap = None           # optional int32[n] serving accelerator:
                                     # precomputed LF-walk result per row

    # ------------------------------------------------------------------ queries

    def rank(self, c, p, inclusive=True):
        """BWT rank with the displaced-last-char correction (FMIndex::Rank,
        reference compactds/FMIndex.hpp:352-362). Vectorized over c/p arrays."""
        c = np.asarray(c)
        p = np.asarray(p)
        if inclusive:
            r = self.bwt.rank_inclusive(c, p)
            corr = (c == self.last_chr) & (p < self.first_isa)
        else:
            r = np.where(p > 0,
                         self.bwt.rank_inclusive(c, np.maximum(p - 1, 0)),
                         0)
            corr = (c == self.last_chr) & (p <= self.first_isa)
        return r + corr.astype(np.int64)

    def backward_extend(self, c, sp, ep):
        """(nextSp, nextEp) for extending range [sp,ep] with symbol c; the sp==ep
        fast path checks the BWT directly (FMIndex::BackwardExtend,
        reference compactds/FMIndex.hpp:364-379). Vectorized; empty result is
        signalled by nextSp > nextEp (we use signed arithmetic where the
        reference relies on size_t wraparound caught by `nextEp > n`)."""
        c = np.asarray(c)
        sp = np.asarray(sp, dtype=np.int64)
        ep = np.asarray(ep, dtype=np.int64)
        off = self.psum[c.astype(np.int64)]
        nsp = off + self.rank(c, sp, inclusive=False)
        r_ep = off + self.rank(c, ep, inclusive=True) - 1
        same = sp == ep
        acc = self.bwt.access(ep)
        nep_same = nsp + np.where(acc == c.astype(np.uint8), 0, -1)
        nep = np.where(same, nep_same, r_ep)
        return nsp, nep

    def lf(self, p):
        """LF-mapping of row p using the stored BWT char (FMIndex::BackwardExtend
        single-arg overload, reference compactds/FMIndex.hpp:382-387)."""
        p = np.asarray(p, dtype=np.int64)
        c = self.bwt.access(p)
        off = self.psum[c.astype(np.int64)]
        return off + self.rank(c, p, inclusive=True) - 1

    def ftab_lookup(self, w):
        """(sp, ep) for packed kmers w; empty ranges come back as (1, 0)."""
        w = np.asarray(w, dtype=np.int64)
        ln = self.ftab_len[w]
        sp = np.where(ln > 0, self.ftab_start[w], 1)
        ep = np.where(ln > 0, self.ftab_start[w] + ln - 1, 0)
        return sp, ep

    def get_sampled_sa(self, rows):
        """(found, seqid) per row: sampled/selected/firstISA/endmarker lookup
        (FMIndex::GetSampledSA, reference compactds/FMIndex.hpp:203-231).
        Note the reference's `else if` chain: selected rows are only consulted
        when a selected-SA table exists, end markers only when it doesn't."""
        rows = np.asarray(rows, dtype=np.int64)
        found = np.zeros(rows.shape, dtype=bool)
        val = np.zeros(rows.shape, dtype=np.int64)

        is_first = rows == self.first_isa
        val = np.where(is_first, self.adjusted_sa0, val)
        found |= is_first

        is_samp = (~found) & (rows % self.sample_rate == 0)
        val = np.where(is_samp, self.sampled_sa[rows // self.sample_rate], val)
        found |= is_samp

        if self.selected_rows is not None and len(self.selected_rows) > 0:
            pos = np.searchsorted(self.selected_rows, rows)
            pos_c = np.minimum(pos, len(self.selected_rows) - 1)
            is_sel = (~found) & (self.selected_rows[pos_c] == rows)
            val = np.where(is_sel, self.selected_vals[pos_c], val)
            found |= is_sel
        elif self.has_end_marker and self.end_marker_sa is not None:
            is_end = (~found) & (rows < len(self.end_marker_sa))
            idx = np.clip(rows, 0, max(len(self.end_marker_sa) - 1, 0))
            val = np.where(is_end, self.end_marker_sa[idx], val)
            found |= is_end
        return found, val

    def resolve_rows(self, rows):
        """Batched LF-walk until each row hits a stored SA sample; returns the
        seqids (FMIndex::BackwardToSampledSA, reference compactds/FMIndex.hpp:513-524)."""
        rows = np.array(rows, dtype=np.int64)
        out = np.zeros(rows.shape, dtype=np.int64)
        pending = np.ones(rows.shape, dtype=bool)
        cur = rows.copy()
        while pending.any():
            found, val = self.get_sampled_sa(cur)
            newly = pending & found
            out[newly] = val[newly]
            pending &= ~found
            if not pending.any():
                break
            idx = np.flatnonzero(pending)
            cur[idx] = self.lf(cur[idx])
        return out

    # ------------------------------------------------------------ save / load

    def save(self, path):
        meta = dict(n=self.n, alphabet=self.alphabet, sigma=self.sigma,
                    code_bits=self.code_bits, first_isa=self.first_isa,
                    last_chr=int(self.last_chr),
                    precompute_width=self.precompute_width,
                    sample_rate=self.sample_rate,
                    adjusted_sa0=int(self.adjusted_sa0),
                    has_end_marker=self.has_end_marker,
                    rb_b=self.bwt.b, rb_block_cnt=self.bwt.block_cnt,
                    rb_lit_n=self.bwt.lit.n, rb_run_n=self.bwt.run.n,
                    rb_ind_n=self.bwt.indicator.n)
        arrays = dict(
            psum=self.psum,
            ftab_start=self.ftab_start, ftab_len=self.ftab_len,
            sampled_sa=self.sampled_sa,
            ind_words=self.bwt.indicator.words, ind_cum=self.bwt.indicator.cum,
            lit_words=self.bwt.lit.words, lit_occ=self.bwt.lit.occ,
            run_words=self.bwt.run.words, run_occ=self.bwt.run.occ,
            meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        )
        if self.selected_rows is not None:
            arrays["selected_rows"] = self.selected_rows
            arrays["selected_vals"] = self.selected_vals
        if self.end_marker_sa is not None:
            arrays["end_marker_sa"] = self.end_marker_sa
        np.savez(path, **arrays)

    @classmethod
    def load(cls, path):
        z = np.load(path if str(path).endswith(".npz") else str(path) + ".npz")
        meta = json.loads(bytes(z["meta"]).decode())
        idx = cls()
        idx.n = meta["n"]
        idx.alphabet = meta["alphabet"]
        idx.sigma = meta["sigma"]
        idx.code_bits = meta["code_bits"]
        idx.first_isa = meta["first_isa"]
        idx.last_chr = meta["last_chr"]
        idx.precompute_width = meta["precompute_width"]
        idx.sample_rate = meta["sample_rate"]
        idx.adjusted_sa0 = meta["adjusted_sa0"]
        idx.has_end_marker = meta["has_end_marker"]
        idx.psum = z["psum"]
        idx.ftab_start = z["ftab_start"]
        idx.ftab_len = z["ftab_len"]
        idx.sampled_sa = z["sampled_sa"]
        lit = PackedSeq(meta["rb_lit_n"], idx.sigma,
                        _width_from_words(meta["rb_lit_n"], idx.sigma), z["lit_words"], z["lit_occ"])
        run = PackedSeq(meta["rb_run_n"], idx.sigma,
                        _width_from_words(meta["rb_run_n"], idx.sigma), z["run_words"], z["run_occ"])
        ind = Bitvector(meta["rb_ind_n"], z["ind_words"], z["ind_cum"])
        idx.bwt = RunBlockSeq(meta["n"], meta["rb_b"], meta["rb_block_cnt"],
                              idx.sigma, ind, lit, run)
        if "selected_rows" in z:
            idx.selected_rows = z["selected_rows"]
            idx.selected_vals = z["selected_vals"]
        if "end_marker_sa" in z:
            idx.end_marker_sa = z["end_marker_sa"]
        return idx


def _width_from_words(n, sigma):
    from ..succinct.packed import width_for_sigma
    return width_for_sigma(sigma)


def infer_min_hit_len(n, sigma, protein):
    """Auto --min-hitlen (Classifier::InferMinHitLen, reference Classifier.hpp:105-121)."""
    mhl = 11 if protein else 23
    kmerspace = sigma ** mhl // 2
    while mhl <= 32:
        if kmerspace >= 100 * n:
            break
        kmerspace *= sigma
        mhl += 1
    return mhl
