# Port copy of centrifuger_tpu.succinct.sequences (host code, no accelerator).
"""Sequence representations over small alphabets: plain, wavelet tree,
run-length, and hybrid.

Library counterparts of the reference's sequence family
(compactds/Sequence_Plain.hpp, Sequence_WaveletTree.hpp,
Sequence_RunLength.hpp, Sequence_Hybrid.hpp).  The serving hot path uses the
flattened `packed.PackedSeq` / run-block layouts; these classes provide the
general library surface with the same Access/Rank semantics (rank is
inclusive: count of c in seq[0..i]).
"""

import numpy as np

from .bitvector import Bitvector
from .bitvectors import (SelectSupport, SparseBitvector, CompressedBitvector,
                         RunLengthBitvector)
from .codes import HuffmanCode


class SequencePlain:
    """One plain bitvector per alphabet symbol (reference
    compactds/Sequence_Plain.hpp) — O(1) rank per symbol, sigma*n bits."""

    def __init__(self, codes, sigma):
        codes = np.asarray(codes, dtype=np.int64)
        self.n = len(codes)
        self.sigma = int(sigma)
        self.bvs = [Bitvector.from_bits(codes == c) for c in range(self.sigma)]
        self._codes = None

    def access(self, i):
        i = np.asarray(i, dtype=np.int64)
        out = np.zeros(i.shape, dtype=np.int64)
        for c in range(1, self.sigma):
            out = np.where(self.bvs[c].access(i) == 1, c, out)
        return out

    def rank(self, c, i):
        return self.bvs[int(c)].rank1_inclusive(i)

    def select(self, c, k):
        if not hasattr(self, "_sels"):
            self._sels = {}
        if c not in self._sels:
            self._sels[c] = SelectSupport(self.bvs[int(c)], 1)
        return self._sels[c].select(k)

    def nbytes(self):
        return sum(bv.nbytes() for bv in self.bvs)


def _make_bv(bits, kind):
    if kind == "plain":
        return Bitvector.from_bits(bits)
    if kind == "rrr":
        return CompressedBitvector(bits)
    if kind == "sparse":
        return SparseBitvector(np.flatnonzero(bits), len(bits))
    if kind == "runlength":
        return RunLengthBitvector(bits)
    raise ValueError(kind)


class SequenceWavelet:
    """Balanced or Huffman-shaped binary wavelet tree, generic over the
    bitvector class (reference compactds/Sequence_WaveletTree.hpp:104-301).
    Rank walks code bits root->leaf with one bitvector rank per level."""

    def __init__(self, codes, sigma, bv_kind="plain", huffman=False):
        codes = np.asarray(codes, dtype=np.int64)
        self.n = len(codes)
        self.sigma = int(sigma)
        self.bv_kind = bv_kind
        if huffman:
            freqs = np.bincount(codes, minlength=self.sigma) + 1
            self.huff = HuffmanCode(freqs)
            self.code_of = self.huff.codes
            self.len_of = self.huff.lengths
            self.max_len = self.huff.max_len
        else:
            self.huff = None
            self.max_len = max(1, int(np.ceil(np.log2(max(self.sigma, 2)))))
            self.code_of = np.arange(self.sigma)
            self.len_of = np.full(self.sigma, self.max_len, np.int64)
        # node id: root=1; going bit b from node v -> 2v+b (heap numbering).
        # store per node a bitvector over the subsequence routed through it.
        self.nodes = {}
        seqs = {1: codes}
        for level in range(self.max_len):
            nxt = {}
            for v, sub in seqs.items():
                if len(sub) == 0:
                    continue
                depth = level
                c = self.code_of[sub]
                l = self.len_of[sub]
                live = l > depth
                if not live.any():
                    continue
                bits = ((c >> (l - 1 - depth)) & 1).astype(np.int8)
                bits = np.where(live, bits, 0)
                self.nodes[v] = (_make_bv(bits[live] == 1, bv_kind), live)
                sub_live = sub[live]
                b = bits[live]
                nxt.setdefault(2 * v, []).append(sub_live[b == 0])
                nxt.setdefault(2 * v + 1, []).append(sub_live[b == 1])
            seqs = {v: np.concatenate(parts) for v, parts in nxt.items()}
        # leaves implied by code length

    def _bv_rank1(self, bv, i):
        return bv.rank1_inclusive(i)

    def rank(self, c, i):
        """Count of symbol c in seq[0..i] (vectorized over i)."""
        scalar = np.ndim(i) == 0
        i = np.atleast_1d(np.asarray(i, dtype=np.int64))
        code = int(self.code_of[c])
        clen = int(self.len_of[c])
        v = 1
        pos = i.copy()  # inclusive index within node subsequence, -1 = gone
        for depth in range(clen):
            if v not in self.nodes:
                out = np.zeros(i.shape, dtype=np.int64)
                return out[0] if scalar else out
            bv, live = self.nodes[v]
            bit = (code >> (clen - 1 - depth)) & 1
            r1 = np.where(pos >= 0, self._bv_rank1(bv, np.maximum(pos, 0)), 0)
            cnt = r1 if bit else (pos + 1 - r1)
            pos = cnt - 1
            v = 2 * v + bit
        out = np.maximum(pos + 1, 0)
        return out[0] if scalar else out

    def access(self, i):
        scalar = np.ndim(i) == 0
        i = np.atleast_1d(np.asarray(i, dtype=np.int64))
        out = np.zeros(i.shape, dtype=np.int64)
        # per-element walk (access is not on any hot path in the framework)
        for q in range(len(i)):
            v, pos = 1, int(i[q])
            code = 0
            for depth in range(self.max_len):
                if v not in self.nodes:
                    break
                bv, _ = self.nodes[v]
                b = int(np.atleast_1d(bv.access(np.array([pos])))[0]) \
                    if not isinstance(bv, Bitvector) else int(bv.access(pos))
                r1 = int(np.atleast_1d(bv.rank1_inclusive(np.array([pos])))[0])
                pos = (r1 - 1) if b else (pos - r1)
                code = (code << 1) | b
                v = 2 * v + b
                # stop when code is complete for some symbol
                if self.huff is None:
                    if depth + 1 == self.max_len:
                        break
                else:
                    hits = np.flatnonzero((self.len_of == depth + 1)
                                          & (self.code_of == code))
                    if len(hits):
                        code = -int(hits[0]) - 1
                        break
            if code < 0:
                out[q] = -code - 1
            else:
                out[q] = code
        return out[0] if scalar else out

    def nbytes(self):
        return sum(bv.nbytes() for bv, _ in self.nodes.values())


class SequenceRunLength:
    """Run-length sequence (reference compactds/Sequence_RunLength.hpp):
    run-head symbols in a wavelet tree + per-symbol run-length partial sums."""

    def __init__(self, codes, sigma):
        codes = np.asarray(codes, dtype=np.int64)
        self.n = len(codes)
        self.sigma = int(sigma)
        if self.n == 0:
            self.nruns = 0
            return
        change = np.concatenate([[True], codes[1:] != codes[:-1]])
        starts = np.flatnonzero(change)
        self.heads = SequenceWavelet(codes[starts], sigma)
        lens = np.diff(np.concatenate([starts, [self.n]]))
        self.run_starts = SparseBitvector(starts, self.n)
        self.nruns = len(starts)
        # per symbol: cumulative run lengths (for rank within earlier runs)
        self.cum_by_sym = []
        for c in range(sigma):
            mine = lens[codes[starts] == c]
            cs = np.cumsum(mine) if len(mine) else np.zeros(0, np.int64)
            self.cum_by_sym.append(np.concatenate([[0], cs]).astype(np.int64))

    def access(self, i):
        scalar = np.ndim(i) == 0
        i = np.atleast_1d(np.asarray(i, dtype=np.int64))
        r = self.run_starts.rank1_inclusive(i)  # run index + 1
        out = self.heads.access(r - 1)
        out = np.atleast_1d(out)
        return out[0] if scalar else out

    def rank(self, c, i):
        """Count of c in seq[0..i]."""
        scalar = np.ndim(i) == 0
        i = np.atleast_1d(np.asarray(i, dtype=np.int64))
        r = self.run_starts.rank1_inclusive(i)        # 1-based run index
        ri = r - 1
        # runs of symbol c among runs [0..ri-1]
        pre = self.heads.rank(c, ri - 1)              # count in heads[0..ri-1]
        pre = np.where(ri > 0, pre, 0)
        cur_is_c = np.atleast_1d(self.heads.access(ri)) == c
        # sum of lengths of the first `pre` c-runs (current run excluded)
        cum = self.cum_by_sym[int(c)]
        base = cum[np.clip(pre, 0, len(cum) - 1)]
        s = self.run_starts.select1(np.maximum(r, 1))
        within = np.where(cur_is_c, i - s + 1, 0)
        out = base + within
        return out[0] if scalar else out

    def nbytes(self):
        if self.nruns == 0:
            return 0
        return (self.heads.nbytes() + self.run_starts.nbytes()
                + sum(c.nbytes for c in self.cum_by_sym))


class SequenceHybrid:
    """Per-block representation choice (reference compactds/Sequence_Hybrid.hpp):
    single-run blocks store just the symbol; mixed blocks go to a wavelet tree.
    This is the general-alphabet sibling of the serving run-block layout
    (fm/runblock.py), kept for library parity."""

    def __init__(self, codes, sigma, block=64):
        codes = np.asarray(codes, dtype=np.int64)
        self.n = len(codes)
        self.sigma = int(sigma)
        self.b = int(block)
        nblk = (self.n + self.b - 1) // self.b
        pad = np.zeros(nblk * self.b, dtype=np.int64)
        pad[:self.n] = codes
        if self.n:
            pad[self.n:] = codes[-1] if self.n % self.b else 0
        mat = pad.reshape(nblk, self.b)
        is_run = (mat == mat[:, :1]).all(axis=1)
        self.indicator = Bitvector.from_bits(is_run)
        self.run_syms = SequenceWavelet(mat[is_run, 0], sigma) \
            if is_run.any() else None
        lit = mat[~is_run].reshape(-1)
        self.lit = SequenceWavelet(lit, sigma) if len(lit) else None

    def access(self, i):
        scalar = np.ndim(i) == 0
        i = np.atleast_1d(np.asarray(i, dtype=np.int64))
        bi = i // self.b
        typ = self.indicator.access(bi)
        r1 = self.indicator.rank1_inclusive(bi)
        out = np.zeros(i.shape, np.int64)
        if self.run_syms is not None:
            out_r = np.atleast_1d(self.run_syms.access(np.maximum(r1 - 1, 0)))
            out = np.where(typ == 1, out_r, out)
        if self.lit is not None:
            nlit = bi - r1
            pos = nlit * self.b + i % self.b
            out_l = np.atleast_1d(self.lit.access(
                np.clip(pos, 0, self.lit.n - 1)))
            out = np.where(typ == 0, out_l, out)
        return out[0] if scalar else out

    def rank(self, c, i):
        scalar = np.ndim(i) == 0
        i = np.atleast_1d(np.asarray(i, dtype=np.int64))
        bi = i // self.b
        typ = self.indicator.access(bi)
        r1 = self.indicator.rank1_inclusive(bi)   # run blocks in [0..bi]
        nrun_before = r1 - typ                     # full run blocks before bi
        nlit_before = bi - nrun_before             # full literal blocks before bi
        out = np.zeros(i.shape, np.int64)
        # contribution of full run blocks before (plus current if run)
        if self.run_syms is not None:
            full_run_c = self.run_syms.rank(c, nrun_before - 1)
            full_run_c = np.where(nrun_before > 0, full_run_c, 0)
            cur_run_sym = np.atleast_1d(self.run_syms.access(np.maximum(r1 - 1, 0)))
            cur_run = np.where((typ == 1) & (cur_run_sym == c), i % self.b + 1, 0)
            out += full_run_c * self.b + cur_run
        if self.lit is not None:
            # literal positions: full literal blocks before, plus within
            end = np.where(typ == 0, nlit_before * self.b + i % self.b,
                           nlit_before * self.b - 1)
            r = self.lit.rank(c, np.clip(end, 0, self.lit.n - 1))
            out += np.where(end >= 0, r, 0)
        return out[0] if scalar else out

    def nbytes(self):
        nb = self.indicator.nbytes()
        if self.run_syms is not None:
            nb += self.run_syms.nbytes()
        if self.lit is not None:
            nb += self.lit.nbytes()
        return nb
