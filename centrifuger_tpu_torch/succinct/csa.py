# Port copy of centrifuger_tpu.succinct.csa (host code, no accelerator).
"""Ψ-based compressed suffix array.

Completes the reference's sketch (compactds/CompressedSuffixArray.hpp — which
only marks per-symbol Ψ positions in sparse bitvectors and has no query
surface) into a working CSA:

  * Ψ restricted to the F-interval of symbol c is increasing, and its values
    are exactly the positions of c in the BWT — encoded here per symbol with
    the Elias–Fano SparseBitvector (select = one sorted-array gather).
  * SA access:  SA[Ψ(i)] = SA[i] + 1 (mod n), so lookup(i) walks Ψ at most
    `sample_rate` steps to a sampled row (same sampling contract as the
    FM-index's sampled SA, reference compactds/FMIndex.hpp:513-524).
  * ISA access: ISA[p] = Ψ^{p-p0}(ISA[p0]) from text-position samples.
  * count(pattern): classic forward Ψ binary search per symbol interval.

Built host-side from a plain suffix array (offline path, like the builder).
"""

import numpy as np

from .bitvectors import SparseBitvector


class CompressedSuffixArray:
    def __init__(self, text, sa=None, sample_rate=16, sigma=None):
        text = np.asarray(text, dtype=np.int64)
        n = len(text)
        self.n = n
        self.sample_rate = int(sample_rate)
        if sa is None:
            sa = np.array(
                sorted(range(n), key=lambda i: tuple(text[i:])), dtype=np.int64)
        sa = np.asarray(sa, dtype=np.int64)
        isa = np.zeros(n, dtype=np.int64)
        isa[sa] = np.arange(n)
        psi = isa[(sa + 1) % n]
        sigma = int(sigma if sigma is not None else text.max() + 1)
        # F-column partial sums C[c]
        counts = np.bincount(text, minlength=sigma)
        self.C = np.zeros(sigma + 1, dtype=np.int64)
        np.cumsum(counts, out=self.C[1:])
        # the row of the length-1 suffix (SA == n-1) wraps to ISA[0] and is
        # the one out-of-order Ψ entry — stored aside (the reference's
        # firstISA/lastChr correction, CompressedSuffixArray.hpp:21-31)
        self.special_row = int(isa[n - 1])
        self.special_val = int(isa[0])
        self.special_sym = int(text[n - 1])
        # per-symbol Elias–Fano encoding of the increasing Ψ segment
        self.psi_ef = []
        for c in range(sigma):
            seg = psi[self.C[c]:self.C[c + 1]]
            if c == self.special_sym:
                seg = np.delete(seg, self.special_row - int(self.C[c]))
            self.psi_ef.append(SparseBitvector(seg, n) if len(seg) else None)
        # SA samples at text positions ≡ 0 (mod s), marked by row
        s = self.sample_rate
        mark = (sa % s) == 0
        self.sampled_rows = np.flatnonzero(mark).astype(np.int64)
        self.sa_samples = sa[self.sampled_rows]
        # ISA samples every s text positions
        self.isa_samples = isa[::s].copy()

    # -- Ψ ------------------------------------------------------------------
    def sym_of_row(self, i):
        """F-column symbol of row i."""
        return int(np.searchsorted(self.C, i, side="right")) - 1

    def psi(self, i):
        if i == self.special_row:
            return self.special_val
        c = self.sym_of_row(i)
        k = i - int(self.C[c]) + 1
        if c == self.special_sym and i > self.special_row:
            k -= 1
        return int(self.psi_ef[c].select1(k))

    def psi_batch(self, rows):
        rows = np.asarray(rows, dtype=np.int64)
        out = np.empty(len(rows), dtype=np.int64)
        for i, r in enumerate(rows):
            out[i] = self.psi(int(r))
        return out

    # -- SA / ISA access ----------------------------------------------------
    def lookup(self, i):
        """SA[i] via ≤ sample_rate Ψ steps to a sampled row."""
        steps = 0
        while True:
            j = np.searchsorted(self.sampled_rows, i)
            if j < len(self.sampled_rows) and self.sampled_rows[j] == i:
                return int((self.sa_samples[j] - steps) % self.n)
            i = self.psi(i)
            steps += 1

    def inverse(self, p):
        """ISA[p] via Ψ steps from the preceding text-position sample."""
        s = self.sample_rate
        p0 = (p // s) * s
        i = int(self.isa_samples[p // s])
        for _ in range(p - p0):
            i = self.psi(i)
        return i

    # -- pattern counting (forward Ψ binary search) --------------------------
    def count(self, pattern):
        """# of occurrences of pattern (sequence of symbol codes)."""
        pattern = np.asarray(pattern, dtype=np.int64)
        if len(pattern) == 0:
            return self.n
        # the last symbol's rows are its whole F-interval, the length-1 suffix
        # (special_row) included
        c = int(pattern[-1])
        sp, ep = int(self.C[c]), int(self.C[c + 1])     # half-open row range
        for c in pattern[-2::-1]:
            c = int(c)
            ef = self.psi_ef[c]
            # rows i of c's F-interval with Ψ(i) in [sp, ep). The length-1
            # suffix is the interval's first row (shorter suffixes sort first)
            # and has no next symbol: it is skipped, and the EF part holds the
            # Ψ values of the rows after it, in row order.
            lo = int(self.C[c]) + (c == self.special_sym)
            if ef is None:
                return 0

            def below(x):
                return int(ef.rank1_inclusive(x - 1))
            sp, ep = lo + below(sp), lo + below(ep)
            if sp >= ep:
                return 0
        return ep - sp

    def nbytes(self):
        total = self.C.nbytes + self.sampled_rows.nbytes \
            + self.sa_samples.nbytes + self.isa_samples.nbytes
        for ef in self.psi_ef:
            if ef is not None:
                total += ef.nbytes()
        return total
