# Port copy of centrifuger_tpu.succinct.bitvector (host code, no accelerator).
"""Plain bitvector with rank support over uint32 words.

Replaces Bitvector_Plain + DS_Rank9 (reference compactds/Bitvector_Plain.hpp:128-137,
compactds/DS_Rank.hpp:255-273) with a flat cumulative-count array per word group —
batched rank1 = one checkpoint gather + popcount of masked words.
"""

import numpy as np

from ..utils import div_ceil

RANK_WORDS = 8  # words per rank checkpoint (256 bits)


class Bitvector:
    __slots__ = ("n", "words", "cum")

    def __init__(self, n, words, cum):
        self.n = int(n)
        self.words = words
        self.cum = cum

    @classmethod
    def from_bits(cls, bits):
        """bits: boolean/0-1 array."""
        bits = np.asarray(bits, dtype=bool)
        n = len(bits)
        nwords = div_ceil(max(n, 1), 32)
        packed = np.zeros(nwords * 4, dtype=np.uint8)   # no bool copy of the bits
        packed[:div_ceil(n, 8)] = np.packbits(bits, bitorder="little")
        words = packed.view(np.uint32)
        ngrp = div_ceil(nwords, RANK_WORDS) + 1
        cum = np.zeros(ngrp, dtype=np.int64)
        wcnt = np.bitwise_count(words).astype(np.int64)
        grp = np.arange(nwords) // RANK_WORDS
        sums = np.bincount(grp, weights=wcnt.astype(np.float64), minlength=ngrp - 1).astype(np.int64)
        cum[1:] = np.cumsum(sums)
        return cls(n, words, cum)

    def access(self, idx):
        idx = np.asarray(idx, dtype=np.int64)
        w = self.words[idx >> 5]
        return ((w >> (idx & 31).astype(np.uint32)) & np.uint32(1)).astype(np.int64)

    def rank1_inclusive(self, idx):
        """number of 1s in bits[0..idx], vectorized. idx >= 0 required."""
        scalar = np.ndim(idx) == 0
        idx = np.atleast_1d(np.asarray(idx, dtype=np.int64))
        pos1 = idx + 1
        wi = pos1 >> 5                       # full words before the partial word
        grp = wi // RANK_WORDS
        base = self.cum[grp]
        cnt = np.zeros(idx.shape, dtype=np.int64)
        wlimit = len(self.words) - 1
        for k in range(RANK_WORDS):
            j = grp * RANK_WORDS + k
            active = j < wi
            w = self.words[np.minimum(j, wlimit)]
            cnt += np.where(active, np.bitwise_count(w).astype(np.int64), 0)
        tail_bits = (pos1 & 31).astype(np.uint32)
        w = self.words[np.minimum(wi, wlimit)]
        tail_mask = np.where(tail_bits > 0, (np.uint32(1) << tail_bits) - np.uint32(1), np.uint32(0))
        cnt += np.bitwise_count(w & tail_mask).astype(np.int64)
        out = base + cnt
        return out[0] if scalar else out

    def rank_inclusive(self, b, idx):
        """rank of bit value b (0 or 1) in bits[0..idx]."""
        r1 = self.rank1_inclusive(idx)
        idx = np.asarray(idx, dtype=np.int64)
        return np.where(np.asarray(b) == 1, r1, idx + 1 - r1)

    def nbytes(self):
        return self.words.nbytes + self.cum.nbytes
