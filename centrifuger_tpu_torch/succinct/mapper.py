# Port copy of centrifuger_tpu.succinct.mapper (host code, no accelerator).
"""ID compaction and searchable prefix sums.

Library counterparts of the reference's compactds/CompactMapper.hpp and
compactds/PartialSum.hpp.  PartialSum is the standalone generalization of the
psum machinery the builder uses to map SA positions to genome ids
(reference Builder.hpp:31-43 uses PartialSum::Search)."""

import numpy as np

from .bitvectors import SparseBitvector


class CompactMapper:
    """Sparse id set <-> dense [0, m) mapping (reference
    compactds/CompactMapper.hpp).  to_compact is rank over an Elias–Fano
    membership bitvector; to_orig is select."""

    def __init__(self, ids, universe=None):
        ids = np.unique(np.asarray(ids, dtype=np.int64))
        self.m = len(ids)
        self.universe = int(universe if universe is not None
                            else (ids[-1] + 1 if self.m else 1))
        self.bv = SparseBitvector(ids, self.universe)

    def to_compact(self, orig):
        """Dense index of each original id (member ids only)."""
        return (self.bv.rank1_inclusive(np.asarray(orig, dtype=np.int64)) - 1) \
            .astype(np.int64)

    def to_orig(self, compact):
        """Original id of each dense index (vectorized)."""
        return self.bv.select1(np.asarray(compact, dtype=np.int64) + 1)

    def contains(self, orig):
        return self.bv.access(np.asarray(orig, dtype=np.int64)) == 1

    def nbytes(self):
        return self.bv.nbytes()


class PartialSum:
    """Prefix sums over non-negative segment lengths with O(1) search
    (reference compactds/PartialSum.hpp:1-140): stores the monotone prefix
    sums as an Elias–Fano bitvector; Search(x) = which segment contains
    position x = rank; AccumulatedSum(i) = select."""

    def __init__(self, lengths):
        lengths = np.asarray(lengths, dtype=np.int64)
        assert (lengths >= 0).all()
        self.k = len(lengths)
        cums = np.cumsum(lengths)
        self.total = int(cums[-1]) if self.k else 0
        # strictly increasing positions for EF: use cumulative starts of
        # segments with the duplicate-collapse trick (empty segments share a
        # start; rank still returns the LAST segment starting at/before x,
        # matching the reference's Search semantics for empty segments)
        starts = np.concatenate([[0], cums[:-1]]) if self.k else np.zeros(0, np.int64)
        uniq, self._first_at = np.unique(starts, return_index=True)
        self.bv = SparseBitvector(uniq, max(self.total + 1, 1))
        # count of segments starting at each unique position
        self._seg_count = np.diff(np.concatenate([self._first_at, [self.k]]))

    def search(self, x):
        """Index of the segment containing global position x (vectorized)."""
        x = np.asarray(x, dtype=np.int64)
        r = self.bv.rank1_inclusive(x)          # # unique starts <= x
        ui = np.maximum(r - 1, 0)
        # last segment with this start position (empty segments are skipped)
        return (self._first_at[ui] + self._seg_count[ui] - 1).astype(np.int64)

    def accumulated_sum(self, i):
        """Sum of lengths[0..i-1] = start of segment i (vectorized select)."""
        i = np.asarray(i, dtype=np.int64)
        ui = np.searchsorted(self._first_at, i, side="right") - 1
        return self.bv.select1(ui + 1)

    def nbytes(self):
        return (self.bv.nbytes() + self._first_at.nbytes
                + self._seg_count.nbytes)
