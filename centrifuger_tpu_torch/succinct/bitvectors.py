# Port copy of centrifuger_tpu.succinct.bitvectors (host code, no accelerator).
"""Bitvector family breadth: select support, Elias–Fano sparse, RRR-compressed,
and run-length bitvectors.

Library counterparts of the reference's bitvector variants
(compactds/DS_Select.hpp, Bitvector_Sparse.hpp, Bitvector_Compressed.hpp,
Bitvector_RunLength.hpp).  Design is array-first: every query is a fixed
number of vectorized gathers + arithmetic (no per-query Python loops except
fixed-trip bounded scans), so the same code paths lower cleanly to jnp if a
structure is ever promoted to the device hot path.

Conventions (shared with succinct.bitvector.Bitvector):
  access(i)            -> 0/1 at position i
  rank1_inclusive(i)   -> # of 1s in [0..i]
  select1(k), k>=1     -> position of the k-th 1   (select0 likewise)
"""

import numpy as np

from ..utils import div_ceil
from .bitvector import Bitvector
from .bits import FixedArray


def _inword_select(words, k):
    """Position (0..31) of the k-th set bit inside each uint32 word; k >= 1.
    Vectorized broadword replacement for Utils::SelectInWord
    (reference compactds/Utils.hpp:131-151)."""
    words = np.asarray(words, dtype=np.uint32)
    k = np.asarray(k, dtype=np.int64)
    bits = np.unpackbits(words[:, None].view(np.uint8), axis=1,
                         bitorder="little")[:, :32]
    cs = np.cumsum(bits, axis=1)
    return np.argmax(cs >= k[:, None], axis=1).astype(np.int64)


class SelectSupport:
    """Select directory over a plain Bitvector.

    speed='binary' — cumulative per-word popcounts + searchsorted (the
    RANKBINARY point of the reference's 4-mode space/speed dial,
    compactds/DS_Select.hpp:21-25); speed='dense' — every position stored
    (DENSESAMPLE/CONSTANT end of the dial).
    """

    def __init__(self, bv: Bitvector, value=1, speed="binary"):
        self.bv = bv
        self.value = int(value)
        self.speed = speed
        wpop = np.bitwise_count(bv.words).astype(np.int64)
        if value == 0:
            # zeros per word, with tail bits of the last word excluded
            wpop = 32 - wpop
            tail = bv.n & 31
            if tail and len(wpop):
                last = bv.words[-1] & ((np.uint32(1) << np.uint32(tail)) - np.uint32(1))
                wpop[-1] = tail - int(np.bitwise_count(last))
        self.total = int(wpop.sum())
        if speed == "dense":
            bits = np.unpackbits(bv.words[:, None].view(np.uint8), axis=1,
                                 bitorder="little")[:, :32].reshape(-1)[:bv.n]
            self.positions = np.flatnonzero(bits == self.value).astype(np.int64)
            self.cumw = None
        else:
            self.cumw = np.zeros(len(wpop) + 1, dtype=np.int64)
            np.cumsum(wpop, out=self.cumw[1:])
            self.positions = None

    def select(self, k):
        """Position of the k-th `value` bit, k in [1, total]; vectorized."""
        scalar = np.ndim(k) == 0
        k = np.atleast_1d(np.asarray(k, dtype=np.int64))
        if self.positions is not None:
            out = self.positions[np.clip(k - 1, 0, self.total - 1)]
            return out[0] if scalar else out
        wi = np.searchsorted(self.cumw, k, side="left") - 1
        kin = k - self.cumw[wi]
        w = self.bv.words[wi]
        if self.value == 0:
            w = ~w
        out = wi * 32 + _inword_select(w, kin)
        return out[0] if scalar else out

    def nbytes(self):
        if self.positions is not None:
            return self.positions.nbytes
        return self.cumw.nbytes


class SparseBitvector:
    """Elias–Fano encoding of m ones over universe n (reference
    compactds/Bitvector_Sparse.hpp).  ~m(2 + log2(n/m)) bits."""

    def __init__(self, positions, n):
        positions = np.asarray(positions, dtype=np.int64)
        self.n = int(n)
        self.m = len(positions)
        m = max(self.m, 1)
        self.l = max(0, int(np.floor(np.log2(max(self.n, 1) / m))) if self.n > m else 0)
        if self.m:
            lows = positions & ((1 << self.l) - 1) if self.l else np.zeros(self.m, np.int64)
            highs = positions >> self.l
            hb_len = self.m + (self.n >> self.l) + 1
            hb = np.zeros(hb_len, dtype=bool)
            hb[highs + np.arange(self.m)] = True
            self.high = Bitvector.from_bits(hb)
            self.high_sel1 = SelectSupport(self.high, 1)
            self.high_sel0 = SelectSupport(self.high, 0)
            self.lows = FixedArray.from_values(lows, max(self.l, 1))
        else:
            self.high = None

    def select1(self, k):
        """Position of the k-th one (k in [1, m])."""
        scalar = np.ndim(k) == 0
        k = np.atleast_1d(np.asarray(k, dtype=np.int64))
        p = self.high_sel1.select(k)
        h = p - (k - 1)
        lo = self.lows.read(k - 1).astype(np.int64) if self.l else 0
        out = (h << self.l) | lo
        return out[0] if scalar else out

    def rank1_inclusive(self, i):
        """# of ones in [0..i]; vectorized."""
        scalar = np.ndim(i) == 0
        i = np.atleast_1d(np.asarray(i, dtype=np.int64))
        if self.m == 0:
            out = np.zeros(i.shape, dtype=np.int64)
            return out[0] if scalar else out
        h = (np.clip(i, 0, self.n - 1) >> self.l) if self.l else np.clip(i, 0, self.n - 1)
        lo = (i & ((1 << self.l) - 1)) if self.l else np.zeros(i.shape, np.int64)
        # ones with high < h: position of h-th zero minus h (h may be 0)
        nzero = (self.n >> self.l) + 1
        hs = np.clip(h, 0, nzero - 1)
        z = np.where(hs > 0, self.high_sel0.select(np.maximum(hs, 1)) - (hs - 1), 0)
        start = z  # count of ones with high < h
        zn = self.high_sel0.select(np.minimum(hs + 1, nzero)) - hs
        end = zn   # count of ones with high <= h
        # binary search lows[start:end] for lo (side='right')
        loa, hib = start.copy(), end.copy()
        for _ in range(max(1, int(np.ceil(np.log2(self.m + 1))) + 1)):
            mid = (loa + hib) >> 1
            v = self.lows.read(np.clip(mid, 0, self.m - 1)).astype(np.int64) \
                if self.l else np.zeros(mid.shape, np.int64)
            go_right = (mid < hib) & (v <= lo)
            loa = np.where(go_right, mid + 1, loa)
            hib = np.where(go_right, hib, np.minimum(hib, mid))
        out = np.where(i < 0, 0, loa)
        return out[0] if scalar else out

    def access(self, i):
        i = np.asarray(i, dtype=np.int64)
        r = self.rank1_inclusive(i)
        r0 = self.rank1_inclusive(i - 1)
        return (r - r0).astype(np.int64)

    def nbytes(self):
        if self.m == 0:
            return 0
        return (self.high.nbytes() + self.lows.nbytes()
                + self.high_sel1.nbytes() + self.high_sel0.nbytes())


# ---------------------------------------------------------------------- RRR

_RRR_B = 15          # block size (bits per class/offset block)
_RRR_SAMPLE = 16     # blocks per superblock sample


def _binom_table(b):
    t = np.zeros((b + 1, b + 1), dtype=np.int64)
    t[:, 0] = 1
    for i in range(1, b + 1):
        for j in range(1, i + 1):
            t[i, j] = t[i - 1, j - 1] + t[i - 1, j]
    return t


_BINOM = _binom_table(_RRR_B)
_CLASS_BITS = 4      # ceil(log2(B+1)) for B=15
_OFF_WIDTH = np.array([max(1, int(_BINOM[_RRR_B, k] - 1).bit_length())
                       for k in range(_RRR_B + 1)], dtype=np.int64)


def _rrr_decode_partial(classes, offsets, upto):
    """Vectorized enumerative (combinadic) decode: # of ones among the first
    `upto` bits of each block given (class, offset).  upto in [0, B].
    Convention: blocks with bit j = 0 rank first, so at each position
    o < C(B-1-j, k) means 0, else consume C(B-1-j, k) and emit a 1."""
    k = classes.astype(np.int64).copy()
    o = offsets.astype(np.int64).copy()
    cnt = np.zeros(k.shape, dtype=np.int64)
    for j in range(_RRR_B):
        c = _BINOM[_RRR_B - 1 - j][np.clip(k, 0, _RRR_B)]
        one_here = (k > 0) & (o >= c)
        o = np.where(one_here, o - c, o)
        k = np.where(one_here, k - 1, k)
        cnt += (one_here & (j < upto)).astype(np.int64)
    return cnt


class CompressedBitvector:
    """RRR block class/offset compressed bitvector (reference
    compactds/Bitvector_Compressed.hpp).  Block size 15, sampled superblocks."""

    def __init__(self, bits):
        bits = np.asarray(bits).astype(bool)
        self.n = len(bits)
        nblk = div_ceil(max(self.n, 1), _RRR_B)
        padded = np.zeros(nblk * _RRR_B, dtype=bool)
        padded[:self.n] = bits
        mat = padded.reshape(nblk, _RRR_B)
        classes = mat.sum(axis=1).astype(np.int64)
        # vectorized enumerative (combinadic) encode across blocks: a 1 at
        # position j skips the C(B-1-j, k_remaining) blocks that have 0 there
        offsets = np.zeros(nblk, dtype=np.int64)
        kk = classes.copy()
        for j in range(_RRR_B):
            c = _BINOM[_RRR_B - 1 - j][np.clip(kk, 0, _RRR_B)]
            is_one = mat[:, j] & (kk > 0)
            offsets += np.where(is_one, c, 0)
            kk = np.where(is_one, kk - 1, kk)
        self.classes = FixedArray.from_values(classes, _CLASS_BITS)
        widths = _OFF_WIDTH[classes]
        starts = np.zeros(nblk + 1, dtype=np.int64)
        np.cumsum(widths, out=starts[1:])
        from .bits import _pack_at
        self.off_words = _pack_at(offsets.astype(np.uint64), starts[:-1], widths)
        self.nblk = nblk
        # superblock samples: offset-bit start + cumulative rank
        sidx = np.arange(0, nblk + 1, _RRR_SAMPLE)
        # bit offsets exceed int32 beyond ~2.1e9 offset bits (genome scale):
        # widen the sample dtype only when the input actually needs it
        sdt = np.int64 if int(starts[-1]) >= (1 << 31) or self.n >= (1 << 31) \
            else np.int32
        self.samp_start = starts[sidx].astype(sdt)
        cum_rank = np.zeros(nblk + 1, dtype=np.int64)
        np.cumsum(classes, out=cum_rank[1:])
        self.samp_rank = cum_rank[sidx].astype(sdt)
        self.total_ones = int(cum_rank[-1])

    def _block_meta(self, blk):
        """(class, offset, rank_before_block) for each queried block."""
        from .bits import read_bits
        sb = blk // _RRR_SAMPLE
        start = self.samp_start[sb].copy()
        rank = self.samp_rank[sb].copy()
        base = sb * _RRR_SAMPLE
        kcur = np.zeros(blk.shape, dtype=np.int64)
        for j in range(_RRR_SAMPLE):
            bj = np.minimum(base + j, self.nblk - 1)
            cls = self.classes.read(bj).astype(np.int64)
            before = (base + j) < blk
            here = (base + j) == blk
            start += np.where(before, _OFF_WIDTH[cls], 0)
            rank += np.where(before, cls, 0)
            kcur = np.where(here, cls, kcur)
        off = read_bits(self.off_words, start.astype(np.uint64), 14).astype(np.int64)
        off &= (np.int64(1) << _OFF_WIDTH[kcur]) - 1
        return kcur, off, rank

    def rank1_inclusive(self, i):
        scalar = np.ndim(i) == 0
        i = np.atleast_1d(np.asarray(i, dtype=np.int64))
        ic = np.clip(i, 0, self.n - 1)
        blk = ic // _RRR_B
        k, off, before = self._block_meta(blk)
        within = _rrr_decode_partial(k, off, ic % _RRR_B + 1)
        out = np.where(i < 0, 0, before + within)
        out = np.where(i >= self.n, self.total_ones, out)
        return out[0] if scalar else out

    def access(self, i):
        i = np.asarray(i, dtype=np.int64)
        r = self.rank1_inclusive(i)
        r0 = self.rank1_inclusive(i - 1)
        return (r - r0).astype(np.int64)

    def nbytes(self):
        return (self.classes.nbytes() + self.off_words.nbytes
                + self.samp_start.nbytes + self.samp_rank.nbytes)


class RunLengthBitvector:
    """Run-length bitvector: 1-run starts and cumulative lengths in Elias–Fano
    (reference compactds/Bitvector_RunLength.hpp layered on Bitvector_Sparse)."""

    def __init__(self, bits):
        bits = np.asarray(bits).astype(np.int8)
        self.n = len(bits)
        d = np.diff(np.concatenate([[0], bits, [0]]))
        starts = np.flatnonzero(d == 1)
        ends = np.flatnonzero(d == -1)
        lens = ends - starts
        self.nruns = len(starts)
        self.total_ones = int(lens.sum())
        if self.nruns:
            self.run_starts = SparseBitvector(starts, self.n)
            cums = np.cumsum(lens)  # strictly increasing totals
            self.cum = SparseBitvector(cums - 1, self.total_ones)
        else:
            self.run_starts = None

    def rank1_inclusive(self, i):
        scalar = np.ndim(i) == 0
        i = np.atleast_1d(np.asarray(i, dtype=np.int64))
        if self.nruns == 0:
            out = np.zeros(i.shape, np.int64)
            return out[0] if scalar else out
        r = self.run_starts.rank1_inclusive(np.clip(i, 0, self.n - 1))
        r = np.where(i < 0, 0, r)
        # ones in runs 0..r-2 = cum[r-1]; plus clamp within run r-1
        prev = np.where(r > 1, self.cum.select1(np.maximum(r - 1, 1)) + 1, 0)
        tot = np.where(r > 0, self.cum.select1(np.maximum(r, 1)) + 1, 0)
        s = np.where(r > 0, self.run_starts.select1(np.maximum(r, 1)), 0)
        within = np.clip(i - s + 1, 0, tot - prev)
        out = np.where(r > 0, prev + within, 0)
        return out[0] if scalar else out

    def select1(self, k):
        """Position of k-th one, k in [1, total_ones]."""
        scalar = np.ndim(k) == 0
        k = np.atleast_1d(np.asarray(k, dtype=np.int64))
        # run index r: smallest run with cumulative total >= k
        r = self.cum.rank1_inclusive(k - 2)  # # of totals <= k-1 i.e. < k
        prev = np.where(r > 0, self.cum.select1(np.maximum(r, 1)) + 1, 0)
        s = self.run_starts.select1(np.minimum(r + 1, self.nruns))
        out = s + (k - 1 - prev)
        return out[0] if scalar else out

    def access(self, i):
        i = np.asarray(i, dtype=np.int64)
        return (self.rank1_inclusive(i) - self.rank1_inclusive(i - 1)).astype(np.int64)

    def nbytes(self):
        if self.nruns == 0:
            return 0
        return self.run_starts.nbytes() + self.cum.nbytes()
