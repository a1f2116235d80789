# Port copy of centrifuger_tpu.succinct.bits (host code, no accelerator).
"""Arbitrary-width bit-packed element arrays over uint64 words.

Library-breadth counterpart of the reference's packed-array family
(compactds/FixedSizeElemArray.hpp, FractionBitElemArray.hpp,
VariableSizeElemArray*.hpp, InterleavedFixedSizeElemArray.hpp).  The serving
hot path uses the TPU-specialized `packed.PackedSeq` (widths dividing 32);
these classes cover the general widths and variable-size encodings with
vectorized NumPy reads — every query is O(1) with two word gathers, never a
Python-level per-element loop.
"""

import numpy as np

from ..utils import div_ceil

_LOW6 = np.uint64(63)


def pack_fixed(values, width):
    """Pack ints little-endian at `width` bits each into uint64 words.
    Elements may straddle word boundaries (same element-order convention as
    reference compactds/Utils.hpp:197-242 BitsWrite)."""
    values = np.asarray(values, dtype=np.uint64)
    n = len(values)
    total_bits = n * width
    nwords = div_ceil(max(total_bits, 1), 64)
    words = np.zeros(nwords + 1, dtype=np.uint64)  # +1 pad for straddle writes
    starts = np.arange(n, dtype=np.uint64) * np.uint64(width)
    wi = (starts >> np.uint64(6)).astype(np.int64)
    off = starts & _LOW6
    mask = np.uint64((1 << width) - 1) if width < 64 else np.uint64(0xFFFFFFFFFFFFFFFF)
    vals = values & mask
    lo = vals << off
    np.bitwise_or.at(words, wi, lo)
    # straddling high parts
    spill = off.astype(np.int64) + width > 64
    if spill.any():
        sh = (np.uint64(64) - off[spill])
        np.bitwise_or.at(words, wi[spill] + 1, vals[spill] >> sh)
    return words


def read_fixed(words, idx, width):
    """Vectorized read of `width`-bit elements at positions idx."""
    idx = np.asarray(idx, dtype=np.int64)
    starts = idx.astype(np.uint64) * np.uint64(width)
    wi = (starts >> np.uint64(6)).astype(np.int64)
    off = starts & _LOW6
    lo = words[wi] >> off
    rem = np.uint64(64) - off
    hi_needed = rem < np.uint64(width)
    wnext = words[np.minimum(wi + 1, len(words) - 1)]
    # shift count of 64 is UB; clamp and select
    hi = np.where(hi_needed, wnext << np.where(rem >= 64, np.uint64(0), rem), np.uint64(0))
    mask = np.uint64((1 << width) - 1) if width < 64 else np.uint64(0xFFFFFFFFFFFFFFFF)
    return (lo | hi) & mask


def read_bits(words, starts, width):
    """Vectorized read of `width` bits at arbitrary bit offsets `starts`."""
    starts = np.asarray(starts, dtype=np.uint64)
    wi = (starts >> np.uint64(6)).astype(np.int64)
    off = starts & _LOW6
    lo = words[wi] >> off
    rem = np.uint64(64) - off
    hi_needed = rem < np.uint64(width)
    wnext = words[np.minimum(wi + 1, len(words) - 1)]
    hi = np.where(hi_needed, wnext << np.where(rem >= 64, np.uint64(0), rem), np.uint64(0))
    mask = np.uint64((1 << width) - 1) if width < 64 else np.uint64(0xFFFFFFFFFFFFFFFF)
    return (lo | hi) & mask


class FixedArray:
    """General-width packed array (reference compactds/FixedSizeElemArray.hpp:102-211
    Read/Write/PackRead).  Any width 1..64; vectorized reads."""

    __slots__ = ("n", "width", "words")

    def __init__(self, n, width, words):
        self.n = int(n)
        self.width = int(width)
        self.words = words

    @classmethod
    def from_values(cls, values, width=None):
        values = np.asarray(values, dtype=np.uint64)
        if width is None:
            m = int(values.max()) if len(values) else 0
            width = max(1, m.bit_length())
        return cls(len(values), width, pack_fixed(values, width))

    def read(self, idx):
        return read_fixed(self.words, idx, self.width)

    def write(self, idx, val):
        """Scalar in-place update (builder-side use only)."""
        start = np.uint64(idx) * np.uint64(self.width)
        wi = int(start >> np.uint64(6))
        off = int(start & _LOW6)
        mask = (1 << self.width) - 1
        v = int(val) & mask
        w = int(self.words[wi])
        w &= ~(mask << off) & 0xFFFFFFFFFFFFFFFF
        w |= (v << off) & 0xFFFFFFFFFFFFFFFF
        self.words[wi] = np.uint64(w)
        if off + self.width > 64:
            hi_bits = off + self.width - 64
            w1 = int(self.words[wi + 1])
            w1 &= ~((1 << hi_bits) - 1)
            w1 |= v >> (self.width - hi_bits)
            self.words[wi + 1] = np.uint64(w1)

    def prefix_match_len(self, i, j, maxlen):
        """Length of the longest common prefix of elements starting at i and j
        (reference FixedSizeElemArray::PrefixMatchLen, word-parallel XOR+ctz
        compactds/FixedSizeElemArray.hpp:216-280).  Vector compare in chunks."""
        a = self.read(np.arange(i, min(i + maxlen, self.n)))
        b = self.read(np.arange(j, min(j + maxlen, self.n)))
        m = min(len(a), len(b))
        neq = a[:m] != b[:m]
        nz = np.flatnonzero(neq)
        return int(nz[0]) if len(nz) else m

    def nbytes(self):
        return self.words.nbytes


class FractionBitArray:
    """Elements at a fractional average bit cost (reference
    compactds/FractionBitElemArray.hpp): store k elements of alphabet size u
    per bucket as a base-u number in ceil(log2 u^k) bits."""

    __slots__ = ("n", "u", "k", "bucket_bits", "arr")

    def __init__(self, values, u, k=None):
        values = np.asarray(values, dtype=np.uint64)
        self.n = len(values)
        self.u = int(u)
        if k is None:
            # pick k maximizing packing efficiency within 64-bit buckets
            best, bestk = 1e18, 1
            for kk in range(1, 64):
                bits = (self.u ** kk - 1).bit_length()
                if bits > 64:
                    break
                waste = bits / kk
                if waste < best:
                    best, bestk = waste, kk
            k = bestk
        self.k = int(k)
        self.bucket_bits = max(1, (self.u ** self.k - 1).bit_length())
        nb = div_ceil(max(self.n, 1), self.k)
        padded = np.zeros(nb * self.k, dtype=np.uint64)
        padded[:self.n] = values
        mat = padded.reshape(nb, self.k)
        mixed = np.zeros(nb, dtype=np.uint64)
        for j in range(self.k - 1, -1, -1):
            mixed = mixed * np.uint64(self.u) + mat[:, j]
        self.arr = FixedArray.from_values(mixed, self.bucket_bits)

    def read(self, idx):
        idx = np.asarray(idx, dtype=np.int64)
        b = self.arr.read(idx // self.k)
        r = (idx % self.k).astype(np.int64)
        out = b
        # divide r times by u: r < k (small constant)
        for j in range(self.k):
            out = np.where(r > j, out // np.uint64(self.u), out)
        return out % np.uint64(self.u)

    def nbytes(self):
        return self.arr.nbytes()


class VariableSizeArray:
    """Variable-size element array, three pointer schemes mirroring the
    reference variants (compactds/VariableSizeElemArray_DirectAccess /
    _DensePointers / _SampledPointers .hpp).

    mode='dense'   — exact bit offsets per element (fast, more space)
    mode='sampled' — offset every `sample` elements + widths re-derived by a
                     bounded scan (less space)
    mode='direct'  — DAC-style: fixed chunks with continuation bits
    """

    def __init__(self, values, mode="dense", sample=32, chunk=4):
        values = np.asarray(values, dtype=np.uint64)
        self.n = len(values)
        self.mode = mode
        if mode == "direct":
            self.chunk = int(chunk)
            levels = []
            cont_bvs = []
            cur = values
            alive = np.ones(self.n, dtype=bool)
            while alive.any():
                lv = (cur & np.uint64((1 << self.chunk) - 1))[alive]
                nxt = cur >> np.uint64(self.chunk)
                more = alive & (nxt > 0)
                levels.append(FixedArray.from_values(lv, self.chunk))
                cont = more[alive]
                cont_bvs.append(_RankBits(cont))
                cur = nxt
                alive = more
            self.levels = levels
            self.conts = cont_bvs
            return
        widths = np.maximum(1, np.array(
            [int(v).bit_length() for v in values], dtype=np.int64))
        starts = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(widths, out=starts[1:])
        self.words = _pack_at(values, starts[:-1], widths)
        if mode == "dense":
            self.starts = starts
            self.widths = widths
        elif mode == "sampled":
            self.sample = int(sample)
            self.samp_starts = starts[::self.sample].copy()
            self.widths = FixedArray.from_values(widths, 7)
        else:
            raise ValueError(mode)

    def read(self, idx):
        idx = np.asarray(idx, dtype=np.int64)
        scalar = idx.ndim == 0
        idx = np.atleast_1d(idx)
        if self.mode == "direct":
            out = np.zeros(idx.shape, dtype=np.uint64)
            pos = idx.copy()
            alive = np.ones(idx.shape, dtype=bool)
            shift = np.uint64(0)
            for lv, cont in zip(self.levels, self.conts):
                safe = np.clip(pos, 0, max(lv.n - 1, 0))
                piece = lv.read(safe)
                out = out | np.where(alive, piece << shift, np.uint64(0))
                nxt_alive = alive & (cont.access(safe) == 1)
                pos = np.where(nxt_alive, cont.rank1_exclusive(safe), pos)
                alive = nxt_alive
                shift = shift + np.uint64(self.chunk)
            return out[0] if scalar else out
        if self.mode == "dense":
            st = self.starts[idx]
            w = self.widths[idx]
        else:
            w = self.widths.read(idx).astype(np.int64)
            base = idx // self.sample * self.sample
            st = self.samp_starts[idx // self.sample].copy()
            for j in range(self.sample - 1):
                add = (base + j < idx)
                st = st + np.where(add, self.widths.read(
                    np.minimum(base + j, self.n - 1)).astype(np.int64), 0)
        # per-element widths vary: read max width then mask
        vals = read_bits(self.words, st.astype(np.uint64), 64)
        mask = np.where(w >= 64, np.uint64(0xFFFFFFFFFFFFFFFF),
                        (np.uint64(1) << w.astype(np.uint64)) - np.uint64(1))
        out = vals & mask
        return out[0] if scalar else out

    def nbytes(self):
        if self.mode == "direct":
            return sum(l.nbytes() for l in self.levels) + \
                sum(c.nbytes() for c in self.conts)
        nb = self.words.nbytes
        if self.mode == "dense":
            nb += self.starts.nbytes + self.widths.nbytes
        else:
            nb += self.samp_starts.nbytes + self.widths.nbytes()
        return nb


class InterleavedFixedArray:
    """Two interleaved streams of fixed-width elements in one word array
    (reference compactds/InterleavedFixedSizeElemArray.hpp) — pairs (a_i, b_i)
    packed adjacently so one row gather serves both."""

    def __init__(self, a, b, wa=None, wb=None):
        a = np.asarray(a, dtype=np.uint64)
        b = np.asarray(b, dtype=np.uint64)
        assert len(a) == len(b)
        self.n = len(a)
        self.wa = wa or max(1, int(a.max()).bit_length() if len(a) else 1)
        self.wb = wb or max(1, int(b.max()).bit_length() if len(b) else 1)
        inter = np.empty(2 * self.n, dtype=np.uint64)
        mixed_width = max(self.wa, self.wb)
        inter[0::2] = a
        inter[1::2] = b
        self.arr = FixedArray.from_values(inter, mixed_width)

    def read_a(self, idx):
        return self.arr.read(np.asarray(idx, dtype=np.int64) * 2)

    def read_b(self, idx):
        return self.arr.read(np.asarray(idx, dtype=np.int64) * 2 + 1)

    def nbytes(self):
        return self.arr.nbytes()


class _RankBits:
    """Tiny internal plain bitvector with exclusive rank (for DAC levels)."""

    def __init__(self, bits):
        from .bitvector import Bitvector
        self.bv = Bitvector.from_bits(np.asarray(bits, dtype=bool))

    def access(self, idx):
        return self.bv.access(idx)

    def rank1_exclusive(self, idx):
        idx = np.asarray(idx, dtype=np.int64)
        r = self.bv.rank1_inclusive(np.maximum(idx, 0))
        bit = self.bv.access(np.maximum(idx, 0))
        return np.where(idx < 0, 0, r - bit)

    def nbytes(self):
        return self.bv.nbytes()


def _pack_at(values, starts, widths):
    """Pack each value at its own bit offset (little-endian)."""
    total = int(starts[-1] + widths[-1]) if len(values) else 1
    nwords = div_ceil(total, 64) + 1
    words = np.zeros(nwords, dtype=np.uint64)
    wi = (starts >> 6).astype(np.int64)
    off = (starts & 63).astype(np.uint64)
    mask = np.where(widths >= 64, np.uint64(0xFFFFFFFFFFFFFFFF),
                    (np.uint64(1) << widths.astype(np.uint64)) - np.uint64(1))
    vals = values & mask
    np.bitwise_or.at(words, wi, vals << off)
    spill = off.astype(np.int64) + widths > 64
    if spill.any():
        sh = np.uint64(64) - off[spill]
        np.bitwise_or.at(words, wi[spill] + 1, vals[spill] >> sh)
    return words
